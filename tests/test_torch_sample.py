"""The port's point queries (`gsjax_torch.ops.sample`, the twins of kernels
B3 / B5) against gsjax's.

Scene: 150 gaussians at 96x64 and 180 query points (gsjax's own
`tests/test_sample_ncc.py:_pallas_ref_pair`), plus points outside the
frustum; every tile list is at most 128 pairs, one chunk of gsjax's XLA
path (chunk 256) and of its Pallas kernel (128), so gsjax's chunked stop
equals the port's.

- forward: against gsjax's XLA `sample_depth`, which marches and bisects as
  the twin does: `inside` equal, depth within atol 2e-5 / rtol 1e-5 (what
  gsjax holds its own two paths to, test_sample_ncc.py:154);
- gradients to points, means, scales, rotations and opacities: against
  gsjax's Pallas B5 in interpret mode (autodiff through gsjax's XLA
  bisection is float32 noise, tests/test_pallas.py:79-82), within 2% on a
  seeded directional derivative per argument: gsjax's kernel finds the root
  by 7-step Newton and drops the terms of gaussians 5 sigma from it, the
  twin bisects and keeps every term (B2's test holds the blend to the same);
- the twin's VJP against a float64 central difference of the twin's
  forward (bisection refined to 10 rounds), within 8%;
- gradients finite, and exactly zero for points outside the frustum;
- `evaluate_sdf`: the sign and surface contract of test_sample_ncc.py:189-221.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.sample import sample_depth as jsample
from gsjax_torch.ops import sample_cuda, sample_ref
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster import render as trender
from gsjax_torch.ops.raster.camera import Camera as TCamera
from gsjax_torch.ops.sample import evaluate_sdf, prepare_query, sample_depth
from tests.util import look_at_camera, random_gaussians

torch.set_num_threads(1)
W, H = 96, 64
N_OUT = 4      # trailing points outside the frustum


def _tcam():
    return TCamera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                          0.9, 0.7, W, H, device="cpu")


def _tcfg(**kw):
    return TConfig(tile=32, chunk=256, max_per_tile=256, require_depth=True, **kw)


def _jcfg(backend):
    return JConfig(tile=32, chunk=256, tile_batch=2, pair_capacity=1 << 13,
                   max_per_tile=256, require_depth=True, backend=backend)


def _scene(seed=7):
    """Gaussians and query points as test_sample_ncc.py:_pallas_ref_pair, plus
    N_OUT points outside the frustum (behind, left, below, too near)."""
    means, scales, q, op, _ = random_gaussians(150, seed=seed)
    rng = np.random.default_rng(seed)
    qn = 180
    depth = rng.uniform(2.0, 6.0, qn).astype(np.float32)
    xs = rng.uniform(-0.45, 0.45, qn)
    ys = rng.uniform(-0.35, 0.35, qn)
    pts = np.stack([xs * depth, ys * depth, depth], -1)
    out = np.array([[0.1, 0.1, -3.0], [-9.0, 0.0, 3.0], [0.0, 9.0, 3.0], [0.0, 0.0, 0.1]])
    return tuple(np.asarray(a, np.float32)
                 for a in (np.concatenate([pts, out]), means, scales, q, op))


@pytest.fixture(scope="module")
def forward():
    g = _scene()
    want = jsample(*map(jnp.asarray, g), look_at_camera(W, H), _jcfg("ref"))
    got = sample_depth(*map(torch.as_tensor, g), _tcam(), _tcfg())
    return want, got


def test_forward_matches_gsjax_xla(forward):
    want, got = forward
    assert got["max_tile_count"] <= 128, "one chunk per tile list"
    inside = np.asarray(want["inside"])
    np.testing.assert_array_equal(got["inside"].numpy(), inside)
    assert inside.sum() > 30 and not inside[-N_OUT:].any()
    for key in ("sampled_depth", "point_cam"):
        np.testing.assert_allclose(got[key].numpy()[inside], np.asarray(want[key])[inside],
                                   atol=2e-5, rtol=1e-5, err_msg=key)


def _weights(n):
    return np.random.default_rng(0).normal(0, 1, n).astype(np.float32)


@pytest.fixture(scope="module")
def grads():
    """d(sum w * sampled depth)/d(points, means, scales, rotations, opacities)
    from gsjax's Pallas kernel (interpret) and from the port."""
    g = _scene(seed=13)
    w = _weights(g[0].shape[0])
    cam = look_at_camera(W, H)

    def jloss(*a):
        r = jsample(*a, cam, _jcfg("pallas"))
        return jnp.sum(jnp.where(r["inside"], r["sampled_depth"] * w, 0.0))

    want = [np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, g))]
    args = [torch.tensor(a, requires_grad=True) for a in g]
    r = sample_depth(*args, _tcam(), _tcfg())
    assert r["max_tile_count"] <= 128
    loss = torch.where(r["inside"], r["sampled_depth"] * torch.as_tensor(w), 0.0).sum()
    got = [x.numpy() for x in torch.autograd.grad(loss, args)]
    return want, got


@pytest.mark.parametrize("arg", range(5), ids=["points", "means", "scales",
                                                "rotations", "opacities"])
def test_grads_match_gsjax_pallas(grads, arg):
    want, got = grads
    v = np.random.default_rng(arg).normal(0, 1, want[arg].shape)
    dj = float(np.sum(want[arg].astype(np.float64) * v))
    dt = float(np.sum(got[arg].astype(np.float64) * v))
    assert abs(dj) > 0
    assert abs(dt - dj) <= 0.02 * abs(dj), (dt, dj)


def test_grads_finite_and_zero_outside(grads):
    _, got = grads
    assert all(np.isfinite(x).all() for x in got)
    assert np.abs(got[0][:-N_OUT]).max() > 0
    assert (got[0][-N_OUT:] == 0).all(), "points outside the frustum get no gradient"


def _twin_inputs(dtype):
    """The twins' inputs for the sample scene: payload, lists, sorted points
    and block table."""
    qr = prepare_query(*map(torch.as_tensor, _scene(seed=13)), _tcam(), _tcfg())
    b = qr.binning
    return qr.feats.to(dtype), b.tile_start, b.tile_count, qr.pts.to(dtype), qr.blocks


def test_twin_vjp_matches_float64_central_difference():
    feats, ts, tc, xy, blocks = _twin_inputs(torch.float64)
    cfg = dataclasses.replace(_tcfg(), split_iterations=10)
    rng = np.random.default_rng(3)
    vf = torch.as_tensor(rng.normal(0, 1, feats.shape)) * feats.abs().amax(0) * 1e-3
    vp = torch.as_tensor(rng.normal(0, 1, xy.shape)) * 1e-3
    eps = 1e-3
    rp = sample_ref.sample_fwd_rows(feats + eps * vf, ts, tc, xy + eps * vp, blocks, cfg)
    rm = sample_ref.sample_fwd_rows(feats - eps * vf, ts, tc, xy - eps * vp, blocks, cfg)
    res = sample_ref.sample_fwd_rows(feats, ts, tc, xy, blocks, cfg)
    # points whose discrete state (in range, contributor count) is unchanged
    stable = (rp[1] == rm[1]) & (rp[2] == rm[2]) & (res[1] > 0)
    assert stable.sum() > 30
    g = torch.as_tensor(rng.normal(0, 1, xy.shape[0])) * stable
    fd = float(((rp[0] - rm[0]) / (2 * eps) * g).sum())
    d_feats, d_pts = sample_ref.sample_bwd_rows(feats, ts, tc, xy, blocks, res, g, cfg)
    an = float((d_feats * vf).sum() + (d_pts * vp).sum())
    assert abs(an - fd) <= 0.08 * abs(fd), (an, fd)
    assert (d_feats[:, [6, 7, 8, 13, 14, 15]] == 0).all(), "colour and normal get none"


def test_wrappers_run_twins_for_cpu_tensors():
    feats, ts, tc, xy, blocks = _twin_inputs(torch.float32)
    cfg = _tcfg()
    before = (sample_cuda.sample_fwd.launches, sample_cuda.sample_bwd.launches)
    res = sample_cuda.sample_fwd(feats, ts, tc, xy, blocks, cfg)
    assert torch.equal(res, sample_ref.sample_fwd_rows(feats, ts, tc, xy, blocks, cfg))
    g = torch.ones(xy.shape[0])
    for a, b in zip(sample_cuda.sample_bwd(feats, ts, tc, xy, blocks, res, g, cfg),
                    sample_ref.sample_bwd_rows(feats, ts, tc, xy, blocks, res, g, cfg)):
        assert torch.equal(a, b)
    assert (sample_cuda.sample_fwd.launches, sample_cuda.sample_bwd.launches) == before
    assert int(blocks[:, 2].sum()) == xy.shape[0]
    with pytest.raises(ValueError):
        sample_depth(*map(torch.as_tensor, _scene()), _tcam(), _tcfg(backend="cuda"))


def test_evaluate_sdf_sign_and_surface():
    """sdf = median ray depth - point ray depth: ~0 on the rendered median
    surface, positive in front of it, negative behind."""
    means, scales, q, op, shs = random_gaussians(120, seed=3)
    args = [torch.as_tensor(a) for a in (means, scales, q, op)]
    cfg = TConfig(tile=32, chunk=32, max_per_tile=256, sh_degree=1, require_depth=True)
    cam = _tcam()
    depth = trender(*args, torch.as_tensor(shs[:, :4]), cam, cfg,
                    torch.zeros(3))["median_depth"].numpy()
    xs = (np.arange(W) - (W - 1) / 2) / cam.fx
    ys = (np.arange(H) - (H - 1) / 2) / cam.fy
    pts = np.stack([depth * xs[None, :], depth * ys[:, None], depth], -1)
    pts = pts.reshape(-1, 3)[depth.reshape(-1) > 0.5][::11].astype(np.float32)

    on = evaluate_sdf(torch.as_tensor(pts), *args, cam, cfg)
    inside = on["inside"].numpy()
    assert inside.mean() > 0.8
    ray_t = np.linalg.norm(pts, axis=1)          # identity camera: t = |p|
    rel = np.abs(on["sdf"].numpy()[inside]) / ray_t[inside]
    assert np.median(rel) < 2e-3, np.median(rel)
    for scale, sign in ((0.8, 1), (1.2, -1)):
        r = evaluate_sdf(torch.as_tensor(pts * scale), *args, cam, cfg)
        fin = r["inside"].numpy()
        assert (np.sign(r["sdf"].numpy()[fin]) == sign).mean() > 0.95
