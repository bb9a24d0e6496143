"""The port's blend backward (the twin of kernel B2) and `render()`'s gradients.

(a) `render_ref.blend_bwd_planes` against torch autograd through the twin's
    forward: the same function computed two ways, within 1e-5 of each
    payload column's largest gradient.
(b) `render()`'s gradients for its five inputs against gsjax
    `render(backend="pallas")` (its B2 in interpret mode), one `jax.vjp` and
    one cotangent per output. Colour, alpha and normal within
    `tests/test_pallas.py:69-77`'s 2e-4 of scale. The median depth's
    directional derivative along a seeded direction within 2%: gsjax finds
    the root by 7-step Newton and drops the median terms of gaussians 5 sigma
    from it, the twin bisects (8-way x 5) and keeps every term.
(c) The median-depth gradient against the float64 finite-difference oracle
    within 8%, as `tests/test_pallas.py:86-123` holds gsjax's.
(d) The kernel wrappers on CPU tensors run the twin; backend "cuda" raises.

Every tile list is at most 128 pairs, one Pallas chunk and one twin chunk,
so gsjax's chunked stop equals the port's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster import render as jrender
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster import render as trender
from gsjax_torch.ops.raster import render_cuda, render_ref
from gsjax_torch.ops.raster.binning import bin_gaussians
from gsjax_torch.ops.raster.camera import Camera as TCamera
from gsjax_torch.ops.raster.preprocess import preprocess
from tests import oracle
from tests.util import look_at_camera, random_gaussians

torch.set_num_threads(1)
W, H = 64, 32
BG = (0.2, 0.1, 0.4)
PARTS = {"c": "render", "a": "alpha", "n": "normal", "m": "median_depth"}


def _scene(n=60, seed=5):
    return random_gaussians(n, seed=seed)


def _tcam():
    return TCamera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                          0.9, 0.7, W, H, device="cpu")


def _tcfg(require_depth):
    return TConfig(tile=32, chunk=128, max_per_tile=256, sh_degree=2,
                   require_depth=require_depth, backend="torch")


def _cotangents(seed=0):
    rng = np.random.default_rng(seed)
    return {"c": rng.normal(0, 1, (H, W, 3)).astype(np.float32),
            "a": rng.normal(0, 1, (H, W)).astype(np.float32),
            "n": rng.normal(0, 1, (H, W, 3)).astype(np.float32),
            "m": rng.normal(0, 1, (H, W)).astype(np.float32)}


def _port_grads(g, cfg, parts, bg=BG):
    """{part: [5 grads]} of sum(out[part] * cotangent) through the port."""
    args = [torch.tensor(a, requires_grad=True) for a in g]
    out = trender(*args, _tcam(), cfg, torch.tensor(bg))
    cts = _cotangents()
    return out, {p: [x.numpy() for x in torch.autograd.grad(
        (out[PARTS[p]] * torch.as_tensor(cts[p])).sum(), args, retain_graph=True)]
        for p in parts}


@pytest.mark.parametrize("part", ["c", "a", "n"])
def test_twin_backward_equals_autograd_through_twin(part):
    g = _scene(80)
    cfg = _tcfg(True)
    cam = _tcam()
    prep = preprocess(*map(torch.as_tensor, g), None, None, None, cam, cfg)
    b = bin_gaussians(prep, cfg, W, H)
    feats = render_ref.prepare_pairs(prep, b).detach().requires_grad_(True)
    bg = torch.tensor(BG)
    planes = render_ref.blend_planes(feats, b.tile_start, b.tile_count, W, H,
                                     cam.fx, cam.fy, bg, cfg)
    rows = {"c": slice(0, 3), "n": slice(3, 6), "a": slice(6, 7)}[part]
    gp = torch.zeros_like(planes)
    gp[rows] = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, gp[rows].shape).astype(np.float32))
    want, = torch.autograd.grad(planes, feats, gp)
    got = render_ref.blend_bwd_planes(feats.detach(), b.tile_start, b.tile_count,
                                      planes.detach(), gp, W, H, cam.fx, cam.fy, bg, cfg)
    scale = want.abs().amax(0).clamp_min(1e-12)
    assert int(b.tile_count.max()) <= 128
    np.testing.assert_allclose((got / scale).numpy(), (want / scale).numpy(), atol=1e-5)
    assert (want.abs().amax(0) > 0).sum() >= (9 if part == "c" else 6)


@pytest.fixture(scope="module", params=[True, False], ids=["depth", "no_depth"])
def grads(request):
    """gsjax (Pallas, interpret) and port gradients for every part."""
    require_depth = request.param
    g = _scene()
    parts = "canm" if require_depth else "can"
    cam = look_at_camera(W, H)
    jcfg = JConfig(tile=32, chunk=128, tile_batch=2, pair_capacity=1 << 12,
                   max_per_tile=256, sh_degree=2, require_depth=require_depth,
                   backend="pallas")
    jargs = tuple(map(jnp.asarray, g))
    out_j, vjp = jax.vjp(lambda *a: {k: jrender(*a, cam, jcfg, jnp.asarray(BG))[k]
                                     for k in PARTS.values()}, *jargs)
    cts = _cotangents()
    zero = {k: jnp.zeros_like(v) for k, v in out_j.items()}
    want = {p: [np.asarray(x) for x in vjp(dict(zero, **{PARTS[p]: jnp.asarray(cts[p])}))]
            for p in parts}
    out_t, got = _port_grads(g, _tcfg(require_depth), parts)
    assert out_t["max_tile_count"] <= 128, "one chunk per tile list"
    return require_depth, want, got


@pytest.mark.parametrize("part", ["c", "a", "n"])
def test_render_grads_match_gsjax_pallas(grads, part):
    _, want, got = grads
    for i, (w, t) in enumerate(zip(want[part], got[part])):
        scale = np.abs(w).max() + 1e-8
        np.testing.assert_allclose(t / scale, w / scale, atol=2e-4,
                                   err_msg=f"part {part} arg {i}")
        assert np.isfinite(t).all()


def test_median_grad_direction_matches_gsjax_pallas(grads):
    require_depth, want, got = grads
    if not require_depth:
        assert "m" not in got
        return
    rng = np.random.default_rng(7)
    vs = [rng.normal(0, 1, w.shape) for w in want["m"]]
    dj = sum(float(np.sum(w.astype(np.float64) * v)) for w, v in zip(want["m"], vs))
    dt = sum(float(np.sum(t.astype(np.float64) * v)) for t, v in zip(got["m"], vs))
    assert abs(dt - dj) <= 0.02 * abs(dj), (dt, dj)
    assert abs(dj) > 0


def test_median_grad_matches_oracle():
    """The implicit-function median VJP against float64 central differences
    of the true root of T(t) = 0.5 (oracle bisection with 20 iterations)."""
    g = _scene()
    cam = look_at_camera(W, H)
    rng = np.random.default_rng(0)

    def oracle_md(*a):
        prep = oracle.preprocess_np(*a, cam, 2)
        return oracle.render_np(prep, cam, np.zeros(3), require_depth=True,
                                split_iters=20)["median_depth"]

    vs = [rng.normal(0, 1, np.asarray(a).shape) for a in g]
    eps = 1e-5
    b64 = [np.asarray(a, np.float64) for a in g]
    mp = oracle_md(*[a + eps * v for a, v in zip(b64, vs)])
    mm = oracle_md(*[a - eps * v for a, v in zip(b64, vs)])
    dm = (mp - mm) / (2 * eps)
    stable = np.abs(mp - mm) < 1e-3     # mask discrete per-pixel events
    assert stable.mean() > 0.98
    wm = (rng.normal(0, 1, (H, W)) * stable).astype(np.float32)
    fd = float(np.sum(dm * wm))

    args = [torch.tensor(a, requires_grad=True) for a in g]
    out = trender(*args, _tcam(), _tcfg(True), torch.zeros(3))
    gr = torch.autograd.grad((out["median_depth"] * torch.as_tensor(wm)).sum(), args)
    an = sum(float(np.sum(x.numpy().astype(np.float64) * v)) for x, v in zip(gr, vs))
    assert abs(an - fd) / (abs(fd) + 1e-9) < 0.08, (an, fd)


def test_wrappers_run_twins_for_cpu_tensors():
    g = _scene()
    cfg = dataclasses.replace(_tcfg(True), backend="auto")
    args = [torch.tensor(a, requires_grad=True) for a in g]
    before = (render_cuda.blend_fwd.launches, render_cuda.blend_bwd.launches)
    out = trender(*args, _tcam(), cfg, torch.tensor(BG))
    auto = torch.autograd.grad(out["render"].sum() + out["median_depth"].sum(), args)
    assert (render_cuda.blend_fwd.launches, render_cuda.blend_bwd.launches) == before
    out = trender(*args, _tcam(), _tcfg(True), torch.tensor(BG))
    twin = torch.autograd.grad(out["render"].sum() + out["median_depth"].sum(), args)
    for a, t in zip(auto, twin):
        assert torch.equal(a, t)


def test_cuda_backend_raises_on_cpu_tensors():
    args = [torch.tensor(a, requires_grad=True) for a in _scene(20)]
    with pytest.raises(ValueError):
        trender(*args, _tcam(), dataclasses.replace(_tcfg(True), backend="cuda"),
                torch.zeros(3))
