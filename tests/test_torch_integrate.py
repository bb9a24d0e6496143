"""The port's point integrate (`gsjax_torch.ops.sample.integrate`, the twin of
kernel B4) against gsjax's.

Scene: 150 gaussians at 96x64 and 180 query points (gsjax's own
`tests/test_sample_ncc.py:_pallas_ref_pair`, seed 11), plus points outside
the frustum; every tile list is at most 128 pairs, one chunk of gsjax's XLA
path (chunk 256) and of its Pallas kernel (128), so gsjax's chunked stop
equals the port's stop for good.

- against gsjax's XLA `integrate`, which marches and sums the same
  half-gaussian-CDF log factors over the same applied pairs: `inside` equal,
  alpha within 2e-5 absolute (float32 sums of the same terms in another
  order; read 1.2e-7);
- against gsjax's Pallas `integrate` in interpret mode within 5e-4, gsjax's
  own bound between its two paths (test_sample_ncc.py:157-162): its kernel
  carries T multiplicatively and the port's twin in log space (read
  1.2e-7 here too);
- points outside the frustum give alpha exactly 0;
- T is non-increasing along a pixel ray (test_sample_ncc.py:71-88);
- `sample_cuda.integrate_fwd` runs the twin for CPU tensors, and a view's
  pairs prepared once (`prepare_view`, as meshing does) give the same
  values as a query that prepares them itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.sample import integrate as jintegrate
from gsjax_torch.ops import sample_cuda, sample_ref
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster.camera import Camera as TCamera
from gsjax_torch.ops.sample import (integrate, integrate_view, prepare_points,
                                    prepare_view)
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


def _scene(seed=11):
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
def port():
    g = _scene()
    view = prepare_view(*map(torch.as_tensor, g[1:]), _tcam(), _tcfg())
    assert view.binning.max_tile_count <= 128, "one chunk per tile list"
    got = integrate(*map(torch.as_tensor, g), _tcam(), _tcfg())
    return g, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("backend,atol", [("ref", 2e-5), ("pallas", 5e-4)])
def test_matches_gsjax(port, backend, atol):
    g, got = port
    want = jintegrate(*map(jnp.asarray, g), look_at_camera(W, H), _jcfg(backend))
    inside = np.asarray(want["inside"])
    np.testing.assert_array_equal(got["inside"], inside)
    assert inside.sum() > 30
    assert got["alpha"][inside].max() > 0.5, "some points lie behind opaque gaussians"
    np.testing.assert_allclose(got["alpha"], np.asarray(want["alpha"]), atol=atol, rtol=0)
    np.testing.assert_allclose(got["transmittance"], 1 - got["alpha"], atol=1e-7)


def test_outside_points_have_zero_alpha(port):
    _, got = port
    assert not got["inside"][-N_OUT:].any()
    assert (got["alpha"][-N_OUT:] == 0).all()
    assert (got["transmittance"][-N_OUT:] == 1).all()


def test_transmittance_monotone_along_ray():
    means, scales, q, op, _ = random_gaussians(120, seed=3)
    zs = np.linspace(0.5, 8.0, 12).astype(np.float32)
    pts = np.stack([np.zeros_like(zs), np.zeros_like(zs), zs], -1)
    res = integrate(*(torch.as_tensor(a) for a in (pts, means, scales, q, op)),
                    _tcam(), _tcfg())
    t = res["transmittance"].numpy()
    assert res["inside"].all()
    assert np.all(t >= 0) and np.all(t <= 1)
    assert np.all(np.diff(t) <= 0)
    assert t[0] > 0.97            # nothing in front of 0.5
    assert t[-1] < 0.5            # behind the blob


def test_wrapper_runs_twin_and_view_cache_is_exact():
    g = [torch.as_tensor(a) for a in _scene(seed=5)]
    cam, cfg = _tcam(), _tcfg()
    view = prepare_view(*g[1:], cam, cfg)
    qr = prepare_points(view, g[0], cam, cfg)
    args = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts,
            qr.t_ray[qr.sorted_q].contiguous(), qr.blocks, cfg)
    before = sample_cuda.integrate_fwd.launches
    rows = sample_cuda.integrate_fwd(*args)
    assert rows.shape == (sample_ref.N_ROWS_INTEGRATE, qr.pts.shape[0])
    assert torch.equal(rows, sample_ref.integrate_rows(*args))
    assert sample_cuda.integrate_fwd.launches == before
    assert (rows[1] == 1).all()
    # rows 2-4 are the depth mode's march
    depth_rows = sample_ref.sample_fwd_rows(*args[:4], qr.blocks, cfg)
    assert torch.equal(rows[2:5], depth_rows[2:5])
    a = integrate_view(view, g[0], cam, cfg)
    b = integrate(*g, cam, cfg)
    for k in ("alpha", "transmittance", "inside"):
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError):
        integrate(*g, cam, _tcfg(backend="cuda"))
