"""gsjax_torch `render` (plain-PyTorch twin) against gsjax `render` (XLA ref).

Tolerances are the bounds gsjax holds its Pallas blend to against the XLA
path (tests/test_pallas.py:38-44): colour and alpha atol 3e-5, normal 2e-4,
median depth within atol 2e-3 / rtol 1e-3 on >= 99.5% of pixels, n_contrib
equal on >= 99.9% — the twin sums its log-transmittance in another order.

gsjax runs with `chunk >= max_per_tile`, one chunk per tile list: its
chunked march carries only the kept transmittance across chunks, so a pixel
that stopped resumes at the next chunk, where the port (like the CUDA
reference loop) stops for good. Within one chunk the two agree;
`test_gsjax_chunked_resume_gap` pins the gap at gsjax's default chunk.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster import mark_visible as jmark_visible
from gsjax.ops.raster import render as jrender
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster import mark_visible as tmark_visible
from gsjax_torch.ops.raster import render as trender
from gsjax_torch.ops.raster import render_cuda, render_ref
from gsjax_torch.ops.raster.camera import Camera as TCamera
from tests.util import look_at_camera, random_gaussians

torch.set_num_threads(1)
W, H = 96, 64
CASES = {
    "black": dict(bg=(0.0, 0.0, 0.0)),
    "white": dict(bg=(1.0, 1.0, 1.0)),
    "kernel_size": dict(bg=(0.2, 0.1, 0.4), kernel_size=0.3),
    "sg": dict(bg=(0.0, 0.0, 0.0), sg_degree=2),
    "no_depth": dict(bg=(0.0, 0.0, 0.0), require_depth=False),
}


def _inputs(n=150, seed=3):
    g = random_gaussians(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    axis = rng.normal(0, 1, (n, 2, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=2, keepdims=True)
    sg = (axis, rng.uniform(0.5, 3.0, (n, 2)).astype(np.float32),
          rng.normal(0, 0.3, (n, 2, 3)).astype(np.float32))
    return g, sg


def _tcam():
    return TCamera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                          0.9, 0.7, W, H, device="cpu")


@pytest.fixture(scope="module", params=list(CASES))
def rendered(request):
    case = dict(CASES[request.param])
    bg = np.asarray(case.pop("bg"), np.float32)
    kw = dict(tile=32, max_per_tile=256, sh_degree=2, **case)
    g, sg = _inputs()
    sg_kw = dict(zip(("sg_axis", "sg_sharpness", "sg_color"), sg)) \
        if kw.get("sg_degree") else {}
    jcfg = JConfig(chunk=256, tile_batch=2, pair_capacity=1 << 13, backend="ref", **kw)
    oj = jrender(*map(jnp.asarray, g), look_at_camera(W, H), jcfg, jnp.asarray(bg),
                 **{k: jnp.asarray(v) for k, v in sg_kw.items()})
    ot = trender(*map(torch.as_tensor, g), _tcam(), TConfig(backend="torch", **kw),
                 torch.as_tensor(bg), **{k: torch.as_tensor(v) for k, v in sg_kw.items()})
    return request.param, oj, ot


def test_render_matches_gsjax(rendered):
    name, oj, ot = rendered
    get = lambda k: (np.asarray(oj[k]), ot[k].numpy())
    np.testing.assert_allclose(*get("render")[::-1], atol=3e-5, err_msg=name)
    np.testing.assert_allclose(*get("alpha")[::-1], atol=3e-5, err_msg=name)
    np.testing.assert_allclose(*get("normal")[::-1], atol=2e-4, err_msg=name)
    want, got = get("median_depth")
    close = np.isclose(got, want, atol=2e-3, rtol=1e-3)
    assert close.mean() >= 0.995, f"{name}: median depth off on {(~close).mean():.3%}"
    if name != "no_depth":
        assert (want > 0).mean() > 0.05, "median depth must be exercised"
    want, got = get("n_contrib")
    assert (got == want).mean() >= 0.999
    np.testing.assert_array_equal(*get("radii")[::-1])
    np.testing.assert_array_equal(*get("visibility")[::-1])
    for k in ("num_pairs", "num_live_pairs", "max_tile_count"):
        assert ot[k] == int(oj[k]), k


def test_twin_stop_is_final_across_chunks():
    """A denser scene saturates pixels; the twin's result must not depend on
    its chunk size, since a stopped pixel stays stopped."""
    means, scales, q, op, shs = _inputs(n=300, seed=8)[0]
    args = [torch.as_tensor(a) for a in (means, scales, q, np.full_like(op, 0.97), shs)]
    cam = _tcam()
    outs = [trender(*args, cam, TConfig(backend="torch", chunk=c, sh_degree=2,
                                        max_per_tile=256), torch.zeros(3))
            for c in (8, 256)]
    # T < 1e-2 is where a pixel's march can stop (alpha <= 0.99)
    assert (outs[1]["alpha"] > 0.99).float().mean() > 0.05, "scene must saturate pixels"
    for k in ("render", "alpha", "normal"):
        np.testing.assert_allclose(outs[0][k].numpy(), outs[1][k].numpy(), atol=1e-6)
    np.testing.assert_array_equal(outs[0]["n_contrib"].numpy(), outs[1]["n_contrib"].numpy())


def test_gsjax_chunked_resume_gap():
    """gsjax at its default chunk (64) against the twin on a saturating scene.
    gsjax resumes a stopped pixel at the next chunk, the port stops for
    good: the two differ on such pixels, and only by what gsjax absorbs of
    the transmittance the port keeps at its stop (below 1e-2)."""
    means, scales, q, op, shs = _inputs(n=600, seed=8)[0]
    g = (means, scales, q, np.full_like(op, 0.97), shs)
    oj = jrender(*map(jnp.asarray, g), look_at_camera(W, H),
                 JConfig(tile_batch=2, pair_capacity=1 << 14, backend="ref", sh_degree=2,
                         max_per_tile=256), jnp.zeros(3))
    ot = trender(*map(torch.as_tensor, g), _tcam(),
                 TConfig(backend="torch", sh_degree=2, max_per_tile=256), torch.zeros(3))
    assert JConfig().chunk < int(oj["max_tile_count"]), "lists must span several chunks"
    nj, nt = np.asarray(oj["n_contrib"]), ot["n_contrib"].numpy()
    aj, at = np.asarray(oj["alpha"]), ot["alpha"].numpy()
    resumed = nt != nj
    # measured at this seed: 12.6% of pixels; gsjax's lists run on, never shorter
    assert 0.05 < resumed.mean() < 0.25, f"resumed on {resumed.mean():.3%}"
    assert (nt <= nj).all()
    assert (aj >= at - 1e-6).all() and (aj - at <= (1.0 - at) + 1e-6).all()
    assert (1.0 - at[resumed]).max() < 1e-2
    np.testing.assert_allclose(ot["render"].numpy()[~resumed], np.asarray(oj["render"])[~resumed],
                               atol=3e-5)
    close = np.isclose(ot["median_depth"].numpy(), np.asarray(oj["median_depth"]),
                       atol=2e-3, rtol=1e-3)
    assert close.mean() >= 0.995


def test_wrapper_runs_twin_for_cpu_tensors():
    g, _ = _inputs()
    cfg = TConfig(sh_degree=2, max_per_tile=256)
    cam = _tcam()
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.ops.raster.preprocess import preprocess

    prep = preprocess(*map(torch.as_tensor, g), None, None, None, cam, cfg)
    b = bin_gaussians(prep, cfg, W, H)
    feats = render_ref.prepare_pairs(prep, b)
    args = (feats, b.tile_start, b.tile_count, W, H, cam.fx, cam.fy, torch.zeros(3), cfg)
    before = render_cuda.blend_fwd.launches
    got = render_cuda.blend_fwd(*args)
    assert render_cuda.blend_fwd.launches == before, "no kernel launch on the CPU"
    assert torch.equal(got, render_ref.blend_planes(*args))
    auto = trender(*map(torch.as_tensor, g), cam, dataclasses.replace(cfg, backend="auto"),
                   torch.zeros(3))
    np.testing.assert_array_equal(auto["render"].numpy(),
                                  got[0:3].permute(1, 2, 0).numpy())


@pytest.mark.parametrize("backend,exc", [("cuda", ValueError), ("pallas", ValueError)])
def test_backend_errors(backend, exc):
    g, _ = _inputs(n=20)
    with pytest.raises(exc):
        trender(*map(torch.as_tensor, g), _tcam(), TConfig(backend=backend, sh_degree=2),
                torch.zeros(3))


def test_mark_visible():
    g, _ = _inputs()
    want = np.asarray(jmark_visible(jnp.asarray(g[0]), look_at_camera(W, H, angle=1.3)))
    cam = TCamera.create(np.asarray(look_at_camera(W, H, angle=1.3).view_rotation).T,
                         np.zeros(3, np.float32), 0.9, 0.7, W, H, device="cpu")
    got = tmark_visible(torch.as_tensor(g[0]), cam).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
