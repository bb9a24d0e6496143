"""The port's PGSR multi-view losses (`gsjax_torch.train.multiview`) against
gsjax's, at 64x32 on the arc scene of tests/test_loop.py:157-171.

Both packages get the same rendered median depth, normal and luma frames of
the reference view and the same neighbour view, as numpy arrays.

- losses: against gsjax's `patchmatch_losses` on its XLA point path (which
  marches and bisects as the port's twin does), both dense
  (`query_capacity=None`) and compacted (gsjax's default path): within
  rtol 1e-5, both > 0; the port's query count equals gsjax's watermark;
- the gradient to the normal, which reaches the loss only through the NCC:
  within rtol 2e-4 / atol 1e-6 of gsjax's (tests/test_loop.py:188-192);
- the gradients to the median depth and the gaussians, which also pass
  through the point query: against gsjax on its Pallas point kernel
  (interpret), whose VJP is the implicit-function one (autodiff through
  gsjax's XLA bisection is float32 noise, tests/test_pallas.py:79-82),
  within 2% of scale on a seeded directional derivative per argument (the
  scale: the sum of the terms' magnitudes, since the opacities' terms cancel
  to a few percent of it), as tests/test_torch_sample.py holds the query
  itself: gsjax's kernel finds the root by 7-step Newton with a 5-sigma
  cull, the twin bisects (read: at most 0.1% of scale).
- the block-compacted NCC (`ncc_compact`, gsjax's `ncc_block_capacity`;
  the 64x32 frame has 8 blocks, so a capacity of 16 truncates nothing):
  losses within rtol 1e-5 of gsjax's and of the port's dense form, the
  block count equal to gsjax's, and the gradient to the normal within
  gsjax's block form's as the dense one within gsjax's dense form.
Every tile list of the neighbour view is at most 128 pairs, one chunk in
both of gsjax's paths, so gsjax's chunked stop equals the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster.camera import Camera as JCamera
from gsjax.train.multiview import patchmatch_losses as jpatch
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster import render as trender
from gsjax_torch.ops.raster.camera import Camera as TCamera
from gsjax_torch.train.multiview import patchmatch_losses as tpatch
from tests.scene_gen import arc_pose, make_gaussians

torch.set_num_threads(1)
W, H = 64, 32
REF, NEAR = 1, 2


def _cams(cls, **kw):
    fx = 0.9 * W
    fovx, fovy = 2 * np.arctan(W / (2 * fx)), 2 * np.arctan(H / (2 * fx))
    return [cls.create(arc_pose(i, 4)[0].T, arc_pose(i, 4)[1], fovx, fovy, W, H, **kw)
            for i in range(4)]


def _inputs():
    """Gaussians (raw quaternions, activated scales / opacities) and the
    reference view's rendered median depth, normal and the luma frames."""
    means, scales, quats, opac, shs = make_gaussians(90, seed=0)
    g = (means, scales, quats, opac[:, 0])
    cams = _cams(TCamera, device="cpu")
    cfg = TConfig(max_per_tile=256, chunk=128, sh_degree=0, require_depth=True)
    outs = [trender(*map(torch.as_tensor, g), torch.as_tensor(shs[:, :1]), c, cfg,
                    torch.zeros(3)) for c in cams]
    gray = [o["render"].clamp(0, 1).mean(-1).numpy() for o in outs]
    ref = outs[REF]
    return g, ref["median_depth"].numpy(), ref["normal"].numpy(), gray[REF], gray[NEAR]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _jcfg(backend):
    return JConfig(pair_capacity=1 << 14, max_per_tile=256, chunk=128, sh_degree=0,
                   require_depth=True, backend=backend)


def _gsjax(inputs, backend, cap, grad=True, bcap=None):
    """gsjax's (ncc, geo, n_queries, n_blocks) and, with `grad`, its
    gradients to (median depth, normal, means, scales, rotations, opacities)
    of ncc + 0.1 geo; `bcap` is its ncc_block_capacity."""
    g, md, nrm, gr, gn = inputs
    cams = _cams(JCamera)
    alive = jnp.ones((g[0].shape[0],), bool)

    def loss(md_, nrm_, ms, sc, qt, op):
        ncc, geo, _wr, nq, nb = jpatch(md_, nrm_, ms, sc, qt, op, alive, cams[REF],
                                       cams[NEAR], jnp.asarray(gr), jnp.asarray(gn),
                                       _jcfg(backend), query_capacity=cap,
                                       ncc_block_capacity=bcap)
        return ncc + 0.1 * geo, (ncc, geo, nq, nb)

    args = tuple(map(jnp.asarray, (md, nrm, *g)))
    if not grad:
        _, (ncc, geo, nq, nb) = loss(*args)
        return float(ncc), float(geo), int(nq), None, int(nb)
    (_, (ncc, geo, nq, nb)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True)(*args)
    return float(ncc), float(geo), int(nq), [np.asarray(x) for x in grads], int(nb)


def _port(inputs, ncc_compact=False):
    """The port's (ncc, geo, n_queries, the neighbour's largest tile list),
    its gradients, as `_gsjax`, and its NCC block count."""
    g, md, nrm, gr, gn = inputs
    cams = _cams(TCamera, device="cpu")
    args = [torch.tensor(a, requires_grad=True) for a in (md, nrm, *g)]
    ncc, geo, nq, mtc, nb = tpatch(*args[:2], *args[2:], torch.ones(g[0].shape[0], dtype=bool),
                                   cams[REF], cams[NEAR], torch.as_tensor(gr),
                                   torch.as_tensor(gn),
                                   TConfig(max_per_tile=256, chunk=128, require_depth=True),
                                   ncc_compact=ncc_compact)
    grads = torch.autograd.grad(ncc + 0.1 * geo, args)
    return (float(ncc.detach()), float(geo.detach()), nq, mtc, [x.numpy() for x in grads],
            nb)


@pytest.fixture(scope="module")
def port(inputs):
    return _port(inputs)


@pytest.fixture(scope="module")
def gsjax_runs(inputs):
    """`_gsjax` on these inputs, each run once."""
    runs = {}

    def run(backend, cap, grad=True, bcap=None):
        key = (backend, cap, grad, bcap)
        if key not in runs:
            runs[key] = _gsjax(inputs, backend, cap, grad, bcap)
        return runs[key]
    return run


@pytest.mark.parametrize("cap", [None, 2048], ids=["dense", "compacted"])
def test_losses_match_gsjax(gsjax_runs, port, cap):
    ncc, geo, nq, _, _ = gsjax_runs("ref", cap, grad=cap is not None)
    t_ncc, t_geo, t_nq, mtc, _, t_nb = port
    assert t_nb == 0, "the dense NCC selects no blocks"
    assert mtc <= 128, "one chunk per tile list"
    assert t_ncc > 0 and t_geo > 0
    np.testing.assert_allclose(t_ncc, ncc, rtol=1e-5)
    np.testing.assert_allclose(t_geo, geo, rtol=1e-5)
    if cap is not None:
        assert t_nq == nq > 0


def test_normal_grad_matches_gsjax(gsjax_runs, port):
    want = gsjax_runs("ref", 2048)[3][1]
    got = port[4][1]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("arg", [0, 2, 3, 4, 5],
                         ids=["median_depth", "means", "scales", "rotations", "opacities"])
def test_grads_through_the_query_match_gsjax_pallas(port, gsjax_runs, arg):
    want, got = gsjax_runs("pallas", 2048)[3][arg], port[4][arg]
    assert np.isfinite(got).all()
    v = np.random.default_rng(arg).normal(0, 1, want.shape)
    terms = want.astype(np.float64) * v
    dj, dt = float(terms.sum()), float(np.sum(got.astype(np.float64) * v))
    scale = float(np.abs(terms).sum())
    assert scale > 0
    assert abs(dt - dj) <= 0.02 * scale, (dt, dj, scale)


def test_compacted_ncc_matches_gsjax_and_the_dense_form(inputs, gsjax_runs, port):
    ncc, geo, nq, jg, nb = gsjax_runs("ref", 2048, bcap=16)
    d_ncc, d_geo, _, _, dg, _ = port
    t_ncc, t_geo, t_nq, _, tg, t_nb = _port(inputs, ncc_compact=True)
    assert 0 < t_nb == nb <= 8 and t_nq == nq
    np.testing.assert_allclose(t_ncc, ncc, rtol=1e-5)
    np.testing.assert_allclose(t_geo, geo, rtol=1e-5)
    np.testing.assert_allclose([t_ncc, t_geo], [d_ncc, d_geo], rtol=1e-5)
    np.testing.assert_allclose(tg[1], jg[1], rtol=2e-4, atol=1e-6)
    for a, b in zip(tg, dg):
        scale = max(np.abs(b).max(), 1e-20)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)
