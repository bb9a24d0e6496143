"""The port's block-compacted NCC (`warp_sample_blocks`, `warp_patch_ncc_blocks`)
against gsjax's, on the CPU (gsjax's `_bilinear` sampler, GSJAX_NCC_BACKEND
at its default), and against the port's own dense NCC.

Two scenes, each a reference and a neighbour view with a depth, a normal, two
luma frames and a seeded mask with weights in (0.2, 1) (the PGSR d_mask and
its exp(-error) weights):
  - "arc": 120 gaussians (tests/test_loop.py's make_gaussians(120)) rendered
    by the port at 64x32 from arc poses 1 and 2; the mask is half of the
    pixels with a depth;
  - "plane": a tilted plane with high-contrast texture at 72x40, so the
    frame's right and bottom blocks are partial (8 of 16 pixels); the mask
    is 40% of all pixels.

Limits: sampler values and d/du, d/dv within 1e-6 absolute (the same
float32 formula); ncc_sum within rtol 1e-5, ncc_cnt and the block count
equal; gradients of ncc_sum to depth and normal within 1e-4 of each one's
largest entry against the port's dense form (read: equal on both scenes)
and against gsjax's block form on the textured plane (read: 6.7e-6 and
8.6e-6). XLA contracts the homography into fma chains and torch does not,
so tap positions differ from gsjax's by an ulp, and on the smooth arc
images the NCC's cancelling float32 sums amplify that: there gsjax's own
block and dense forms disagree by 1.5e-4 / 2.4e-4 of scale (depth /
normal), the port's dense form and gsjax's by 2.6e-4 / 2.5e-4, and the
gradients are held to gsjax's at 5e-4 of scale, the limit gsjax holds its
two forms to on the arc scene (tests/test_loop.py:test_ncc_block_compaction
_parity; read: 1.8e-4 / 1.9e-4; ncc_sum within 1.6e-6). An empty mask gives zeros and zero
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.ncc import _bilinear
from gsjax.ops.ncc import warp_patch_ncc_blocks as jblocks
from gsjax_torch.ops import ncc as tncc
from gsjax_torch.ops import warp_sample as ws
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster import render as trender
from gsjax_torch.ops.raster.camera import Camera as TCamera
from gsjax_torch.train.multiview import _invert_rigid
from tests.scene_gen import arc_pose, make_gaussians
from tests.test_torch_ncc import _plane_scene

torch.set_num_threads(1)


def _arc_scene(w=64, h=32):
    """Depth, normal (unit or zero), luma frames, relative pose and
    intrinsics of arc views 1 -> 2 of 120 rendered gaussians."""
    means, scales, quats, opac, shs = make_gaussians(120, seed=0)
    fx = 0.9 * w
    fovx, fovy = 2 * np.arctan(w / (2 * fx)), 2 * np.arctan(h / (2 * fx))
    cams = [TCamera.create(arc_pose(i, 4)[0].T, arc_pose(i, 4)[1], fovx, fovy, w, h,
                           device="cpu") for i in (1, 2)]
    cfg = TConfig(max_per_tile=512, chunk=128, sh_degree=0, require_depth=True)
    args = [torch.as_tensor(a) for a in (means, scales, quats, opac[:, 0], shs[:, :1])]
    outs = [trender(*args, c, cfg, torch.zeros(3)) for c in cams]
    gray = [o["render"].clamp(0, 1).mean(-1).numpy() for o in outs]
    nrm = outs[0]["normal"]
    n2 = (nrm * nrm).sum(-1, keepdim=True)
    nrm = torch.where(n2 > 1e-20, nrm * torch.rsqrt(torch.where(n2 > 1e-20, n2, 1.0)), 0.0)
    rel = cams[1].world_view @ _invert_rigid(cams[0].world_view)
    intr = lambda c: (c.fx, c.fy, c.cx, c.cy)
    return (outs[0]["median_depth"].numpy(), nrm.numpy(), gray[0], gray[1],
            rel[:3, :3].numpy(), rel[:3, 3].numpy(), intr(cams[0]), intr(cams[1]))


def _scene(name):
    """(depth, normal, gray_r, gray_n, rot, t, intr_r, intr_n, weights)."""
    rng = np.random.default_rng(11)
    if name == "arc":
        s = _arc_scene()
        keep = (s[0] > 0) & (rng.random(s[0].shape) < 0.5)
    else:
        depth, normal, gr, gn, rot, t, intr = _plane_scene(h=40, w=72)
        s = (depth, normal, gr, gn, rot, t, intr, intr)
        keep = rng.random(depth.shape) < 0.4
    weights = np.where(keep, rng.uniform(0.2, 1.0, keep.shape), 0.0).astype(np.float32)
    return tuple(np.asarray(a, np.float32) if isinstance(a, np.ndarray) else a
                 for a in s) + (weights,)


def _port(sc, form):
    """The port's (ncc_sum, ncc_cnt, n_blocks, [d/d depth, d/d normal]) in
    the block form or the dense form masked as patchmatch_losses masks it."""
    depth, normal, gr, gn, rot, t, ir, inn, wts = sc
    d = torch.tensor(depth, requires_grad=True)
    n = torch.tensor(normal, requires_grad=True)
    T = torch.as_tensor
    if form == "blocks":
        s, cnt, win_rej, nb = tncc.warp_patch_ncc_blocks(
            d, n, T(gr), T(gn), T(rot), T(t), ir, inn, T(wts) > 0, T(wts))
        assert win_rej == 0
    else:
        cc, valid = tncc.warp_patch_ncc(d, n, T(gr), T(gn), T(rot), T(t), ir, inn)
        ncc = torch.clamp(1 - cc, 0, 2)
        mask = ((ncc < 0.9) & valid & (T(wts) > 0)).detach()
        s, cnt, nb = torch.where(mask, ncc * T(wts), 0.0).sum(), mask.sum(), None
    g = torch.autograd.grad(s, (d, n))
    return float(s.detach()), int(cnt), nb, [x.numpy() for x in g]


def _gsjax(sc):
    depth, normal, gr, gn, rot, t, ir, inn, wts = sc
    cap = 64

    def loss(d, n):
        out = jblocks(d, n, jnp.asarray(gr), jnp.asarray(gn), jnp.asarray(rot),
                      jnp.asarray(t), ir, inn, jnp.asarray(wts) > 0, jnp.asarray(wts), cap)
        return out[0], out

    (s, out), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(depth), jnp.asarray(normal))
    assert int(out[3]) <= cap and int(out[2]) == 0
    return float(s), int(out[1]), int(out[3]), [np.asarray(x) for x in g]


@pytest.fixture(scope="module", params=["arc", "plane"])
def runs(request):
    sc = _scene(request.param)
    return request.param, sc, _port(sc, "blocks"), _port(sc, "dense"), _gsjax(sc)


def test_warp_sample_blocks_matches_bilinear_and_its_grad():
    h, w = 24, 40
    img = np.random.default_rng(1).random((h, w)).astype(np.float32)
    rng = np.random.default_rng(2)
    u = rng.uniform(-3.0, w + 2.0, (3, 49, 256)).astype(np.float32)
    v = rng.uniform(-3.0, h + 2.0, (3, 49, 256)).astype(np.float32)
    u[0, 0, :4] = [0.0, w - 1.0, 1e6, -1e6]
    want = np.asarray(_bilinear(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
    du, dv = jax.grad(lambda a, b: jnp.sum(_bilinear(jnp.asarray(img), a, b)),
                      argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    before = ws.warp_sample_blocks.launches
    got = ws.warp_sample_blocks(torch.as_tensor(img), torch.as_tensor(u), torch.as_tensor(v))
    assert ws.warp_sample_blocks.launches == before, "the CPU runs the twin"
    assert got.shape == (3, 3, 49, 256)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(du), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dv), atol=1e-6)
    tu = torch.tensor(u, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    val = ws.WarpSample.apply(torch.as_tensor(img), tu, tv, ws.warp_sample_blocks)
    gu, gv = torch.autograd.grad(val.sum(), (tu, tv))
    assert torch.equal(val, got[0]) and torch.equal(gu, got[1]) and torch.equal(gv, got[2])


def test_blocks_match_gsjax(runs):
    name, _, (s, cnt, nb, _), _, (js, jcnt, jnb, _) = runs
    assert cnt > 20 and s > 0, name
    np.testing.assert_allclose(s, js, rtol=1e-5)
    assert (cnt, nb) == (jcnt, jnb)


def test_blocks_match_dense(runs):
    _, _, (s, cnt, _, g), (ds, dcnt, _, dg), _ = runs
    np.testing.assert_allclose(s, ds, rtol=1e-5)
    assert cnt == dcnt
    for a, b in zip(g, dg):
        scale = np.abs(b).max()
        assert scale > 0
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)


@pytest.mark.parametrize("arg", [0, 1], ids=["depth", "normal"])
def test_block_grads_match_gsjax(runs, arg):
    name, _, (_, _, _, g), _, (_, _, _, jg) = runs
    scale = np.abs(jg[arg]).max()
    assert scale > 0 and np.isfinite(g[arg]).all()
    np.testing.assert_allclose(g[arg] / scale, jg[arg] / scale,
                               atol={"plane": 1e-4, "arc": 5e-4}[name])


def test_block_count_and_dead_lanes(runs):
    """The blocks are those holding a mask pixel, in row-major order; on the
    plane the partial edge blocks are among them, and their dead lanes sit at
    the block's smallest live tap."""
    name, sc, (_, _, nb, _), _, _ = runs
    depth, normal, _, _, rot, t, ir, inn, wts = sc
    h, w = depth.shape
    m = np.zeros((-(-h // 16) * 16, -(-w // 16) * 16), bool)
    m[:h, :w] = wts > 0
    assert nb == int(m.reshape(m.shape[0] // 16, 16, -1, 16).any((1, 3)).sum())
    sel, _, _, in_img, _ = tncc.compact_blocks(torch.as_tensor(wts > 0))
    un, vn = tncc.block_neighbour_taps(torch.as_tensor(depth), torch.as_tensor(normal),
                                       torch.as_tensor(wts > 0), torch.as_tensor(rot),
                                       torch.as_tensor(t), ir, inn)
    assert un.shape == (nb, 49, 256) and torch.equal(sel, torch.sort(sel).values)
    dead = ~in_img
    if name == "plane":
        assert dead.any(), "partial edge blocks are selected"
    for taps in (un, vn):
        pin = torch.where(in_img[:, None], taps, torch.inf).amin((1, 2))
        assert torch.equal(torch.where(dead[:, None], taps, pin[:, None, None]),
                           pin[:, None, None].expand_as(taps))


def test_empty_mask_gives_zeros():
    depth, normal, gr, gn, rot, t, intr = _plane_scene(h=40, w=72)
    d = torch.tensor(depth, requires_grad=True)
    n = torch.tensor(normal, requires_grad=True)
    T = torch.as_tensor
    s, cnt, win_rej, nb = tncc.warp_patch_ncc_blocks(
        d, n, T(gr), T(gn), T(rot), T(t), intr, intr, torch.zeros(40, 72, dtype=torch.bool),
        torch.zeros(40, 72))
    assert (float(s.detach()), int(cnt), win_rej, nb) == (0.0, 0, 0, 0)
    for g in torch.autograd.grad(s, (d, n)):
        assert torch.equal(g, torch.zeros_like(g))
