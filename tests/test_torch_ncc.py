"""The port's NCC sampler (the twin of kernel B6) and dense `warp_patch_ncc`
against gsjax's.

- sampler twin `bilinear_ref`: values against gsjax's `ncc._bilinear` and
  d/du, d/dv against `jax.grad` of it, at seeded taps inside, on the border
  of and far outside the image (clamped corners), within 1e-6 absolute (the
  same float32 operations);
- `warp_patch_ncc`: against gsjax's dense `warp_patch_ncc` on the CPU (its
  `_bilinear` path) for a tilted plane seen from a shifted neighbour: NCC
  within 1e-5, `valid` equal, gradients to depth and normal within 1e-4 of
  each one's largest entry; the identity warp gives NCC 1 (as
  test_sample_ncc.py:91-102);
- the differentiable sampler passes d(value) d/du, d(value) d/dv to the tap
  positions and nothing to the image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.ncc import _bilinear
from gsjax.ops.ncc import warp_patch_ncc as jncc
from gsjax_torch.ops import warp_sample as ws
from gsjax_torch.ops.ncc import warp_patch_ncc as tncc

torch.set_num_threads(1)


def _taps(h, w, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-3.0, w + 2.0, n)
    v = rng.uniform(-3.0, h + 2.0, n)
    u[:8] = [0.0, w - 1.0, w - 0.5, -0.25, 1e6, -1e6, 3.0, 5.5]   # border, far out
    v[:8] = [0.0, h - 1.0, 2.5, h - 0.75, 3.0, 4.0, -1e6, 1e6]
    return u.astype(np.float32), v.astype(np.float32)


def test_sampler_twin_matches_bilinear_and_its_grad():
    h, w = 24, 40
    img = np.random.default_rng(1).random((h, w)).astype(np.float32)
    u, v = _taps(h, w)
    want = np.asarray(_bilinear(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
    du, dv = jax.vmap(jax.grad(lambda a, b: _bilinear(jnp.asarray(img), a, b),
                               argnums=(0, 1)))(jnp.asarray(u), jnp.asarray(v))
    got = ws.bilinear_ref(torch.as_tensor(img), torch.as_tensor(u), torch.as_tensor(v))
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(du), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dv), atol=1e-6)
    assert (got[1].numpy()[[4, 5]] == 0).all(), "clamped corner pairs give zero"


def test_warp_sample_wrapper_and_vjp():
    img = torch.rand(12, 20, generator=torch.Generator().manual_seed(0))
    u = (torch.rand(3, 5, 7) * 22 - 1).requires_grad_(True)
    v = (torch.rand(3, 5, 7) * 14 - 1).requires_grad_(True)
    before = ws.warp_sample.launches
    planes = ws.warp_sample(img, u.detach(), v.detach())
    assert ws.warp_sample.launches == before
    assert torch.equal(planes, ws.bilinear_ref(img, u.detach(), v.detach()))
    g = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(1))
    val = ws.WarpSample.apply(img, u, v, ws.warp_sample)
    gu, gv = torch.autograd.grad((val * g).sum(), (u, v))
    assert torch.equal(val, planes[0])
    assert torch.equal(gu, g * planes[1]) and torch.equal(gv, g * planes[2])


def _plane_scene(h=40, w=56, seed=2):
    """Reference depth/normal of a tilted plane, two luma images, and a
    reference -> neighbour motion (small rotation about y, shift in x)."""
    rng = np.random.default_rng(seed)
    intr = (50.0, 50.0, (w - 1) / 2, (h - 1) / 2)
    n = np.array([0.2, -0.1, -1.0])
    n /= np.linalg.norm(n)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    ray = np.stack([(u - intr[2]) / intr[0], (v - intr[3]) / intr[1], np.ones_like(u)], -1)
    depth = (2.5 / -(ray @ n)).astype(np.float32)           # plane n.p = -2.5
    normal = np.broadcast_to(n, (h, w, 3)).astype(np.float32)
    # high-contrast texture: a patch's variance is large against its mean, so
    # the float32 sums behind the NCC cancel little (on a smooth image a
    # one-ulp change of a tap position, from another contraction order of
    # the homography, moves the NCC by up to 5e-4)
    yy, xx = np.mgrid[0:h, 0:w] / 7.0
    gray_r = (0.3 * np.sin(xx * 1.3 + yy) + 0.7 * rng.random((h, w))).astype(np.float32)
    gray_n = (0.3 * np.sin(xx * 1.3 + 0.9 * yy + 0.4)
              + 0.7 * rng.random((h, w))).astype(np.float32)
    a = 0.04
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                   np.float32)
    t = np.array([0.12, 0.02, 0.0], np.float32)
    return depth, normal, gray_r, gray_n, rot, t, intr


@pytest.fixture(scope="module")
def ncc_pair():
    depth, normal, gray_r, gray_n, rot, t, intr = _plane_scene()
    rng = np.random.default_rng(5)
    ct = rng.normal(0, 1, depth.shape).astype(np.float32)

    def jloss(d, nrm):
        ncc, valid = jncc(d, nrm, jnp.asarray(gray_r), jnp.asarray(gray_n),
                          jnp.asarray(rot), jnp.asarray(t), intr, intr)
        return jnp.sum(ncc * ct), (ncc, valid)

    (_, (jn, jv)), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(depth), jnp.asarray(normal))
    d = torch.tensor(depth, requires_grad=True)
    nrm = torch.tensor(normal, requires_grad=True)
    tn, tv = tncc(d, nrm, torch.as_tensor(gray_r), torch.as_tensor(gray_n),
                  torch.as_tensor(rot), torch.as_tensor(t), intr, intr)
    tg = torch.autograd.grad((tn * torch.as_tensor(ct)).sum(), (d, nrm))
    return (np.asarray(jn), np.asarray(jv), [np.asarray(x) for x in jg]), \
        (tn.detach().numpy(), tv.numpy(), [x.numpy() for x in tg])


def test_ncc_matches_gsjax(ncc_pair):
    (jn, jv, _), (tn, tv, _) = ncc_pair
    np.testing.assert_array_equal(tv, jv)
    assert jv.mean() > 0.3 and jn[jv].max() > 0.1
    np.testing.assert_allclose(tn, jn, atol=1e-5)


@pytest.mark.parametrize("arg", [0, 1], ids=["depth", "normal"])
def test_ncc_grads_match_gsjax(ncc_pair, arg):
    (_, _, jg), (_, _, tg) = ncc_pair
    scale = np.abs(jg[arg]).max()
    assert scale > 0 and np.isfinite(tg[arg]).all()
    np.testing.assert_allclose(tg[arg] / scale, jg[arg] / scale, atol=1e-4)


def test_ncc_identity_is_one():
    gray = torch.as_tensor(np.random.default_rng(0).random((48, 64)).astype(np.float32))
    intr = (50.0, 50.0, 31.5, 23.5)
    normal = torch.tensor([0.0, 0.0, -1.0]).expand(48, 64, 3)
    ncc, valid = tncc(torch.full((48, 64), 2.0), normal, gray, gray, torch.eye(3),
                      torch.zeros(3), intr, intr)
    assert valid.sum() > 500
    np.testing.assert_allclose(ncc[valid].numpy(), 1.0, atol=1e-3)
