"""gsjax_torch training losses against gsjax's, values and gradients.

Values within 1e-6 and gradients within 1e-5 of the gradient's largest
magnitude (float32 in both packages, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.train import losses as jl
from gsjax_torch.train import losses as tl

torch.set_num_threads(1)
H, W = 24, 32
FX, FY, CX, CY = 30.0, 28.0, (W - 1) / 2, (H - 1) / 2


def _images(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32)   # renders overshoot early
    b = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return a, b


def _depth(seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    d = 2.0 + 0.02 * xx + 0.01 * yy + rng.normal(0, 0.01, (H, W)).astype(np.float32)
    d[:4, :6] = 0.0                    # a hole: invalid neighbours
    return d


def _normals(seed=2):
    n = np.random.default_rng(seed).normal(0, 1, (H, W, 3)).astype(np.float32)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def _emb():
    return np.array([0.1, -0.05], np.float32)


def _exposure():
    e = np.eye(3, 4, dtype=np.float32)
    e[:, 3] = [0.01, -0.02, 0.03]
    return e * 1.1


# name -> (loss(L, T, *inputs) with L the losses module and T its array
# constructor for constants, inputs)
CASES = {
    "l1": (lambda L, T, a, b: L.l1_loss(a, b), _images),
    "l2": (lambda L, T, a, b: L.l2_loss(a, b), _images),
    "psnr": (lambda L, T, a, b: L.psnr(a, b), _images),
    "ssim": (lambda L, T, a, b: L.ssim(a, b), _images),
    "depth_normal": (
        lambda L, T, d, n: L.depth_normal_loss(n, *L.depth_to_normal(d, FX, FY, CX, CY)),
        lambda: (_depth(), _normals())),
    "appearance_gs": (lambda L, T, a, e: L.l1_appearance_gs(a, T(_images()[1]), e),
                      lambda: (_images()[0], _exposure())),
    "appearance_pgsr": (lambda L, T, a, e: L.l1_appearance_pgsr(a, T(_images()[1]), e),
                        lambda: (_images()[0], _emb())),
}


@pytest.mark.parametrize("name", list(CASES))
def test_value_and_grad_match_gsjax(name):
    fn, make = CASES[name]
    x = make()
    val_j, grads_j = jax.value_and_grad(
        lambda *a: fn(jl, jnp.asarray, *a), argnums=tuple(range(len(x))))(*map(jnp.asarray, x))
    args = [torch.tensor(a, requires_grad=True) for a in x]
    val_t = fn(tl, torch.as_tensor, *args)
    grads_t = torch.autograd.grad(val_t, args)
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-6, atol=1e-6)
    for gj, gt in zip(grads_j, grads_t):
        gj = np.asarray(gj)
        scale = np.abs(gj).max() + 1e-12
        np.testing.assert_allclose(gt.numpy() / scale, gj / scale, atol=1e-5)


def test_depth_to_normal_and_grad_weight_match_gsjax():
    d = _depth()
    nj, vj = jl.depth_to_normal(jnp.asarray(d), FX, FY, CX, CY)
    nt, vt = tl.depth_to_normal(torch.as_tensor(d), FX, FY, CX, CY)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-6)
    img = _images()[0]
    np.testing.assert_allclose(tl.img_grad_weight(torch.as_tensor(img)).numpy(),
                               np.asarray(jl.img_grad_weight(jnp.asarray(img))), atol=1e-6)


def test_depth_normal_grad_finite_on_flat_and_empty_depth():
    """Port of tests/test_train_step.py:107-125: depth_to_normal's
    normalisation must not emit NaN gradients at zero cross products."""
    depth = torch.zeros(16, 16)
    depth[4:12, 4:12] = 2.0            # flat plateau + empty border
    depth.requires_grad_(True)
    n, valid = tl.depth_to_normal(depth, 20.0, 20.0, 8.0, 8.0)
    rn = torch.ones(16, 16, 3) / np.sqrt(3.0)
    g, = torch.autograd.grad(tl.depth_normal_loss(rn, n, valid), depth)
    assert torch.isfinite(g).all(), "NaN/inf in depth-normal gradient"
