"""probe_golden.py's emulation of gsjax's TPU NCC sampler window
(`tpu_window_ok`, `tpu_window_ok_dense`), which measures the NCC pixels that
window would drop, against gsjax's Pallas sampler run in interpret mode.

- `ok` of the dense sampler (`gsjax.ops.warp_sample.warp_sample`) and of the
  block sampler (`warp_sample_blocks`) equal to the port's bit for bit, on
  the taps of a plane with a band of columns without depth but with a normal (the
  homography divides by a zero distance, so those pixels' taps fly far away
  and take their blocks' windows with them), a frame whose blocks are whole
  and one whose last blocks are partial;
- the port's NCC `valid` masked by the window equals gsjax's dense NCC
  with its Pallas sampler on >= 99.5% of pixels (the sampler reads a
  bfloat16 image, which can move a patch variance across the 5e-6 floor),
  and every pixel that gsjax's window drops is dropped; the port's NCC
  alone keeps them (as gsjax's `_bilinear` path).
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops import ncc as jncc_mod
from gsjax.ops import warp_sample as jws
from gsjax_torch.ops import ncc as tncc
from gsjax_torch.ops import warp_sample as ws

torch.set_num_threads(1)
_spec = importlib.util.spec_from_file_location(
    "probe_golden", pathlib.Path(__file__).resolve().parents[1] / "probe_golden.py")
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)


def _scene(h, w, seed=3):
    """A tilted plane with no depth on a band of columns left of the centre
    (whose pixels keep a unit normal, as a render's background pixels with
    a faint normal do once normalised), textured luma images and a small
    reference -> neighbour motion."""
    rng = np.random.default_rng(seed)
    intr = (0.9 * w, 0.9 * w, w / 2, h / 2)
    n = np.array([0.2, -0.1, -1.0])
    n /= np.linalg.norm(n)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    ray = np.stack([(u - intr[2]) / intr[0], (v - intr[3]) / intr[1], np.ones_like(u)], -1)
    depth = (2.5 / -(ray @ n)).astype(np.float32)
    depth[:, w // 2 - 6: w // 2 + 2] = 0.0
    normal = np.broadcast_to(n, (h, w, 3)).astype(np.float32).copy()
    gray_r = rng.random((h, w)).astype(np.float32)
    gray_n = rng.random((h, w)).astype(np.float32)
    a = 0.12
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                   np.float32)
    t = np.array([-0.3, 0.02, 0.05], np.float32)
    return depth, normal, gray_r, gray_n, rot, t, intr


@pytest.mark.parametrize("h,w", [(32, 128), (24, 120)], ids=["whole_blocks", "partial_blocks"])
def test_window_ok_matches_pallas_sampler(h, w):
    depth, normal, gray_r, gray_n, rot, t, intr = _scene(h, w)
    T = torch.as_tensor
    un, vn = tncc.neighbour_taps(T(depth), T(normal), T(rot), T(t), intr, intr)
    _, ok = jws.warp_sample(jnp.asarray(gray_n), jnp.asarray(un.numpy()),
                            jnp.asarray(vn.numpy()), True)
    got = probe.tpu_window_ok_dense(un, vn).numpy()
    assert np.array_equal(got, np.asarray(ok))
    assert 0 < got.sum() < got.size, "the window drops some pixels and keeps others"


def test_block_window_ok_matches_pallas_sampler():
    """The block sampler on the frame's blocks, each with its own window."""
    h, w = 32, 128
    depth, normal, gray_r, gray_n, rot, t, intr = _scene(h, w)
    T = torch.as_tensor
    sel, u_i, v_i, in_img, flat = tncc.compact_blocks(torch.ones(h, w, dtype=torch.bool))
    bu, bv = tncc._block_taps(u_i, v_i, in_img, flat, T(depth), T(normal), T(rot), T(t),
                              intr, intr, 3)
    _, okb = jws.warp_sample_blocks(jnp.asarray(gray_n), jnp.asarray(bu.numpy()),
                                    jnp.asarray(bv.numpy()), True)
    gotb = probe.tpu_window_ok(bu, bv, max(-(-h // 16) * 16, probe.TPU_RV),
                               max(-(-w // 128) * 128, probe.TPU_RU)).numpy()
    assert np.array_equal(gotb, np.asarray(okb)) and not gotb.all()


def test_ncc_valid_matches_gsjax_pallas_path(monkeypatch):
    h, w = 32, 128
    depth, normal, gray_r, gray_n, rot, t, intr = _scene(h, w)
    monkeypatch.setattr(jncc_mod, "_NCC_BACKEND", "pallas")
    # unjitted, so the sampler choice is read now and no cached trace is reused
    _, jvalid = jncc_mod.warp_patch_ncc.__wrapped__(
        jnp.asarray(depth), jnp.asarray(normal), jnp.asarray(gray_r), jnp.asarray(gray_n),
        jnp.asarray(rot), jnp.asarray(t), intr, intr)
    jvalid = np.asarray(jvalid)
    T = torch.as_tensor
    args = (T(depth), T(normal), T(gray_r), T(gray_n), T(rot), T(t), intr, intr)
    _, dense = tncc.warp_patch_ncc(*args, sample_fn=ws.bilinear_ref)
    ok = probe.tpu_window_ok_dense(
        *tncc.neighbour_taps(T(depth), T(normal), T(rot), T(t), intr, intr)).numpy()
    dense = dense.numpy()
    win = dense & ok
    assert (win == jvalid).mean() >= 0.995
    dropped = dense & ~ok
    assert dropped.any() and not (jvalid & dropped).any()
