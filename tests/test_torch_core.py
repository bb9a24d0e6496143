"""gsjax_torch core math and camera against gsjax, on the same numpy inputs.

Tolerance: atol 1e-6, rtol 1e-5 — both sides compute the same float32
expressions; only operation order inside einsum/matmul differs.
"""

import numpy as np
import pytest
import torch

from gsjax.core import quaternion as jquat
from gsjax.core import sg as jsg
from gsjax.core import sh as jsh
from gsjax.ops.raster.camera import Camera as JCamera
from gsjax_torch.core import quaternion as tquat
from gsjax_torch.core import sg as tsg
from gsjax_torch.core import sh as tsh
from gsjax_torch.ops.raster.camera import Camera as TCamera

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=1e-5)


def _dirs(rng, n):
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(0, 0.5, (64, 16, 3)).astype(np.float32)
    dirs = _dirs(rng, 64)
    want = np.asarray(jsh.eval_sh(degree, sh, dirs))
    got = tsh.eval_sh(degree, torch.as_tensor(sh), torch.as_tensor(dirs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("degree", [0, 2])
def test_eval_sg(degree):
    rng = np.random.default_rng(10 + degree)
    n, g = 64, 3
    axis = _dirs(rng, n * g).reshape(n, g, 3)
    sharp = rng.uniform(0.1, 4.0, (n, g)).astype(np.float32)
    color = rng.normal(0, 0.3, (n, g, 3)).astype(np.float32)
    dirs = _dirs(rng, n)
    want = np.asarray(jsg.eval_sg(degree, axis, sharp, color, dirs))
    got = tsg.eval_sg(degree, *map(torch.as_tensor, (axis, sharp, color, dirs))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_build_covariance():
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = np.exp(rng.normal(-2, 0.5, (64, 3))).astype(np.float32)
    want = np.asarray(jquat.build_covariance(s, q, 1.3))
    got = tquat.build_covariance(torch.as_tensor(s), torch.as_tensor(q), 1.3).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(tquat.to_rotation_matrix(torch.as_tensor(q)).numpy(),
                               np.asarray(jquat.to_rotation_matrix(q)), **TOL)


@pytest.mark.parametrize("angle", [0.0, 0.4])
def test_camera_create(angle):
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    T = np.array([0.1, -0.2, 0.3], np.float32)
    jc = JCamera.create(R, T, 0.9, 0.7, 96, 64)
    tc = TCamera.create(R, T, 0.9, 0.7, 96, 64, device="cpu")
    for name in ("world_view", "full_proj", "campos"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), **TOL)
    for name in ("fx", "fy", "cx", "cy", "tan_fovx", "tan_fovy"):
        assert getattr(tc, name) == pytest.approx(float(getattr(jc, name)), rel=1e-7)
    assert (tc.width, tc.height) == (jc.width, jc.height)
    tm = TCamera.from_matrices(96, 64, 0.9, 0.7, np.asarray(jc.world_view),
                               np.asarray(jc.full_proj), device="cpu")
    np.testing.assert_allclose(tm.campos.numpy(), np.asarray(jc.campos), **TOL)
    assert tm.fx == tc.fx


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a card, an entry point not asked for the CPU raises; it never
    falls back to the CPU silently."""
    from gsjax_torch import resolve_device
    from gsjax_torch.model.io import load_ply

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        load_ply(str(tmp_path / "missing.ply"))
    assert resolve_device("cpu") == torch.device("cpu")
