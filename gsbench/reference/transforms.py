# Frozen copy of gsjax_torch/core/transforms.py at commit 95f6082 (the benchmark's plain
# reference; edited only where it named a kernel or another module of the port).
"""Camera transforms and projection math (numpy; a copy of
`gsjax/core/transforms.py`, kept here so the port never imports gsjax).

Functional equivalents of the reference's `utils/graphics_utils.py:44-100`
(getWorld2View2, getProjectionMatrix, fov/focal conversions) and the camera
conventions used by the CUDA rasterizer (`auxiliary.h` transformPoint4x3/4x4
consume the GL-style transposed matrices produced in `scene/cameras.py:70-73`).

The port keeps matrices in plain math convention: `world_view @ [p;1]` maps world
to camera. The transposed-flat layout of the reference is an artifact of its
glm interop and is not reproduced.
"""

from __future__ import annotations

import math

import numpy as np

NEAR_PLANE = 0.2  # cuda_rasterizer/config.h:27
FAR_PLANE = 100.0  # cuda_rasterizer/config.h:28


def world_to_view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4. `R` is the camera-to-world rotation (COLMAP qvec
    convention as stored by the reference), `t` the world->camera translation.

    Mirrors `utils/graphics_utils.py:getWorld2View2` (without the transpose the
    reference applies for glm)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective matrix, z in [0, 1], +z forward.

    Matches `utils/graphics_utils.py:getProjectionMatrix`."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_half_fovx
    P[1, 1] = 1.0 / tan_half_fovy
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def ndc_to_pix(v, size: int):
    """NDC in [-1,1] -> continuous pixel coordinate. auxiliary.h:ndc2Pix."""
    return ((v + 1.0) * size - 1.0) * 0.5
