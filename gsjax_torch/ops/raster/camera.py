"""Camera consumed by the rasterizer (port of `gsjax/ops/raster/camera.py`).

Matrices are float32 tensors on the camera's device, in plain math
convention (`world_view @ [p;1]`). The scalars (focal lengths, principal
point, fov tangents) are Python floats holding float32-rounded values, so the
kernel launch reads them without a device round trip and torch arithmetic
with them matches gsjax's float32 scalars.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gsjax_torch.core import transforms


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Camera:
    world_view: torch.Tensor     # [4,4] world -> camera
    full_proj: torch.Tensor      # [4,4] world -> clip (proj @ world_view)
    campos: torch.Tensor         # [3] camera centre in world space
    fx: float                    # focal in pixels
    fy: float
    cx: float                    # principal point, (W-1)/2 (cameras.py:51)
    cy: float
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    @staticmethod
    def _build(wv, full, width, height, fovx, fovy, device) -> "Camera":
        wv = np.asarray(wv, np.float32)
        c2w = np.linalg.inv(wv)
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return Camera(
            world_view=as_t(wv),
            full_proj=as_t(full),
            campos=as_t(c2w[:3, 3]),
            fx=_f32(transforms.fov2focal(fovx, width)),
            fy=_f32(transforms.fov2focal(fovy, height)),
            cx=_f32((width - 1) / 2),
            cy=_f32((height - 1) / 2),
            tan_fovx=_f32(math.tan(fovx * 0.5)),
            tan_fovy=_f32(math.tan(fovy * 0.5)),
            width=int(width),
            height=int(height),
        )

    @staticmethod
    def create(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
               width: int, height: int, znear: float = 0.01,
               zfar: float = 100.0, trans=None, scale: float = 1.0,
               device: str | torch.device = "cuda") -> "Camera":
        """From COLMAP-convention extrinsics (R: cam->world rotation,
        T: world->cam translation), mirroring `scene/cameras.py`."""
        wv = transforms.world_to_view(R, T, trans, scale)
        proj = transforms.projection_matrix(znear, zfar, fovx, fovy)
        return Camera._build(wv, proj @ wv, width, height, fovx, fovy, device)

    @staticmethod
    def from_matrices(width: int, height: int, fovx: float, fovy: float,
                      world_view: np.ndarray, full_proj: np.ndarray,
                      device: str | torch.device = "cuda") -> "Camera":
        """From explicit world->view and world->clip matrices (the MiniCam of
        scene/cameras.py:77-89, the live-viewer path)."""
        return Camera._build(world_view, full_proj, width, height, fovx, fovy,
                             device)
