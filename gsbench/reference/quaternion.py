# Frozen copy of gsjax_torch/core/quaternion.py at commit 95f6082 (the benchmark's plain
# reference; edited only where it named a kernel or another module of the port).
"""Quaternion utilities, wxyz convention (port of `gsjax/core/quaternion.py`,
`utils/general_utils.py:build_rotation/build_scaling_rotation`)."""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """[.., 4] unit quaternion (w,x,y,z) -> [.., 3, 3]; R maps
    gaussian-local directions to world: world_dir = R @ local_dir."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_covariance(scaling: torch.Tensor, rotation: torch.Tensor,
                     scale_modifier: float = 1.0) -> torch.Tensor:
    """World-space covariance Sigma = R diag(s^2) R^T."""
    R = to_rotation_matrix(rotation)
    RS = R * (scaling * scale_modifier)[..., None, :]
    return torch.einsum("...ij,...kj->...ik", RS, RS)
