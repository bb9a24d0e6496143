"""3x3 matrix products of many rows, written out elementwise in a fixed order.

A library matrix product picks its kernel, and so its rounding, by the
number of rows; these give each row the same bits however many rows come
with it. The multi-device step runs the projection, the multi-view queries
and the NCC's homographies on a band of the frame's rows, which must match
the whole frame's bit for bit (`gsjax_torch.parallel`).
"""

from __future__ import annotations

import torch


def affine(x: torch.Tensor, m: torch.Tensor, t: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., 3] @ m.T (+ t): m [R, 3], t [R] -> [..., R]."""
    out = x[..., 0:1] * m[:, 0] + x[..., 1:2] * m[:, 1] + x[..., 2:3] * m[:, 2]
    return out if t is None else out + t


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., 3, 3] @ b [..., 3, 3], broadcast over the leading axes."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def matvec3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a [..., 3, 3] @ v [..., 3] -> [..., 3]."""
    return a[..., :, 0] * v[..., 0:1] + a[..., :, 1] * v[..., 1:2] + a[..., :, 2] * v[..., 2:3]
