"""Gaussian point-cloud model (port of `gsjax/model/gaussians.py`).

`GaussianParams` holds the trainable leaves as `nn.Parameter`s of one
`nn.Module`, in gsjax's raw (pre-activation) parameterisation: log-scales,
logit-opacity, unnormalised quaternions and SG axes (scene/gaussian_model.py:
45-62). Like gsjax the model is padded to a fixed capacity with an `alive`
mask in `GaussianAux`, so a PLY or checkpoint moves between the two packages
slot for slot.

`params_from_numpy` / `params_to_numpy` carry weights across: they take and
give gsjax's `GaussianParams` / `GaussianAux` leaves as numpy arrays keyed by
field name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
                "rotation", "sg_axis", "sg_sharpness", "sg_color")


class GaussianParams(nn.Module):
    """Trainable leaves, [CAP, ...] each:
    xyz [N,3], features_dc [N,1,3], features_rest [N,M-1,3], opacity [N,1]
    logit, scaling [N,3] log, rotation [N,4], sg_axis [N,G,3],
    sg_sharpness [N,G] pre-softplus, sg_color [N,G,3]."""

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        missing = set(PARAM_FIELDS) - set(leaves)
        if missing:
            raise ValueError(f"missing parameter leaves: {sorted(missing)}")
        for name in PARAM_FIELDS:
            self.register_parameter(name, nn.Parameter(leaves[name]))

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


@dataclasses.dataclass
class GaussianAux:
    """Non-trainable per-gaussian state."""
    alive: torch.Tensor           # [N] bool
    filter_3d: torch.Tensor       # [N] Mip-Splatting 3D filter sigma
    grad_accum: torch.Tensor      # [N] |dL/dmean2d_ndc| accumulated
    grad_accum_abs: torch.Tensor  # [N] abs-grad channel (GOF)
    denom: torch.Tensor           # [N]
    max_radii: torch.Tensor       # [N] int32


AUX_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianAux))


# --- activations -------------------------------------------------------------

def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_features(p: GaussianParams) -> torch.Tensor:
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def get_sg_sharpness(p: GaussianParams) -> torch.Tensor:
    return F.softplus(p.sg_sharpness)


def get_sg_axis(p: GaussianParams) -> torch.Tensor:
    n = torch.linalg.norm(p.sg_axis, dim=2, keepdim=True)
    return p.sg_axis / n.clamp_min(1e-12)


def scaling_n_opacity_with_3d_filter(p: GaussianParams, filter_3d: torch.Tensor):
    """Mip-Splatting 3D filter applied to scales and opacity
    (scene/gaussian_model.py:203-212)."""
    opacity = get_opacity(p)
    scales = get_scaling(p)
    scales_sq = scales * scales
    det1 = torch.prod(scales_sq, dim=1)
    scales_after = scales_sq + (filter_3d * filter_3d)[:, None]
    det2 = torch.prod(scales_after, dim=1)
    coef = torch.sqrt(det1 / det2.clamp_min(1e-30))
    return torch.sqrt(scales_after), opacity * coef[:, None]


# --- weight carrier ----------------------------------------------------------

def params_from_numpy(params: dict[str, np.ndarray], aux: dict[str, np.ndarray],
                      device: str | torch.device) -> tuple[GaussianParams, GaussianAux]:
    """gsjax `GaussianParams` / `GaussianAux` leaves (numpy, keyed by field
    name) -> the port's model on `device`."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    p = GaussianParams(**{k: f32(params[k]) for k in PARAM_FIELDS})
    a = GaussianAux(
        alive=torch.as_tensor(np.asarray(aux["alive"], bool), device=device),
        filter_3d=f32(aux["filter_3d"]),
        grad_accum=f32(aux["grad_accum"]),
        grad_accum_abs=f32(aux["grad_accum_abs"]),
        denom=f32(aux["denom"]),
        max_radii=torch.as_tensor(np.asarray(aux["max_radii"], np.int32), device=device),
    )
    return p, a


def params_to_numpy(params: GaussianParams, aux: GaussianAux
                    ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Inverse of `params_from_numpy`."""
    p = {k: getattr(params, k).detach().cpu().numpy() for k in PARAM_FIELDS}
    a = {k: getattr(aux, k).detach().cpu().numpy() for k in AUX_FIELDS}
    return p, a
