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

Training state: Adam (`AdamState`, `adam_init`, `adam_update`, eps 1e-15 and
per-field LRs as scene/gaussian_model.py:342-439) is a plain update under
`torch.no_grad()` that writes the parameters in place; its moments are
tensors keyed by field name, so the moment surgery of densification is a
tensor edit, as in gsjax. `init_from_pcd`, `compute_3d_filter`,
`reset_opacity`, `add_densification_stats`, `densify_and_prune` and
`grow_capacity` follow gsjax's functions one for one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gsjax_torch.core import sh as sh_lib
from gsjax_torch.core.quaternion import to_rotation_matrix

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
    name) -> the port's model on `device`. The model owns copies: training
    updates it in place, which must not write through to the caller's
    arrays (on the CPU a numpy array can share memory with a tensor, and
    with a JAX array that is still reading it)."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    p = GaussianParams(**{k: f32(params[k]) for k in PARAM_FIELDS})
    a = GaussianAux(
        alive=torch.tensor(np.asarray(aux["alive"], bool), device=device),
        filter_3d=f32(aux["filter_3d"]),
        grad_accum=f32(aux["grad_accum"]),
        grad_accum_abs=f32(aux["grad_accum_abs"]),
        denom=f32(aux["denom"]),
        max_radii=torch.tensor(np.asarray(aux["max_radii"], np.int32), device=device),
    )
    return p, a


def params_to_numpy(params: GaussianParams, aux: GaussianAux
                    ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Inverse of `params_from_numpy`."""
    p = {k: getattr(params, k).detach().cpu().numpy() for k in PARAM_FIELDS}
    a = {k: getattr(aux, k).detach().cpu().numpy() for k in AUX_FIELDS}
    return p, a


def opacity_with_3d_filter(p: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    return scaling_n_opacity_with_3d_filter(p, filter_3d)[1]


def scaling_with_3d_filter(p: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    return scaling_n_opacity_with_3d_filter(p, filter_3d)[0]


# --- 3D filter ---------------------------------------------------------------

def compute_3d_filter(xyz: torch.Tensor, alive: torch.Tensor,
                      view_mats: torch.Tensor, focals_x: torch.Tensor,
                      widths: torch.Tensor, heights: torch.Tensor,
                      focals_y: torch.Tensor) -> torch.Tensor:
    """Min view depth / max focal * sqrt(0.2) (scene/gaussian_model.py:226-262).

    view_mats: [C,4,4] world->camera; focals/widths/heights: [C]."""
    n = xyz.shape[0]
    dist = torch.full((n,), float("inf"), device=xyz.device)
    valid_any = torch.zeros(n, dtype=torch.bool, device=xyz.device)
    for c in range(view_mats.shape[0]):
        wv = view_mats[c]
        cam = xyz @ wv[:3, :3].T + wv[:3, 3]
        z = cam[:, 2]
        valid_depth = z > 0.2
        z_safe = torch.where(valid_depth, z, torch.ones_like(z))
        u = torch.abs(cam[:, 0] / z_safe)
        v = torch.abs(cam[:, 1] / z_safe)
        in_screen = (u <= widths[c] / focals_x[c] * 0.575) & \
            (v <= heights[c] / focals_y[c] * 0.575)
        valid = valid_depth & in_screen
        dist = torch.where(valid, torch.minimum(dist, z), dist)
        valid_any = valid_any | valid
    max_focal = torch.clamp_min(focals_x.max(), 1e-6)
    fallback = torch.where(valid_any & alive, dist, torch.full_like(dist, -float("inf"))).max()
    fallback = torch.where(torch.isfinite(fallback), fallback, torch.ones_like(fallback))
    dist = torch.where(valid_any, dist, fallback)
    return dist / max_focal * (0.2 ** 0.5)


# --- init --------------------------------------------------------------------

def inverse_sigmoid(x):
    return np.log(x / (1 - x))


def init_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                  sh_degree: int, sg_degree: int, knn_dist2: np.ndarray,
                  seed: int = 0, device: str | torch.device = "cuda"
                  ) -> tuple[GaussianParams, GaussianAux]:
    """`create_from_pcd` (scene/gaussian_model.py:304-340), padded to
    capacity; the SG axes come from the same seeded numpy stream as gsjax's."""
    n = points.shape[0]
    assert capacity >= n
    m = (sh_degree + 1) ** 2
    g = max(sg_degree, 1)  # keep at least 1 lobe slot, as gsjax
    rng = np.random.default_rng(seed)

    def pad(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, dtype=np.float32)
        out[:n] = x
        return out

    fused_color = sh_lib.rgb_to_sh(colors.astype(np.float32))
    dist2 = np.maximum(knn_dist2, 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1
    opac = inverse_sigmoid(0.1 * np.ones((n, 1), np.float32))
    sg_axis = rng.normal(0, 1, (n, g, 3)).astype(np.float32)
    sg_axis /= np.maximum(np.linalg.norm(sg_axis, axis=2, keepdims=True), 1e-12)
    rotation = pad(rots)
    rotation[n:, 0] = 1.0                 # dead slots: identity quaternions
    params = dict(
        xyz=pad(points.astype(np.float32)),
        features_dc=pad(fused_color[:, None, :]),
        features_rest=pad(np.zeros((n, m - 1, 3), np.float32)),
        opacity=pad(opac), scaling=pad(scales.astype(np.float32)),
        rotation=rotation, sg_axis=pad(sg_axis),
        sg_sharpness=pad(np.zeros((n, g), np.float32)),
        sg_color=pad(np.zeros((n, g, 3), np.float32)))
    zeros = np.zeros(capacity, np.float32)
    aux = dict(alive=np.arange(capacity) < n, filter_3d=zeros, grad_accum=zeros,
               grad_accum_abs=zeros, denom=zeros,
               max_radii=np.zeros(capacity, np.int32))
    return params_from_numpy(params, aux, device)


# --- Adam --------------------------------------------------------------------

@dataclasses.dataclass
class AdamState:
    """First and second moments keyed by parameter field, and the step count."""
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int = 0


def adam_init(params: GaussianParams) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(getattr(params, k)) for k in PARAM_FIELDS},
        nu={k: torch.zeros_like(getattr(params, k)) for k in PARAM_FIELDS})


@torch.no_grad()
def adam_update(params: GaussianParams, grads: dict[str, torch.Tensor],
                state: AdamState, lrs: dict[str, float], b1=0.9, b2=0.999,
                eps=1e-15) -> None:
    """One Adam step with per-field LRs (reference Adam eps=1e-15,
    scene/gaussian_model.py:347-351), in place on `params` and `state`."""
    state.count += 1
    c = np.float32(state.count)
    bc1 = float(np.float32(1) - np.float32(b1) ** c)
    bc2 = float(np.float32(1) - np.float32(b2) ** c)
    for k in PARAM_FIELDS:
        g = grads[k]
        mu = state.mu[k].mul_(b1).add_((1 - b1) * g)
        nu = state.nu[k].mul_(b2).add_((1 - b2) * g * g)
        getattr(params, k).sub_(lrs[k] * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)))


# --- opacity reset -----------------------------------------------------------

@torch.no_grad()
def reset_opacity(params: GaussianParams, aux: GaussianAux, adam: AdamState) -> None:
    """Clamp filtered opacity to <= 0.01 and invert through the 3D filter
    (scene/gaussian_model.py:521-539); zeroes the opacity Adam moments
    (replace_tensor_to_optimizer, :613-628). In place."""
    new = torch.clamp_max(opacity_with_3d_filter(params, aux.filter_3d), 0.01)
    scales_sq = get_scaling(params) ** 2
    det1 = torch.prod(scales_sq, dim=1)
    det2 = torch.prod(scales_sq + (aux.filter_3d ** 2)[:, None], dim=1)
    coef = torch.sqrt(det1 / det2.clamp_min(1e-30))
    new = new / coef[:, None].clamp_min(1e-12)
    params.opacity.copy_(torch.log(new / (1 - new).clamp_min(1e-12)))
    adam.mu["opacity"].zero_()
    adam.nu["opacity"].zero_()


# --- densification -----------------------------------------------------------

def add_densification_stats(aux: GaussianAux, mean2d_grad: torch.Tensor,
                            visibility: torch.Tensor, width: int,
                            height: int) -> GaussianAux:
    """Accumulate NDC-scale viewspace gradients (train.py:237,
    gaussian_model.py:818-821; NDC scaling render_backward.cu:893). The abs
    channel is |gx| + |gy| of the summed mean2d gradient, as gsjax computes
    it; the reference sums per-pixel |dx| + |dy| inside its backward kernel
    (render_backward.cu:1028)."""
    gx = mean2d_grad[:, 0] * (0.5 * width)
    gy = mean2d_grad[:, 1] * (0.5 * height)
    zero = torch.zeros_like(gx)
    return dataclasses.replace(
        aux,
        grad_accum=aux.grad_accum + torch.where(visibility, torch.sqrt(gx * gx + gy * gy), zero),
        grad_accum_abs=aux.grad_accum_abs + torch.where(visibility, gx.abs() + gy.abs(), zero),
        denom=aux.denom + visibility.to(torch.float32))


@torch.no_grad()
def densify_and_prune(params: GaussianParams, aux: GaussianAux, adam: AdamState,
                      generator: torch.Generator | None, max_grad: float,
                      min_opacity: float, extent: float,
                      percent_dense: float = 0.01, noise: torch.Tensor | None = None
                      ) -> tuple[GaussianParams, GaussianAux, AdamState, dict]:
    """GOF clone/split + opacity prune (scene/gaussian_model.py:737-816) on
    the fixed-capacity tensors, as gsjax's pure function: new gaussians go
    into dead slots (lowest first) with zeroed Adam moments.

    The three position samples are standard normals [3, CAP, 3] drawn from
    `generator`, or `noise` when given (a test injects gsjax's samples).
    Every child copies its parent's fields as they were before this call;
    gsjax reads them after earlier children were written, so a split child
    whose parent's slot was reused takes that child's fields (ROADMAP queue
    C). Returns (params, aux, adam, stats) with stats a dict of ints."""
    cap = params.capacity
    dev = params.xyz.device
    grads = torch.where(aux.denom > 0, aux.grad_accum / aux.denom.clamp_min(1.0), 0.0)
    grads_abs = torch.where(aux.denom > 0, aux.grad_accum_abs / aux.denom.clamp_min(1.0), 0.0)

    alive = aux.alive
    scaling = get_scaling(params)
    max_scale = scaling.amax(dim=1)
    opac = get_opacity(params)[:, 0]

    grad_hit = (grads >= max_grad) & alive
    n_alive = alive.sum()
    ratio = grad_hit.sum() / n_alive.clamp_min(1)
    # Q = quantile(grads_abs, 1 - ratio) over alive points (:803-804)
    sorted_abs = torch.sort(torch.where(alive, grads_abs, float("inf"))).values
    q_pos = torch.clamp((1.0 - ratio) * (n_alive.to(torch.float32) - 1), 0, cap - 1)
    lo, hi = torch.floor(q_pos).long(), torch.ceil(q_pos).long()
    q_val = sorted_abs[lo] + (q_pos - lo) * (sorted_abs[hi] - sorted_abs[lo])
    q_val = torch.where(torch.isfinite(q_val), q_val, float("inf"))

    small = max_scale <= percent_dense * extent
    clone_sel = grad_hit & small
    split_sel = (grad_hit & ~small) | ((grads_abs >= q_val) & alive)
    # prune non-finite params too (gsjax: NaN slots corrupt densify stats)
    finite = torch.isfinite(params.xyz).all(1) & torch.isfinite(scaling).all(1) & \
        torch.isfinite(opac)
    opac_keep = (opac >= min_opacity) & finite
    survive = alive & ~split_sel & opac_keep

    if noise is None:
        noise = torch.randn((3, cap, 3), generator=generator, device=dev)
    rot = to_rotation_matrix(params.rotation / torch.linalg.norm(
        params.rotation, dim=-1, keepdim=True).clamp_min(1e-12))
    sample_xyz = lambda eps: params.xyz + (rot * (eps * scaling)[:, None, :]).sum(-1)
    split_scaling = torch.log((scaling / (0.8 * 2)).clamp_min(1e-12))
    cand_masks = [clone_sel & opac_keep, split_sel & opac_keep, split_sel & opac_keep]
    cand_vals = [dict(xyz=sample_xyz(noise[0])),
                 dict(xyz=sample_xyz(noise[1]), scaling=split_scaling),
                 dict(xyz=sample_xyz(noise[2]), scaling=split_scaling)]

    old = {k: getattr(params, k).detach().clone() for k in PARAM_FIELDS}
    free_slots = torch.nonzero(~survive)[:, 0]      # dead slots, ascending
    new_alive = survive.clone()
    offset = dropped = 0
    for mask, vals in zip(cand_masks, cand_vals):
        # candidate i of this kind takes free slot offset + i, if any is left
        parents = torch.nonzero(mask)[:, 0]
        take = min(len(parents), max(len(free_slots) - offset, 0))
        dropped += len(parents) - take
        slots = free_slots[offset:offset + take]
        for k in PARAM_FIELDS:
            getattr(params, k)[slots] = vals.get(k, old[k])[parents[:take]]
            adam.mu[k][slots] = 0.0
            adam.nu[k][slots] = 0.0
        new_alive[slots] = True
        offset += len(parents)

    zero = torch.zeros(cap, device=dev)
    aux = GaussianAux(alive=new_alive, filter_3d=aux.filter_3d, grad_accum=zero,
                      grad_accum_abs=zero.clone(), denom=zero.clone(),
                      max_radii=torch.zeros(cap, dtype=torch.int32, device=dev))
    stats = dict(n_alive=int(new_alive.sum()), n_cloned=int(cand_masks[0].sum()),
                 n_split=int(cand_masks[1].sum()), n_pruned=int((alive & ~opac_keep).sum()),
                 n_dropped=int(dropped))
    return params, aux, adam, stats


@torch.no_grad()
def grow_capacity(params: GaussianParams, aux: GaussianAux, adam: AdamState,
                  new_capacity: int) -> tuple[GaussianParams, GaussianAux, AdamState]:
    """Pad every per-gaussian tensor to `new_capacity` slots (dead, identity
    quaternions, zero moments)."""
    old = params.capacity
    assert new_capacity >= old

    def pad(x):
        return torch.cat([x, x.new_zeros((new_capacity - old,) + x.shape[1:])])

    leaves = {k: pad(getattr(params, k).detach()) for k in PARAM_FIELDS}
    leaves["rotation"][old:, 0] = 1.0
    aux = GaussianAux(**{k: pad(getattr(aux, k)) for k in AUX_FIELDS})
    adam = AdamState(mu={k: pad(v) for k, v in adam.mu.items()},
                     nu={k: pad(v) for k, v in adam.nu.items()}, count=adam.count)
    return GaussianParams(**leaves), aux, adam
