"""PLY snapshots and training checkpoints of the model (port of
`gsjax/model/io.py`).

The attribute layout is the reference's (scene/gaussian_model.py:450-493) and
gsjax's: x,y,z, nx..nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*,
sg_axis_*, sg_sharpness_*, sg_color_*, filter_3D, so a file written by either
package loads in the other. f_rest is flattened channel-major:
f_rest_i = features_rest[:, i % M, i // M] for M = bands-1.

Checkpoints are `.npz` files with gsjax's keys (p_/mu_/nu_<param>,
a_<aux>, adam_count, iteration, x_<extra>), so one moves between the two
packages in both directions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gsjax_torch import resolve_device
from gsjax_torch.data.ply import read_ply, write_ply
from gsjax_torch.model.gaussians import (AUX_FIELDS, PARAM_FIELDS, AdamState,
                                         GaussianAux, GaussianParams,
                                         params_from_numpy)


def save_ply(path, params: GaussianParams, aux: GaussianAux):
    """Write the alive slots of the model."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    alive = aux.alive.detach().cpu().numpy()
    sel = lambda x: x.detach().cpu().numpy()[alive].astype(np.float32)

    xyz = sel(params.xyz)
    n = xyz.shape[0]
    cols = dict(x=xyz[:, 0], y=xyz[:, 1], z=xyz[:, 2],
                nx=np.zeros(n, np.float32), ny=np.zeros(n, np.float32),
                nz=np.zeros(n, np.float32))
    f_dc = sel(params.features_dc)       # [n,1,3]
    for i in range(3):
        cols[f"f_dc_{i}"] = f_dc[:, 0, i]
    f_rest = sel(params.features_rest)   # [n,M,3]
    m = f_rest.shape[1]
    for i in range(3 * m):
        cols[f"f_rest_{i}"] = f_rest[:, i % m, i // m]
    cols["opacity"] = sel(params.opacity)[:, 0]
    scal = sel(params.scaling)
    for i in range(3):
        cols[f"scale_{i}"] = scal[:, i]
    rot = sel(params.rotation)
    for i in range(4):
        cols[f"rot_{i}"] = rot[:, i]
    sg_axis = sel(params.sg_axis)        # [n,G,3]
    g = sg_axis.shape[1]
    for i in range(3 * g):
        cols[f"sg_axis_{i}"] = sg_axis[:, i // 3, i % 3]
    sg_sharp = sel(params.sg_sharpness)
    for i in range(g):
        cols[f"sg_sharpness_{i}"] = sg_sharp[:, i]
    sg_color = sel(params.sg_color)
    for i in range(3 * g):
        cols[f"sg_color_{i}"] = sg_color[:, i // 3, i % 3]
    cols["filter_3D"] = sel(aux.filter_3d)
    write_ply(path, cols)


def load_ply(path, capacity: int | None = None,
             device: str | torch.device | None = None
             ) -> tuple[GaussianParams, GaussianAux]:
    """-> (GaussianParams, GaussianAux) on `device` (cuda unless asked for
    the CPU), padded to `capacity` slots (default: the next power of two)."""
    dev = resolve_device(device)
    v = read_ply(path)
    n = len(v["x"])
    cap = capacity or max(1 << (n - 1).bit_length(), n)

    def pad(x, fill=0.0):
        x = np.asarray(x, np.float32)
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=dev)

    xyz = np.stack([v["x"], v["y"], v["z"]], 1)
    n_rest = len([k for k in v if k.startswith("f_rest_")])
    m = n_rest // 3
    f_rest = np.zeros((n, m, 3), np.float32)
    for i in range(n_rest):
        f_rest[:, i % m, i // m] = v[f"f_rest_{i}"]
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], 1)[:, None, :]
    g = len([k for k in v if k.startswith("sg_sharpness_")])
    g_eff = max(g, 1)
    sg_axis = np.zeros((n, g_eff, 3), np.float32)
    sg_sharp = np.zeros((n, g_eff), np.float32)
    sg_color = np.zeros((n, g_eff, 3), np.float32)
    for i in range(3 * g):
        sg_axis[:, i // 3, i % 3] = v[f"sg_axis_{i}"]
        sg_color[:, i // 3, i % 3] = v[f"sg_color_{i}"]
    for i in range(g):
        sg_sharp[:, i] = v[f"sg_sharpness_{i}"]
    scaling = np.stack([v[f"scale_{i}"] for i in range(3)], 1)
    rotation = np.stack([v[f"rot_{i}"] for i in range(4)], 1)
    rotation = pad(rotation)
    rotation[n:, 0] = 1.0                 # dead slots: identity quaternions

    params = GaussianParams(
        xyz=pad(xyz), features_dc=pad(f_dc), features_rest=pad(f_rest),
        opacity=pad(np.asarray(v["opacity"])[:, None]),
        scaling=pad(scaling), rotation=rotation,
        sg_axis=pad(sg_axis), sg_sharpness=pad(sg_sharp), sg_color=pad(sg_color))
    filt = np.asarray(v.get("filter_3D", np.zeros(n)), np.float32).reshape(-1)
    zeros = torch.zeros(cap, device=dev)
    aux = GaussianAux(
        alive=torch.arange(cap, device=dev) < n,
        filter_3d=pad(filt),
        grad_accum=zeros.clone(), grad_accum_abs=zeros.clone(),
        denom=zeros.clone(),
        max_radii=torch.zeros(cap, dtype=torch.int32, device=dev))
    return params, aux


def save_checkpoint(path, params: GaussianParams, aux: GaussianAux,
                    adam: AdamState, iteration: int, extra: dict | None = None):
    """Full training checkpoint (replaces torch.save(capture()),
    scene/gaussian_model.py:88-113)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np_ = lambda t: t.detach().cpu().numpy()
    arrs = {"iteration": np.asarray(iteration)}
    for k in PARAM_FIELDS:
        arrs[f"p_{k}"] = np_(getattr(params, k))
        arrs[f"mu_{k}"] = np_(adam.mu[k])
        arrs[f"nu_{k}"] = np_(adam.nu[k])
    for k in AUX_FIELDS:
        arrs[f"a_{k}"] = np_(getattr(aux, k))
    arrs["adam_count"] = np.asarray(adam.count, np.int32)
    for k, v in (extra or {}).items():
        arrs[f"x_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrs)


def load_checkpoint(path, device: str | torch.device | None = None):
    """-> (params, aux, adam, iteration, extra) on `device` (cuda unless
    asked for the CPU)."""
    dev = resolve_device(device)
    z = np.load(path)
    params, aux = params_from_numpy({k: z[f"p_{k}"] for k in PARAM_FIELDS},
                                    {k: z[f"a_{k}"] for k in AUX_FIELDS}, dev)
    moments = lambda pre: {k: torch.as_tensor(np.asarray(z[f"{pre}_{k}"], np.float32),
                                              device=dev) for k in PARAM_FIELDS}
    adam = AdamState(mu=moments("mu"), nu=moments("nu"), count=int(z["adam_count"]))
    extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    return params, aux, adam, int(z["iteration"]), extra
