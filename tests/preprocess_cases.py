"""Cases of the preprocess VJP's support: which input-leaf elements its
gradient leaves as exact zeros, one case per branch of the twin
(`gsjax_torch/ops/raster/preprocess.py:preprocess_ref`) that cuts or keeps a
chain, plus dead rows and rows no cotangent reaches.

Adam's first update moves every element whose gradient is not exactly zero
by a whole learning rate, so a VJP has to reproduce the twin's zeros, not
only its values. `tests/test_torch_preprocess_support.py` holds the twin's
autograd to these expectations on the CPU; `chip_smoke.py`'s
`parity_preprocess` phase holds the kernel VJP (`csrc/preprocess_bwd.cu`) to
the same expectations and to the twin's zeros on the card. Imports neither
JAX nor gsjax.

Each case is a small batch on an identity camera (at the origin, looking
down +z, so that a view-space coordinate is the world one and a cut chain
shows as a zero in one component of `means3d`) with a cotangent on the
fields it names, and states, for some elements of its rows, whether the
gradient there is exactly zero. `rsigma`'s where (vb > 0) is found on a
flat gaussian seen edge-on, whose vb the twin's float32 sums take to zero or
below; vb itself is a quadratic form of a positive definite matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsjax_torch.ops.raster.camera import Camera
from gsjax_torch.ops.raster.config import RasterConfig
from gsjax_torch.ops.raster.preprocess import GRAD_FIELDS, INPUTS as LEAVES, preprocess_ref

W, H, FOVX, FOVY = 96, 64, 0.9, 0.7
BANDS, LOBES = 16, 3
LIMX = float(np.float32(1.3 * float(np.float32(np.tan(FOVX * 0.5)))))   # the twin's clamp


def camera(device="cpu") -> Camera:
    return Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), FOVX, FOVY,
                         W, H, device=device)


def _row(**kw):
    rng = np.random.default_rng(7)
    g = dict(means3d=[0.3, -0.2, 4.0], scales=[0.15, 0.08, 0.03],
             rotations=[0.9, 0.2, -0.3, 0.1], opacities=[0.7],
             shs=rng.normal(0, 0.3, (BANDS, 3)) + np.array([0.6, 0.4, 0.5]) * (
                 np.arange(BANDS)[:, None] == 0),
             sg_axis=rng.normal(0, 1, (LOBES, 3)), sg_sharpness=rng.uniform(1, 3, LOBES),
             sg_color=rng.normal(0, 0.3, (LOBES, 3)))
    g.update(kw)
    return {k: np.asarray(v, np.float32) for k, v in g.items()}


@dataclasses.dataclass
class Case:
    rows: list                 # per row: {leaf: values}
    cot: dict                  # field -> the rows (indices) that get a cotangent
    expect: list               # (row, leaf, element index in the row, zero?)
    cfg: dict = dataclasses.field(default_factory=dict)
    alive: list | None = None
    cols: dict = dataclasses.field(default_factory=dict)   # field -> its columns that get one


def _quat(m):
    """Rotation matrix -> wxyz quaternion (its largest-trace branch)."""
    w = np.sqrt(max(1e-12, 1 + m[0, 0] + m[1, 1] + m[2, 2])) / 2
    return [w, (m[2, 1] - m[1, 2]) / (4 * w), (m[0, 2] - m[2, 0]) / (4 * w),
            (m[1, 0] - m[0, 1]) / (4 * w)]


def _edge_on_row(device):
    """A flat gaussian seen edge-on whose vb the twin takes to <= 0 (its
    rsigma reads 0): wide in its plane, 1e-4 thin, the ray in its plane; the
    first of a seeded search by the twin on `device` (the CPU's sums and the
    card's round differently)."""
    rng = np.random.default_rng(11)
    rows = []
    for _ in range(256):
        p = np.array([rng.uniform(-0.8, 0.8), rng.uniform(-0.5, 0.5), rng.uniform(3, 6)])
        ray = p / np.linalg.norm(p)
        e1 = np.cross(ray, rng.normal(size=3))
        e1 /= np.linalg.norm(e1)
        n = np.cross(ray, e1)                 # the thin axis, normal to the ray
        m = np.stack([ray, e1, n], 1)
        if np.linalg.det(m) < 0:
            m[:, 1] *= -1
        rows.append(_row(means3d=p, scales=[2.0, 2.0, 1e-4], rotations=_quat(m)))
    out = preprocess_ref(*stack(rows, device), camera(device), RasterConfig(), None)
    hit = torch.nonzero(out.ray_plane[:, 3] == 0).flatten()
    if not len(hit):
        raise RuntimeError("no edge-on row with vb <= 0 in the search")
    return rows[int(hit[0])]


def cases(device="cpu") -> dict[str, Case]:
    needle = dict(means3d=[0.0, 0.0, 4.0], scales=[1e-4, 1e-4, 0.5], rotations=[1, 0, 0, 0])
    sh_neg = _row()["shs"].copy()
    sh_neg[0, 0] = -3.0                     # channel 0 clamped at 0
    c0 = np.float32(0.28209479177387814)
    dc = np.float32(-0.5 / c0)
    while np.float32(c0 * dc) != np.float32(-0.5):   # colour + 0.5 exactly 0
        dc = np.nextafter(dc, np.float32(0) if np.float32(c0 * dc) < -0.5 else np.float32(-1))
    sh_zero = _row()["shs"].copy()
    sh_zero[0, 0] = dc
    every = {k: [0] for k in GRAD_FIELDS}
    return {
        # u = clamp(x / z, -1.3 tan(fovx/2), ...): x reaches the conic only
        # through u; at the clamp's bound itself the gradient passes
        "u_clamped": Case([_row(means3d=[2.0 * LIMX * 4.0, 0.1, 4.0], scales=[1, 0.6, 0.3]),
                           _row(means3d=[0.5 * LIMX * 4.0, 0.1, 4.0], scales=[1, 0.6, 0.3])],
                          {"conic": [0, 1]},
                          [(0, "means3d", (0,), True), (0, "means3d", (1,), False),
                           (0, "means3d", (2,), False), (1, "means3d", (0,), False)]),
        "u_at_bound": Case([_row(means3d=[LIMX, 0.1, 1.0], scales=[0.3, 0.2, 0.1])],
                           {"conic": [0]}, [(0, "means3d", (0,), False)]),
        "v_clamped": Case([_row(means3d=[0.1, -3.0 * LIMX * 4.0, 4.0], scales=[1, 0.6, 0.3])],
                          {"conic": [0]},
                          [(0, "means3d", (1,), True), (0, "means3d", (0,), False)]),
        # tz_safe = where(z > near, z, 1): behind the near plane z reaches
        # the conic through nothing
        "behind_near_plane": Case([_row(means3d=[0.05, 0.02, 0.1])], {"conic": [0]},
                                  [(0, "means3d", (2,), True), (0, "means3d", (0,), False),
                                   (0, "means3d", (1,), False)]),
        # s_safe = clamp_min(s, 1e-12): the normal reads s only through it
        "scale_floor": Case([_row(scales=[0.15, 0.08, 1e-14])], {"normal": [0]},
                            [(0, "scales", (2,), True), (0, "scales", (0,), False),
                             (0, "scales", (1,), False)]),
        # det_raw and det_dil both at their 1e-6 floor (kernel_size 0): the
        # mip coefficient is 1 and the opacity's cotangent reaches nothing else
        "dets_at_floor": Case([_row(**needle)], {"opacity": [0]},
                              [(0, "opacities", (0,), False)]
                              + [(0, leaf, (j,), True) for leaf, n in
                                 (("means3d", 3), ("scales", 3), ("rotations", 4))
                                 for j in range(n)]),
        # det_raw at its floor, det_dil above it (kernel_size 0.3)
        "det_raw_at_floor": Case([_row(**needle)], {"opacity": [0]},
                                 [(0, "opacities", (0,), False), (0, "scales", (0,), False),
                                  (0, "scales", (1,), False)], cfg=dict(kernel_size=0.3)),
        # det_safe = where(det > 0, det, 1): a negative dilation makes det < 0;
        # the conic still reads the covariance directly
        "det_not_positive": Case([_row(means3d=[0.0, 0.0, 4.0], scales=[0.1, 0.02, 0.02],
                                       rotations=[1, 0, 0, 0])],
                                 {"conic": [0]},
                                 [(0, "scales", (0,), False), (0, "scales", (1,), False)],
                                 cfg=dict(kernel_size=-3.0)),
        # lam's clamp (a small round footprint) carries no gradient
        "lam_clamped": Case([_row(scales=[2e-3, 1.5e-3, 1e-3])], every,
                            [(0, "means3d", (j,), False) for j in range(3)]
                            + [(0, "scales", (j,), False) for j in range(3)]),
        # vb_safe = where(|vb| > 1e-20, vb, 1e-20): a gaussian 1e11 long
        # along the ray on the optical axis
        "vb_tiny": Case([_row(means3d=[0.0, 0.0, 4.0], scales=[0.05, 0.05, 1e11],
                              rotations=[1, 0, 0, 0])],
                        {"ray_plane": [0], "normal": [0]},
                        [(0, "means3d", (2,), False)]),
        # rsigma = where(vb > 0, sqrt(vb / len2), 0): its cotangent reaches
        # nothing where vb <= 0, everything where vb > 0
        "rsigma_cut": Case([_edge_on_row(device), _row()], {"ray_plane": [0, 1]},
                           [(r, leaf, (j,), r == 0) for r in (0, 1)
                            for leaf, n in (("means3d", 3), ("scales", 3), ("rotations", 4))
                            for j in range(n)], cols={"ray_plane": [3]}),
        # colour = clamp_min(sh + 0.5, 0) per channel: a clamped channel's
        # coefficients get nothing; at exactly 0 the gradient passes
        "color_clamped": Case([_row(shs=sh_neg)], {"color": [0]},
                              [(0, "shs", (b, 0), True) for b in range(BANDS)]
                              + [(0, "shs", (b, 1), False) for b in range(BANDS)]),
        "color_at_zero": Case([_row(shs=sh_zero)], {"color": [0]},
                              [(0, "shs", (0, 0), False)], cfg=dict(sh_degree=0)),
        # dirs = d / clamp_min(|d|, 1e-12): a gaussian at the camera centre
        # has dirs = 0, so the SH bands past the DC read a zero basis
        "at_camera_centre": Case([_row(means3d=[0.0, 0.0, 0.0])], {"color": [0]},
                                 [(0, "shs", (0, 0), False)]
                                 + [(0, "shs", (b, c), True) for b in (1, 2, 3)
                                    for c in range(3)], cfg=dict(sh_degree=1)),
        # depth = where(valid, |p_view|, inf): only the means, only if valid
        "depth_valid": Case([_row(), _row(means3d=[40.0, 0.0, 4.0])], {"depth": [0, 1]},
                            [(0, "means3d", (j,), False) for j in range(3)]
                            + [(r, leaf, (0,), True) for r in (0, 1)
                               for leaf in ("scales", "rotations", "opacities")]
                            + [(1, "means3d", (j,), True) for j in range(3)]),
        # dead rows (alive False) and alive rows no cotangent reaches
        "dead_and_unreached": Case([_row(), _row(), _row()], {k: [0] for k in GRAD_FIELDS},
                                   [(r, leaf, (0, 0) if leaf == "shs" else (0,), r != 0)
                                    for r in (0, 1, 2)
                                    for leaf in ("means3d", "scales", "rotations",
                                                 "opacities", "shs")],
                                   alive=[True, True, False]),
        # SH bands past the degree and SG lobes past the active count
        "past_degree": Case([_row()], {"color": [0]},
                            [(0, "shs", (b, 0), b >= 4) for b in range(BANDS)]
                            + [(0, leaf, (g,) if leaf == "sg_sharpness" else (g, 0), g >= 2)
                               for g in range(LOBES)
                               for leaf in ("sg_axis", "sg_sharpness", "sg_color")],
                            cfg=dict(sh_degree=1, sg_degree=2)),
    }


def stack(rows, device="cpu"):
    """Rows -> the eight input tensors of `preprocess`."""
    return tuple(torch.as_tensor(np.stack([r[k] for r in rows]), device=device)
                 for k in LEAVES)


def build(case: Case, device="cpu"):
    """(inputs, camera, cfg, alive, cotangents in GRAD_FIELDS order): seeded
    cotangents of magnitude 0.5-1.5 on the named fields of the named rows."""
    cfg = RasterConfig(**{"sh_degree": 3, "sg_degree": 0, "kernel_size": 0.0, **case.cfg})
    inputs = stack(case.rows, device)
    if cfg.sg_degree == 0:
        inputs = inputs[:5] + (None, None, None)
    n = len(case.rows)
    rng = np.random.default_rng(3)
    cots = []
    for k, w in GRAD_FIELDS.items():
        c = np.zeros((n, w), np.float32)
        for r in case.cot.get(k, []):
            keep = case.cols.get(k, list(range(w)))
            c[r, keep] = (rng.uniform(0.5, 1.5, w) * rng.choice([-1, 1], w))[keep]
        cots.append(torch.as_tensor(c[:, 0] if w == 1 else c, device=device))
    alive = None if case.alive is None else torch.as_tensor(case.alive, device=device)
    return inputs, camera(device), cfg, alive, cots


def failures(case: Case, grads) -> list[str]:
    """The expectations of `case` that `grads` (one per leaf, None where the
    leaf gets none) does not meet."""
    out = []
    for row, leaf, idx, zero in case.expect:
        g = grads[LEAVES.index(leaf)]
        v = 0.0 if g is None else float(g[(row,) + tuple(idx)])
        if (v == 0.0) != zero:
            out.append(f"{leaf}[{row}, {idx}] = {v!r}, expected {'zero' if zero else 'nonzero'}")
    return out
