"""ACMM/ACMH multi-view-stereo artifact readers (a copy of
`gsjax/utils/mvs.py`: numpy only).

The reference ships these for loading externally-computed MVS priors
(`utils/general_utils.py:137-242`: `readDepthDmb`, `readNormalDmb`,
`read_propagted_depth`, `load_pairs_relation`). The `.dmb` ("depth map
binary") format is the ACMM toolchain's dump: 4 little-endian int32s
(type, h, w, channels) followed by h*w*channels float32s.

Vectorised numpy re-implementation; errors raise instead of returning -1
(the reference's silent -1 sentinel propagates shape errors downstream).
"""

from __future__ import annotations

import os

import numpy as np


def read_dmb(path: str) -> np.ndarray:
    """Read a .dmb file -> [H, W] (1 channel) or [H, W, C] float32 array."""
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype="<i4", count=4)
        if head.size != 4:
            raise ValueError(f"{path}: truncated .dmb header")
        ftype, h, w, nb = (int(x) for x in head)
        if ftype != 1:
            raise ValueError(f"{path}: unsupported .dmb type {ftype}")
        data = np.fromfile(f, dtype="<f4", count=h * w * nb)
    if data.size != h * w * nb:
        raise ValueError(f"{path}: truncated .dmb payload")
    arr = data.reshape(h, w, nb)
    return arr[:, :, 0] if nb == 1 else arr


def write_dmb(path: str, arr: np.ndarray) -> None:
    """Inverse of read_dmb (used by tests; ACMM type tag is always 1)."""
    a = np.asarray(arr, np.float32)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, nb = a.shape
    with open(path, "wb") as f:
        np.array([1, h, w, nb], "<i4").tofile(f)
        a.astype("<f4").tofile(f)


def read_depth_dmb(path: str) -> np.ndarray:
    """[H, W] depth (general_utils.py:163-189)."""
    d = read_dmb(path)
    if d.ndim != 2:
        d = d[:, :, 0]
    return d


def read_normal_dmb(path: str) -> np.ndarray:
    """[H, W, 3] normals (general_utils.py:137-161); extra channels dropped."""
    n = read_dmb(path)
    if n.ndim == 2:
        n = np.repeat(n[:, :, None], 3, axis=2)
    return np.ascontiguousarray(n[:, :, :3])


def read_propagated_depth(path: str):
    """Load (depth, cost, normal) from an ACMM output dir, with the
    reference's cleanup rules (general_utils.py:191-205): invalid costs -> 2,
    depth clamped into (0, 300] with NaN/negatives -> 300."""
    cost = read_depth_dmb(os.path.join(path, "costs.dmb")).copy()
    cost[~np.isfinite(cost)] = 2
    cost[cost < 0] = 2

    depth = read_depth_dmb(os.path.join(path, "depths.dmb")).copy()
    depth[~np.isfinite(depth)] = 300
    depth[(depth < 0) | (depth > 300)] = 300

    normal = read_normal_dmb(os.path.join(path, "normals.dmb"))
    return depth, cost, normal


def load_pairs_relation(path: str):
    """Parse an MVS pair file into per-training-image neighbour id lists
    (general_utils.py:208-242). Keeps at most 4 positive-score neighbours per
    view, remapping every-8th (test) image ids out of the training indexing.
    """
    pairs_relation = []
    with open(path) as f:
        num_images = int(f.readline())
        for i in range(num_images):
            ref_image_id = int(f.readline())
            info = f.readline().split()
            n_src = int(info[0])
            info = info[1:]
            pairs = []
            for j in range(n_src):
                sid, score = int(info[2 * j]), float(info[2 * j + 1])
                if score <= 0.0 or sid % 8 == 0:
                    continue   # test split member or useless match
                pairs.append((sid // 8) * 7 + (sid % 8) - 1)
                if len(pairs) > 3:
                    break
            if ref_image_id % 8 != 0:
                pairs_relation.append(pairs)
    return pairs_relation
