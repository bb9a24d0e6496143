# Frozen copy of gsjax_torch/data/readers.py:build_nearest_view_graph at commit
# 95f6082, over (centres, rotations) arrays in place of the reader's views.
"""The neighbour graph training draws a multi-view neighbour from."""

from __future__ import annotations

import numpy as np


def nearest_view_graph(centers: np.ndarray, rotations: np.ndarray, max_angle=30.0,
                       min_dis=0.01, max_dis=1.5, multi_view_num=8) -> list[list[int]]:
    """Nearest-view selection by lexsort(angle, distance) with thresholds
    (scene/__init__.py:83-118): centers [V,3] camera centres, rotations
    [V,3,3] cam->world -> each view's neighbour ids."""
    rays = rotations @ np.array([0.0, 0.0, 1.0])
    rays = rays / np.maximum(np.linalg.norm(rays, axis=1, keepdims=True), 1e-12)
    diss = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    cosang = np.clip((rays[:, None] * rays[None]).sum(-1), -1, 1)
    angles = np.arccos(cosang) * 180 / 3.14159
    out = []
    for i in range(len(centers)):
        order = np.lexsort((angles[i], diss[i]))
        m = ((angles[i][order] < max_angle) & (diss[i][order] > min_dis)
             & (diss[i][order] < max_dis))
        out.append([int(s) for s in order[m][:multi_view_num]])
    return out
