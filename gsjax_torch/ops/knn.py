"""Initial-scale KNN: mean squared distance to the k nearest neighbours.

Port of `gsjax/ops/knn.py:mean_knn_dist2`, the `simple-knn` CUDA submodule's
job (`spatial.cu:15-26`), run once at model init
(`scene/gaussian_model.py:323`). Host-side and exact, with scipy's cKDTree:
gsjax runs its own ctypes KD-tree where it builds and this same cKDTree
otherwise; both are exact, so their results agree.
"""

from __future__ import annotations

import numpy as np


def mean_knn_dist2(points: np.ndarray, k: int = 3) -> np.ndarray:
    """[N,3] -> [N] float32 mean squared distance to the k nearest
    neighbours (the point itself excluded)."""
    from scipy.spatial import cKDTree

    pts = np.ascontiguousarray(points, dtype=np.float32)
    d, _ = cKDTree(pts).query(pts, k=k + 1, workers=-1)
    return np.mean(d[:, 1:] ** 2, axis=1).astype(np.float32)
