"""Delaunay tetrahedralisation (a copy of `gsjax/mesh/delaunay.py`).

Replaces the reference's CGAL `tetra_triangulation` submodule
(src/triangulation.cpp:21-65) with Qhull via scipy, with gsjax's options. It
runs on the host, as in gsjax and the reference.
"""

from __future__ import annotations

import numpy as np


def triangulate(points: np.ndarray) -> np.ndarray:
    """[N,3] float -> [T,4] int32 tetrahedra indices."""
    from scipy.spatial import Delaunay

    tri = Delaunay(np.asarray(points, np.float64), qhull_options="Qbb Qc Qz Q12")
    return tri.simplices.astype(np.int32)
