"""Connected-component mesh cleanup and camera culling (a copy of
`gsjax/mesh/cluster.py`; numpy and scipy on the host, numpy in and out).

Replaces open3d's `cluster_connected_triangles`-based `post_process_mesh`
(mesh_extract.py:15-37): triangles are clustered by shared vertices; clusters
smaller than max(largest_kth, 50) triangles are removed. `cull_mesh` takes
the port's cameras and depth maps, which may be tensors on any device.
"""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def cluster_triangles(faces: np.ndarray, n_vertices: int):
    """Label faces by connected component (shared-vertex adjacency)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    f = np.asarray(faces)
    rows = np.arange(len(f)).repeat(3)
    cols = f.reshape(-1)
    # face-vertex incidence; faces sharing a vertex are connected via B B^T
    b = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                   shape=(len(f), n_vertices))
    # vertices sharing a face are connected; a face's component is its
    # first vertex's component.
    _, vlabels = connected_components(b.T @ b, directed=False)
    return vlabels[f[:, 0]]


def post_process_mesh(vertices: np.ndarray, faces: np.ndarray,
                      cluster_to_keep: int = 1):
    """Keep the `cluster_to_keep` largest connected components (min 50 tris),
    drop unreferenced vertices. Returns (vertices, faces)."""
    if len(faces) == 0:
        return vertices, faces
    labels = cluster_triangles(faces, len(vertices))
    counts = np.bincount(labels)
    thresh = max(np.sort(counts)[-min(cluster_to_keep, len(counts))], 50)
    keep = counts[labels] >= thresh
    faces = faces[keep]
    used = np.unique(faces.reshape(-1))
    remap = np.full(len(vertices), -1, np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[faces]


def cull_mesh(vertices: np.ndarray, faces: np.ndarray, views,
              depths=None, depth_grace: float = 1.05, min_views: int = 1):
    """Remove mesh faces not observed by any training camera
    (eval_tnt/cull_mesh.py protocol: frustum test + depth-occlusion test).

    The reference renders the mesh with pyrender for its occlusion depths;
    here the caller may pass the trained model's per-view median-depth maps
    (`depths`, same order as `views`) — a vertex counts as seen when it
    projects inside the image with positive depth and lies no deeper than
    `depth_grace` x the rendered depth at its pixel. Without `depths`, the
    test is frustum-only. Faces with fewer than `min_views` vertices seen
    anywhere are dropped; unreferenced vertices are compacted.
    Returns (vertices, faces).
    """
    if len(faces) == 0:
        return vertices, faces
    seen = np.zeros(len(vertices), bool)
    for i, v in enumerate(views):
        cam = v.camera if hasattr(v, "camera") else v
        wv = _np(cam.world_view)
        p = vertices @ wv[:3, :3].T + wv[:3, 3]
        z = p[:, 2]
        ok = z > 1e-4
        zs = np.where(ok, z, 1.0)
        px = p[:, 0] / zs * float(cam.fx) + float(cam.cx)
        py = p[:, 1] / zs * float(cam.fy) + float(cam.cy)
        ok &= (px >= 0) & (px <= cam.width - 1) & \
              (py >= 0) & (py <= cam.height - 1)
        if depths is not None:
            d = _np(depths[i])
            xi = np.clip(np.round(px).astype(int), 0, cam.width - 1)
            yi = np.clip(np.round(py).astype(int), 0, cam.height - 1)
            dref = d[yi, xi]
            ok &= (dref <= 0) | (z <= dref * depth_grace)
        seen |= ok
    keep_face = seen[faces].sum(axis=1) >= min_views
    faces = faces[keep_face]
    used = np.zeros(len(vertices), bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    return vertices[used], remap[faces]
