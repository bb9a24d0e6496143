"""Marching tetrahedra (kaolin-style case tables) on torch tensors.

Port of `gsjax/mesh/tetra.py` (`utils/tetmesh.py:50-190`), on the caller's
device: tets whose 4 corners are all valid and have mixed SDF signs emit 1-2
triangles indexing unique sign-crossing edges; returns the crossing edges'
endpoint coords/sdfs/scales so the caller can run the alpha-field binary
search (mesh_extract_tetrahedra.py:143-163) before placing final vertices.
Unique edges are ordered by the int64 key e0 * N + e1 (e0 < e1), which is
the lexicographic order of gsjax's `np.unique(axis=0)`, so edges and faces
equal gsjax's.
"""

from __future__ import annotations

import torch

TRIANGLE_TABLE = (
    (-1, -1, -1, -1, -1, -1),
    (1, 0, 2, -1, -1, -1),
    (4, 0, 3, -1, -1, -1),
    (1, 4, 2, 1, 3, 4),
    (3, 1, 5, -1, -1, -1),
    (2, 3, 0, 2, 5, 3),
    (1, 4, 0, 1, 5, 4),
    (4, 2, 5, -1, -1, -1),
    (4, 5, 2, -1, -1, -1),
    (4, 1, 0, 4, 5, 1),
    (3, 2, 0, 3, 5, 2),
    (1, 3, 5, -1, -1, -1),
    (4, 1, 2, 4, 3, 1),
    (3, 0, 4, -1, -1, -1),
    (2, 0, 1, -1, -1, -1),
    (-1, -1, -1, -1, -1, -1),
)
NUM_TRIANGLES = (0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0)
BASE_TET_EDGES = (0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3)


def marching_tetrahedra(vertices: torch.Tensor, tets: torch.Tensor, sdf: torch.Tensor,
                        scales: torch.Tensor, valid: torch.Tensor):
    """Args: vertices [N,3], tets [T,4] int64, sdf [N], scales [N], valid [N]
    bool, on one device.

    Returns (edge_verts [E,2,3], edge_sdf [E,2], edge_scales [E,2],
             faces [F,3] int64 indexing edges, edge_ids [E,2] int64)."""
    dev = tets.device
    tri_table = torch.tensor(TRIANGLE_TABLE, dtype=torch.int64, device=dev)
    num_tri = torch.tensor(NUM_TRIANGLES, dtype=torch.int64, device=dev)
    base_edges = torch.tensor(BASE_TET_EDGES, dtype=torch.int64, device=dev)
    n = vertices.shape[0]

    occ = sdf > 0
    occ4 = occ[tets]
    occ_sum = occ4.sum(-1)
    ok = (occ_sum > 0) & (occ_sum < 4) & valid[tets].all(-1)
    tets_v = tets[ok]

    all_edges = torch.sort(tets_v[:, base_edges].reshape(-1, 2), dim=1).values
    keys, idx_map = torch.unique(all_edges[:, 0] * n + all_edges[:, 1], sorted=True,
                                 return_inverse=True)
    unique_edges = torch.stack([keys // n, keys % n], 1)
    cross = occ[unique_edges].sum(-1) == 1
    mapping = torch.full((unique_edges.shape[0],), -1, dtype=torch.int64, device=dev)
    mapping[cross] = torch.arange(int(cross.sum()), device=dev)
    idx_map = mapping[idx_map].reshape(-1, 6)
    edge_ids = unique_edges[cross]

    tetindex = (occ4[ok].to(torch.int64) << torch.arange(4, device=dev)).sum(-1)
    ntri = num_tri[tetindex]
    one, two = ntri == 1, ntri == 2
    f1 = torch.gather(idx_map[one], 1, tri_table[tetindex[one]][:, :3])
    f2 = torch.gather(idx_map[two], 1, tri_table[tetindex[two]][:, :6])
    faces = torch.cat([f1.reshape(-1, 3), f2.reshape(-1, 3)], 0)

    flat = edge_ids.reshape(-1)
    edge_verts = vertices[flat].reshape(-1, 2, 3)
    edge_sdf = sdf[flat].reshape(-1, 2)
    edge_scales = scales[flat].reshape(-1, 2)
    return edge_verts, edge_sdf, edge_scales, faces, edge_ids
