"""DTU chamfer evaluation (DTUeval-python port; a copy of `gsjax/eval/dtu.py`
with scipy's `cKDTree` in place of `sklearn.neighbors`).

Protocol matches `dtu_eval/eval.py:27-168`: sample extra points on triangles
at `downsample_density` spacing, greedy radius downsample, ObsMask + bounding
box filter, d2s / s2d nearest-neighbour distances truncated at max_dist 20,
ground-plane filter on the STL side; overall = mean(d2s, s2d).

Both KD-trees return exact Euclidean distances, and both count a neighbour at
exactly the radius (distance <= r), so the results equal gsjax's."""

from __future__ import annotations

import numpy as np


def sample_mesh_points(vertices, faces, thresh=0.2):
    """Vertices + extra points sampled on large triangles (eval.py:46-70),
    vectorised (no per-triangle multiprocessing)."""
    tri = vertices[faces]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    nz = area2 > 0
    v1, v2, tri0 = v1[nz], v2[nz], tri[nz, 0]
    l1, l2, area2 = l1[nz], l2[nz], area2[nz]
    thr = thresh * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(int)
    n2 = np.floor(l2 / thr).astype(int)

    pts = [vertices]
    # group triangles by (n1, n2) to vectorise the barycentric lattice
    key = n1.astype(np.int64) * 100000 + n2
    for k in np.unique(key):
        sel = key == k
        a, b = int(n1[sel][0]), int(n2[sel][0])
        if a == 0 and b == 0:
            continue
        u = np.arange(a + 1) / max(a, 1)
        w = np.arange(b + 1) / max(b, 1)
        uu, ww = np.meshgrid(u, w, indexing="ij")
        m = uu + ww <= 1.0 + 1e-9
        uu, ww = uu[m], ww[m]
        p = (tri0[sel][:, None, :] + uu[None, :, None] * v1[sel][:, None, :]
             + ww[None, :, None] * v2[sel][:, None, :])
        pts.append(p.reshape(-1, 3))
    return np.concatenate(pts, axis=0)


def radius_downsample(points, thresh=0.2, seed=0):
    """Greedy radius NMS (eval.py:82-93)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(points))
    pts = points[order]
    rnn = cKDTree(pts).query_ball_point(pts, r=thresh, workers=-1)
    mask = np.ones(len(pts), bool)
    for cur, idxs in enumerate(rnn):
        if mask[cur]:
            mask[idxs] = False
            mask[cur] = True
    return pts[mask]


def evaluate_mesh_chamfer(vertices, faces, scan: int, dataset_dir: str,
                          downsample_density=0.2, patch_size=60.0,
                          max_dist=20.0):
    """Full DTU protocol. Requires the official ObsMask/ + Points/stl/ files.
    Returns dict(mean_d2s, mean_s2d, overall)."""
    from scipy.io import loadmat
    from scipy.spatial import cKDTree

    from gsjax_torch.data.ply import read_pointcloud

    data_pcd = sample_mesh_points(vertices, faces, downsample_density)
    data_down = radius_downsample(data_pcd, downsample_density)

    obs = loadmat(f"{dataset_dir}/ObsMask/ObsMask{scan}_10.mat")
    obs_mask, bb, res = obs["ObsMask"], obs["BB"].astype(np.float32), obs["Res"]
    inbound = ((data_down >= bb[:1] - patch_size)
               & (data_down < bb[1:] + patch_size * 2)).sum(-1) == 3
    data_in = data_down[inbound]
    grid = np.around((data_in - bb[:1]) / res).astype(np.int32)
    gin = ((grid >= 0) & (grid < np.expand_dims(obs_mask.shape, 0))).sum(-1) == 3
    gi = grid[gin]
    in_obs = obs_mask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
    data_in_obs = data_in[gin][in_obs]

    stl, _, _ = read_pointcloud(f"{dataset_dir}/Points/stl/stl{scan:03}_total.ply")

    d_d2s, _ = cKDTree(stl).query(data_in_obs, k=1, workers=-1)
    mean_d2s = float(d_d2s[d_d2s < max_dist].mean())

    plane = loadmat(f"{dataset_dir}/ObsMask/Plane{scan}.mat")["P"]
    stl_hom = np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
    above = (plane.reshape(1, 4) * stl_hom).sum(-1) > 0
    d_s2d, _ = cKDTree(data_in).query(stl[above], k=1, workers=-1)
    mean_s2d = float(d_s2d[d_s2d < max_dist].mean())

    return dict(mean_d2s=mean_d2s, mean_s2d=mean_s2d,
                overall=(mean_d2s + mean_s2d) / 2)


# --- camera alignment (evaluate_dtu_mesh.py:17-77, 140-173) ------------------

def best_fit_transform(a, b):
    """Kabsch least-squares rigid alignment a -> b."""
    ca, cb = a.mean(0), b.mean(0)
    h = (a - ca).T @ (b - cb)
    u, _, vt = np.linalg.svd(h)
    r = vt.T @ u.T
    if np.linalg.det(r) < 0:
        vt[-1] *= -1
        r = vt.T @ u.T
    t = cb - r @ ca
    return r, t


def load_dtu_calibration_centers(dtu_path: str, n: int = 64):
    """Camera centres from the official Calibration/cal18/pos_*.txt
    projection matrices (decomposed without cv2)."""
    centers = []
    for i in range(1, n + 1):
        p = np.loadtxt(f"{dtu_path}/Calibration/cal18/pos_{i:03d}.txt",
                       dtype=np.float64)
        # centre = null space of the 3x4 projection
        _, _, vt = np.linalg.svd(p)
        c = vt[-1]
        centers.append(c[:3] / c[3])
    return np.array(centers)


def align_to_dtu(train_centers: np.ndarray, dtu_centers: np.ndarray):
    """Scale + rigid alignment of trained camera centres to the DTU
    calibration (evaluate_dtu_mesh.py:149-163). Returns (scale, R, t)."""
    gt = dtu_centers[: train_centers.shape[0]]
    s_pts = np.linalg.norm(train_centers - train_centers.mean(0), axis=1).mean()
    s_gt = np.linalg.norm(gt - gt.mean(0), axis=1).mean()
    scale = s_gt / s_pts
    r, t = best_fit_transform(train_centers * scale, gt)
    return scale, r, t
