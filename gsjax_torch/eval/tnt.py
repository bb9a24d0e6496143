"""Tanks-and-Temples F1 evaluation (a copy of `gsjax/eval/tnt.py` with
scipy's `cKDTree` in place of `sklearn.neighbors`; matplotlib, for the
figure only, is imported where the figure is drawn).

Port of the `eval_tnt/` toolkit protocol (evaluation.py:60-171, config.py,
registration.py:66-196): align the reconstruction to the ground-truth frame
via camera-trajectory similarity (Umeyama) + ICP refinement, crop both clouds
to the official bounding volume, voxel-downsample at tau, and report
precision/recall/F1 at the per-scene tau. open3d is replaced by in-house
numpy/scipy equivalents (voxel downsample, polygon crop volume, point-to-point
ICP)."""

from __future__ import annotations

import json
import os

import numpy as np

SCENES_TAU = {
    "Barn": 0.01, "Caterpillar": 0.005, "Church": 0.025, "Courthouse": 0.025,
    "Ignatius": 0.003, "Meetingroom": 0.01, "Truck": 0.005,
}


def read_trajectory_log(path):
    """.log format: blocks of `i j k` + 4x4 matrix -> [N,4,4] cam-to-world."""
    mats = []
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    for i in range(0, len(lines), 5):
        m = np.array([[float(x) for x in lines[i + 1 + r].split()]
                      for r in range(4)])
        mats.append(m)
    return np.stack(mats)


def read_alignment_transform(path):
    """<scene>_trans.txt: a 4x4 transform."""
    return np.loadtxt(path).reshape(4, 4)


class CropVolume:
    """SelectionPolygonVolume equivalent (json with orthogonal_axis,
    axis_min/max, bounding_polygon)."""

    def __init__(self, path):
        with open(path) as f:
            d = json.load(f)
        axis = d["orthogonal_axis"].lower()
        self.axis = {"x": 0, "y": 1, "z": 2}[axis]
        self.amin = d["axis_min"]
        self.amax = d["axis_max"]
        poly = np.asarray(d["bounding_polygon"], np.float64)
        dims = [i for i in range(3) if i != self.axis]
        self.poly2d = poly[:, dims]
        self.dims = dims

    def crop(self, pts):
        m = (pts[:, self.axis] >= self.amin) & (pts[:, self.axis] <= self.amax)
        x = pts[:, self.dims[0]]
        y = pts[:, self.dims[1]]
        inside = np.zeros(len(pts), bool)
        px, py = self.poly2d[:, 0], self.poly2d[:, 1]
        n = len(px)
        j = n - 1
        for i in range(n):
            cond = ((py[i] > y) != (py[j] > y)) & (
                x < (px[j] - px[i]) * (y - py[i]) / (py[j] - py[i] + 1e-30) + px[i])
            inside ^= cond
            j = i
        return pts[m & inside]


def voxel_downsample(points, voxel):
    """Mean of points per voxel."""
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv, points)
    return sums / counts[:, None]


def umeyama(src, dst, with_scale=True):
    """Similarity transform src->dst. Returns (scale, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    u, s, vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2, 2] = -1
    r = u @ sgn @ vt
    scale = float(np.sum(s * np.diag(sgn)) / np.mean(np.sum(sc ** 2, axis=1))) \
        if with_scale else 1.0
    t = mu_d - scale * r @ mu_s
    return scale, r, t


def icp_point2point(src, dst, init=np.eye(4), max_iter=20, max_dist=0.05,
                    sample=200_000, seed=0):
    """Simple point-to-point ICP refinement (registration_vanilla equivalent)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    if len(src) > sample:
        src = src[rng.choice(len(src), sample, replace=False)]
    if len(dst) > sample:
        dst = dst[rng.choice(len(dst), sample, replace=False)]
    tree = cKDTree(dst)
    T = init.copy()
    for _ in range(max_iter):
        sp = src @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(sp, k=1, workers=-1)
        m = d < max_dist
        if m.sum() < 10:
            break
        r, t = _kabsch(sp[m], dst[idx[m]])
        delta = np.eye(4)
        delta[:3, :3] = r
        delta[:3, 3] = t
        T = delta @ T
        if np.abs(delta - np.eye(4)).max() < 1e-7:
            break
    return T


def _kabsch(a, b):
    ca, cb = a.mean(0), b.mean(0)
    h = (a - ca).T @ (b - cb)
    u, _, vt = np.linalg.svd(h)
    r = vt.T @ u.T
    if np.linalg.det(r) < 0:
        vt[-1] *= -1
        r = vt.T @ u.T
    return r, cb - r @ ca


def f1_score(source, target, tau, crop: CropVolume | None = None,
             transform=np.eye(4)):
    """precision/recall/F1 at tau after crop + voxel downsample at tau."""
    from scipy.spatial import cKDTree

    s = source @ transform[:3, :3].T + transform[:3, 3]
    t = target
    if crop is not None:
        s = crop.crop(s)
        t = crop.crop(t)
    s = voxel_downsample(s, tau)
    t = voxel_downsample(t, tau)
    d1, _ = cKDTree(t).query(s, k=1, workers=-1)
    d2, _ = cKDTree(s).query(t, k=1, workers=-1)
    precision = float((d1 < tau).mean()) * 100
    recall = float((d2 < tau).mean()) * 100
    f = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return dict(precision=precision, recall=recall, f1=f), d1, d2


def precision_recall_curves(d1, d2, tau, n_bins=100):
    """Cumulative precision/recall over thresholds [0, 3*tau] (the
    reference's EvaluateHisto histogram protocol, evaluation.py:9-57).
    Returns (thresholds, precision%, recall%, f1%)."""
    th = np.linspace(0, 3 * tau, n_bins + 1)[1:]
    prec = (d1[:, None] < th[None, :]).mean(axis=0) * 100
    rec = (d2[:, None] < th[None, :]).mean(axis=0) * 100
    denom = np.maximum(prec + rec, 1e-9)
    f1 = 2 * prec * rec / denom
    return th, prec, rec, f1


def plot_precision_recall(d1, d2, tau, scene_name, out_dir):
    """Write the reference's F-score curve figure (plot.py:30-110):
    precision/recall/F1 vs threshold with the scene tau marked."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    th, prec, rec, f1 = precision_recall_curves(d1, d2, tau)
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(th, prec, label="precision")
    ax.plot(th, rec, label="recall")
    ax.plot(th, f1, label="F1")
    ax.axvline(tau, ls="--", c="gray", label=f"tau={tau:g}")
    ax.set_xlabel("distance threshold [scene units]")
    ax.set_ylabel("%")
    ax.set_title(f"{scene_name}: precision/recall vs threshold")
    ax.legend()
    path = os.path.join(out_dir, f"{scene_name}_prf_curve.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def run_tnt_evaluation(recon_vertices, recon_faces, dataset_dir, scene_name,
                       traj_log_path, out_dir=None, plot=True):
    """Full TnT pipeline: trajectory alignment -> ICP -> crop -> F1.

    dataset_dir must contain <scene>.ply (GT points), <scene>.json (crop),
    <scene>_trans.txt (GT trajectory transform), <scene>.log (GT
    trajectory). With `out_dir`, results.json is written there, then, with
    `plot`, the precision/recall figure (which needs matplotlib)."""
    from gsjax_torch.data.ply import read_pointcloud
    from gsjax_torch.eval.dtu import sample_mesh_points

    tau = SCENES_TAU.get(scene_name, 0.01)
    gt_points, _, _ = read_pointcloud(os.path.join(dataset_dir, f"{scene_name}.ply"))
    crop = CropVolume(os.path.join(dataset_dir, f"{scene_name}.json"))
    gt_trans = read_alignment_transform(
        os.path.join(dataset_dir, f"{scene_name}_trans.txt"))
    traj = read_trajectory_log(traj_log_path)
    traj_centers = traj[:, :3, 3]
    gt_traj = read_trajectory_log(os.path.join(dataset_dir, f"{scene_name}.log"))
    gt_centers = (gt_traj[:, :3, 3] @ gt_trans[:3, :3].T) + gt_trans[:3, 3]

    n = min(len(traj_centers), len(gt_centers))
    scale, r, t = umeyama(traj_centers[:n], gt_centers[:n])
    init = np.eye(4)
    init[:3, :3] = scale * r
    init[:3, 3] = t

    # sample recon surface (vertices + face-centre style sampling, run.py:95-110)
    pts = sample_mesh_points(recon_vertices, recon_faces, thresh=tau)
    pts_init = pts @ init[:3, :3].T + init[:3, 3]
    refine = icp_point2point(pts_init, gt_points, max_dist=tau * 10)
    total = refine @ init

    res, d1, d2 = f1_score(pts, gt_points, tau, crop, total)
    res["tau"] = tau
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(res, f, indent=2)
        if plot:
            plot_precision_recall(d1, d2, tau, scene_name, out_dir)
    return res
