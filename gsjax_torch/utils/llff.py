"""LLFF pose pipeline: COLMAP reconstruction -> `poses_bounds.npy` (a copy of
`gsjax/utils/llff.py` on the port's COLMAP parsers and COLMAP driver,
`gsjax_torch.convert`).

Re-implements the reference's vendored LLFF `imgs2poses` tooling
(`utils/pose_utils.py`: `load_colmap_data`, `save_poses`, `minify`,
`gen_poses`) on top of the package's own COLMAP parsers — vectorised over points
(the reference loops per point / per track in Python) and using PIL instead
of imageio/skimage for the image pyramid.

Output format (one row per image, sorted by image name):
    [ poses 3x5 row-major (R|t|hwf, LLFF [-u, r, -t] axis order) ,
      close_depth, inf_depth ]                              -> [N, 17]
"""

from __future__ import annotations

import os

import numpy as np

from gsjax_torch.data.colmap import (
    qvec2rotmat,
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)


def load_colmap_data(realdir: str):
    """COLMAP sparse/0 -> (poses [3,5,N] c2w+hwf, pts (xyz,tracks), perm).

    Mirrors pose_utils.py:10-53 including the LLFF axis swap
    [r,-u,t] -> [-u,r,-t] (performed columnwise on the c2w rotations).
    """
    sparse = os.path.join(realdir, "sparse", "0")
    cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    cam = cams[sorted(cams)[0]]
    hwf = np.array([cam.height, cam.width, cam.params[0]],
                   np.float64).reshape(3, 1)

    imgs = read_images_binary(os.path.join(sparse, "images.bin"))
    keys = list(imgs)                                    # insertion order
    names = [imgs[k].name for k in keys]
    perm = np.argsort(names)

    w2c = np.stack([
        np.concatenate([
            np.concatenate([qvec2rotmat(imgs[k].qvec),
                            np.asarray(imgs[k].tvec).reshape(3, 1)], axis=1),
            np.array([[0, 0, 0, 1.0]])], axis=0)
        for k in keys])                                  # [N,4,4]
    c2w = np.linalg.inv(w2c)
    poses = c2w[:, :3, :4].transpose(1, 2, 0)            # [3,4,N]
    poses = np.concatenate(
        [poses, np.tile(hwf[..., None], (1, 1, poses.shape[-1]))], axis=1)
    # [r,-u,t] -> [-u,r,-t]
    poses = np.concatenate([poses[:, 1:2], poses[:, 0:1], -poses[:, 2:3],
                            poses[:, 3:4], poses[:, 4:5]], axis=1)

    xyz, _rgb, _err, tracks = read_points3d_binary(
        os.path.join(sparse, "points3D.bin"), with_tracks=True)
    # image id -> dense column index (ids are 1-based but can be sparse)
    id_to_col = {imgs[k].id: i for i, k in enumerate(keys)}
    return poses, (xyz, tracks, id_to_col), perm


def save_poses(basedir: str, poses, pts, perm) -> np.ndarray:
    """Write poses_bounds.npy (pose_utils.py:55-88): per-image near/far from
    the 0.1/99.9 depth percentiles of that image's visible track points."""
    xyz, tracks, id_to_col = pts
    n_img = poses.shape[-1]
    vis = np.zeros((len(xyz), n_img), bool)
    for p_i, img_ids in enumerate(tracks):
        cols = [id_to_col[i] for i in np.unique(img_ids) if i in id_to_col]
        vis[p_i, cols] = True

    # depth of every point along every camera's forward (-t) axis
    zvals = np.sum(-(xyz[:, None, :].transpose(2, 0, 1) - poses[:3, 3:4, :])
                   * poses[:3, 2:3, :], axis=0)          # [P, N]

    rows = []
    for i in perm:
        zs = zvals[:, i][vis[:, i]]
        if zs.size == 0:
            close, far = 0.01, 100.0
        else:
            close, far = np.percentile(zs, 0.1), np.percentile(zs, 99.9)
        rows.append(np.concatenate([poses[..., i].ravel(), [close, far]]))
    arr = np.array(rows)
    np.save(os.path.join(basedir, "poses_bounds.npy"), arr)
    return arr


def minify(basedir: str, factors=(), resolutions=()) -> None:
    """Write images_{f} / images_{WxH} downsampled copies (pose_utils.py:
    82-133) using PIL antialiased resize instead of mogrify."""
    from PIL import Image

    imgdir = os.path.join(basedir, "images")
    names = sorted(f for f in os.listdir(imgdir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    targets = [(f"images_{f}", f) for f in factors] + \
              [(f"images_{r[1]}x{r[0]}", r) for r in resolutions]
    for dirname, spec in targets:
        outdir = os.path.join(basedir, dirname)
        if os.path.exists(outdir):
            continue
        os.makedirs(outdir)
        for name in names:
            img = Image.open(os.path.join(imgdir, name))
            if isinstance(spec, (int, float)):
                size = (round(img.width / spec), round(img.height / spec))
            else:
                size = (spec[1], spec[0])
            img.resize(size, Image.LANCZOS).save(os.path.join(outdir, name))


def gen_poses(basedir: str, match_type: str = "exhaustive",
              factors=None) -> bool:
    """imgs2poses driver (pose_utils.py:255-284): run COLMAP if the sparse
    model is missing, then export poses_bounds.npy (+ image pyramid)."""
    sparse = os.path.join(basedir, "sparse", "0")
    needed = {"cameras.bin", "images.bin", "points3D.bin"}
    have = set(os.listdir(sparse)) if os.path.exists(sparse) else set()
    if not needed <= have:
        from gsjax_torch.convert import run_colmap
        run_colmap(basedir, match_type)
    poses, pts, perm = load_colmap_data(basedir)
    save_poses(basedir, poses, pts, perm)
    if factors:
        minify(basedir, factors)
    return True
