"""Consistent synthetic datasets: views RENDERED from a known gaussian set.

The part of `gsjax/data/synth.py` the port needs: the blob scene
(`make_gaussians`) on a camera arc (`arc_pose`), the sphere scene
(`sphere_gaussians`, a known surface for meshing) and the two-sphere scene
(`blobs_gaussians`, a known surface with occlusion, with its distance and
samples) on a full camera ring (`ring_pose`), copied unchanged; and two
writers that render through the port: `write_rendered_colmap` (a binary
COLMAP scene) and `write_rendered_blender` (a NeRF-synthetic scene). Both
write a photometrically consistent scene from a seed, so the CLIs and their
tests need no external dataset.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch


def _rotmat2qvec(R):
    """COLMAP (w,x,y,z) quaternion from a rotation matrix."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    w, v = np.linalg.eigh(K)
    q = v[[3, 0, 1, 2], np.argmax(w)]
    return -q if q[0] < 0 else q


def make_gaussians(n=250, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    means[:, 2] *= 0.4
    scales = rng.uniform(0.06, 0.16, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.7, 0.95, (n, 1)).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1.0, 1.5, (n, 3))
    return means, scales, quats, opac, shs


def sphere_gaussians(n=1500, seed=0, radius=1.0):
    """Flattened gaussians tangent to a unit sphere — a known surface.

    Each gaussian sits on the sphere, its two long axes tangent and the
    short axis along the outward normal (scale ratio ~8:1), the same regime
    PGSR's planarisation drives real scenes toward. Colour varies smoothly
    with the normal so NVS/NCC have gradient signal.
    """
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, (n, 3))
    nrm = v / np.linalg.norm(v, axis=1, keepdims=True)
    means = (radius * nrm).astype(np.float32)

    # tangent frame per point
    a = np.where(np.abs(nrm[:, 2:3]) < 0.9,
                 np.array([[0.0, 0.0, 1.0]]), np.array([[1.0, 0.0, 0.0]]))
    t1 = np.cross(nrm, a)
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(nrm, t1)
    # columns = principal axes (x,y tangent, z normal)
    rot = np.stack([t1, t2, nrm], axis=2)            # [n,3,3]
    quats = np.stack([_rotmat2qvec(r) for r in rot]).astype(np.float32)

    area = 4 * np.pi * radius**2 / n
    tang = np.sqrt(area) * 0.9
    scales = np.stack([
        np.full(n, tang), np.full(n, tang), np.full(n, tang / 8.0)],
        axis=1).astype(np.float32) * rng.uniform(0.8, 1.25, (n, 1))
    opac = rng.uniform(0.85, 0.98, (n, 1)).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    base = 0.5 + 0.45 * np.stack([nrm[:, 0], nrm[:, 1],
                                  np.abs(nrm[:, 2])], axis=1)
    shs[:, 0] = ((base - 0.5) / 0.282).astype(np.float32)
    return (means, scales, quats.astype(np.float32), opac, shs)


BLOBS_CENTERS = ((0.0, 0.0, 0.0), (1.5, 0.2, 0.5))
BLOBS_RADII = (1.0, 0.55)
BLOBS_BG_RADIUS = 6.0


def blobs_gaussians(n=2600, seed=0):
    """Harder golden scene: two disjoint spheres (the small one occludes the
    big one from part of the ring) plus a textured enclosing background
    sphere, with ANISOTROPIC tangent scales (up to ~4:1 in-plane) and
    high-frequency spatial colour — exercising occlusion boundaries,
    anisotropy and texture where the plain sphere scene is easy.

    Ground truth for chamfer is the union of the two foreground spheres
    (`blobs_surface_distance` / `blobs_surface_samples`); the background
    sphere is cropped away before evaluation (|v| <= 2.5)."""
    rng = np.random.default_rng(seed)
    parts = []
    n_fg = int(n * 0.75)
    counts = [int(n_fg * 0.72), n_fg - int(n_fg * 0.72), n - n_fg]
    radii = list(BLOBS_RADII) + [BLOBS_BG_RADIUS]
    centers = [np.asarray(c, np.float32) for c in BLOBS_CENTERS] + \
        [np.zeros(3, np.float32)]
    for (cnt, radius, center) in zip(counts, radii, centers):
        v = rng.normal(0, 1, (cnt, 3))
        nrm = v / np.linalg.norm(v, axis=1, keepdims=True)
        means = (radius * nrm + center).astype(np.float32)
        a = np.where(np.abs(nrm[:, 2:3]) < 0.9,
                     np.array([[0.0, 0.0, 1.0]]), np.array([[1.0, 0.0, 0.0]]))
        t1 = np.cross(nrm, a)
        t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
        t2 = np.cross(nrm, t1)
        rot = np.stack([t1, t2, nrm], axis=2)
        quats = np.stack([_rotmat2qvec(r) for r in rot]).astype(np.float32)
        area = 4 * np.pi * radius**2 / cnt
        tang = np.sqrt(area) * 0.9
        aniso = rng.uniform(0.5, 2.0, (cnt, 1))     # in-plane ratio up to 4:1
        scales = np.stack([
            np.full(cnt, tang) * aniso[:, 0],
            np.full(cnt, tang) / aniso[:, 0],
            np.full(cnt, tang / 8.0)], axis=1).astype(np.float32) \
            * rng.uniform(0.8, 1.25, (cnt, 1)).astype(np.float32)
        opac = rng.uniform(0.85, 0.98, (cnt, 1)).astype(np.float32)
        shs = np.zeros((cnt, 16, 3), np.float32)
        # high-frequency spatial texture (deterministic in world position)
        m = means
        base = 0.5 + 0.22 * np.stack([
            np.sin(5.1 * m[:, 0]) * np.cos(4.3 * m[:, 1]),
            np.sin(4.7 * m[:, 1] + 1.2) * np.cos(5.6 * m[:, 2]),
            np.sin(6.2 * m[:, 2] + 0.4) * np.cos(3.9 * m[:, 0])], axis=1)
        shs[:, 0] = ((base - 0.5) / 0.282).astype(np.float32)
        parts.append((means, scales, quats, opac, shs))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(5))


def blobs_surface_distance(verts):
    """Unsigned distance of each vertex to the union of the two foreground
    spheres."""
    d = np.full(len(verts), np.inf)
    for c, r in zip(BLOBS_CENTERS, BLOBS_RADII):
        d = np.minimum(d, np.abs(
            np.linalg.norm(verts - np.asarray(c), axis=1) - r))
    return d


def blobs_surface_samples(n=20000, seed=0):
    """Area-weighted uniform samples on the two foreground spheres."""
    rng = np.random.default_rng(seed)
    areas = np.asarray([r * r for r in BLOBS_RADII], np.float64)
    counts = (n * areas / areas.sum()).astype(int)
    out = []
    for (c, r, cnt) in zip(BLOBS_CENTERS, BLOBS_RADII, counts):
        s = rng.normal(0, 1, (cnt, 3))
        s /= np.linalg.norm(s, axis=1, keepdims=True)
        out.append(r * s + np.asarray(c))
    return np.concatenate(out)


def ring_pose(i, n, radius=3.2, height_amp=0.9, target=(0.0, 0.0, 0.0)):
    """Full 360-degree camera ring with alternating elevation: enough
    coverage that TSDF fusion closes the sphere."""
    ang = 2 * np.pi * i / n
    h = height_amp * np.sin(3.0 * ang)
    pos = np.array([radius * np.sin(ang), h, -radius * np.cos(ang)])
    fwd = np.asarray(target) - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])     # COLMAP y is down
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_w2c = np.stack([right, down, fwd])
    tvec = -r_w2c @ pos
    return r_w2c, tvec


def arc_pose(i, n, radius=3.5, target=(0.0, 0.0, 0.0)):
    """World->cam rotation (COLMAP row convention) + tvec for pose i."""
    ang = (i / max(n - 1, 1) - 0.5) * 0.9
    h = 0.3 * np.sin(2.1 * i)
    pos = np.array([radius * np.sin(ang), h, -radius * np.cos(ang)])
    fwd = np.asarray(target) - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])     # COLMAP y is down
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_w2c = np.stack([right, down, fwd])
    tvec = -r_w2c @ pos
    return r_w2c, tvec


def _render_views(g, poses, fovx, fovy, width, height, max_per_tile, device):
    """Yield (render [H, W, 3], alpha [H, W]) as numpy for each (world->cam
    R, t) of `poses`: gaussian tuple `g` at SH degree 0 over black, rendered
    on `device` (cuda unless asked for the CPU)."""
    from gsjax_torch import resolve_device
    from gsjax_torch.ops.raster import Camera, RasterConfig, render

    dev = resolve_device(device)
    cfg = RasterConfig(max_per_tile=max_per_tile, sh_degree=0, require_depth=False)
    args = tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in g)
    bg = torch.zeros(3, device=dev)
    for r_w2c, tvec in poses:
        cam = Camera.create(r_w2c.T, tvec, fovx, fovy, width, height, device=dev)
        with torch.no_grad():
            out = render(*args, cam, cfg, bg)
        yield out["render"].cpu().numpy(), out["alpha"].cpu().numpy().reshape(height, width)


def write_rendered_colmap(root, n_images=6, width=96, height=64,
                          n_gauss=250, seed=0, gaussians=None, pose_fn=None,
                          points_noise=0.0, max_per_tile=1 << 9, points_stride=3,
                          device: str | torch.device | None = None):
    """Render a known gaussian scene from an arc of poses and save it as a
    binary COLMAP dataset. Returns the gaussian tuple used.

    `gaussians` overrides the default blob scene (a 5-tuple as returned by
    make_gaussians or sphere_gaussians); `pose_fn(i, n)` overrides arc_pose. The sparse points
    (what training initialises from) are every `points_stride`-th gaussian
    centre with its DC colour; `points_noise` > 0 jitters them by
    normal(0, points_noise) from `default_rng(seed + 1)`, gsjax's stream, so
    that training does not start from the exact answer. Renders on `device`
    (cuda unless asked for the CPU)."""
    from PIL import Image

    sparse = os.path.join(root, "sparse", "0")
    imgdir = os.path.join(root, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(imgdir, exist_ok=True)
    fx = fy = 0.9 * width
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, width, height))   # PINHOLE
        f.write(np.array([fx, fy, width / 2, height / 2], "<f8").tobytes())

    g = make_gaussians(n_gauss, seed) if gaussians is None else gaussians
    if pose_fn is None:
        pose_fn = arc_pose
    means, scales, quats, opac, shs = g
    fovx = 2 * np.arctan(width / (2 * fx))
    fovy = 2 * np.arctan(height / (2 * fy))
    poses = [pose_fn(i, n_images) for i in range(n_images)]
    views = _render_views(g, poses, fovx, fovy, width, height, max_per_tile, device)

    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i, ((r_w2c, tvec), (rgb, _)) in enumerate(zip(poses, views)):
            img = np.clip(rgb, 0, 1)
            q = _rotmat2qvec(r_w2c)
            f.write(struct.pack("<i", i + 1))
            f.write(q.astype("<f8").tobytes())
            f.write(tvec.astype("<f8").tobytes())
            f.write(struct.pack("<i", 1))
            f.write(f"img_{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(imgdir, f"img_{i:03d}.png"))

    sub = means[::points_stride]
    if points_noise > 0:
        sub = sub + np.random.default_rng(seed + 1).normal(
            0, points_noise, sub.shape).astype(np.float32)
    cols = np.clip(shs[::points_stride, 0] * 0.282 + 0.5, 0, 1)
    rec = np.zeros(len(sub), np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track_len", "<u8"), ("track", "<i4", 4)]))
    rec["id"] = np.arange(len(sub))
    rec["xyz"] = sub
    rec["rgb"] = (cols * 255).astype("u1")
    rec["err"] = 0.5
    rec["track_len"] = 2
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(sub)))
        f.write(rec.tobytes())
    return g


def write_rendered_blender(root, n_train=6, n_test=2, width=96, height=64,
                           fovx=0.9, gaussians=None, pose_fn=None,
                           max_per_tile=1 << 9,
                           device: str | torch.device | None = None):
    """Render a known gaussian scene and save it as a NeRF-synthetic
    (Blender) dataset: `transforms_{train,test}.json` and RGBA PNGs under
    `train/` and `test/`. Returns the gaussian tuple used.

    Pose i of `pose_fn(i, n_train + n_test)` (COLMAP world->cam, default
    `ring_pose`) goes to the test split every (n / n_test)-th view, so the
    two splits interleave. Alpha is the render's alpha; the colour is the
    render over black divided by alpha, so the reader's composite over black
    gives the render back (to 8 bits) and over white the render on a white
    background. The frame's c2w is stored in Blender's axes (y up, z back),
    which the reader flips back. No `points3d.ply` is written: the reader
    then draws its own random points."""
    from PIL import Image

    from gsjax_torch.core.transforms import focal2fov, fov2focal

    g = make_gaussians(250, 0) if gaussians is None else gaussians
    pose_fn = ring_pose if pose_fn is None else pose_fn
    n = n_train + n_test
    test_ids = set(range(0, n, n // n_test)[:n_test]) if n_test else set()
    fovy = focal2fov(fov2focal(fovx, width), height)
    poses = [pose_fn(i, n) for i in range(n)]
    views = _render_views(g, poses, fovx, fovy, width, height, max_per_tile, device)
    frames = {"train": [], "test": []}
    for split in frames:
        os.makedirs(os.path.join(root, split), exist_ok=True)
    for i, ((r_w2c, tvec), (rgb, alpha)) in enumerate(zip(poses, views)):
        alpha = np.clip(alpha, 0, 1)
        straight = np.where(alpha[..., None] > 0,
                            rgb / np.maximum(alpha[..., None], 1e-12), 0.0)
        rgba = np.concatenate([np.clip(straight, 0, 1), alpha[..., None]], -1)
        split = "test" if i in test_ids else "train"
        name = f"{split}/r_{len(frames[split])}"
        Image.fromarray((rgba * 255 + 0.5).astype(np.uint8), "RGBA").save(
            os.path.join(root, name + ".png"))
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = r_w2c, tvec
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1                  # colmap -> blender axes
        frames[split].append({"file_path": f"./{name}",
                              "transform_matrix": c2w.tolist()})
    for split, fr in frames.items():
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(fovx), "frames": fr}, f, indent=1)
    return g


def write_synthetic_dtu(root, scan, train_centers, surface, scale, rot, trans,
                        res=1.0, margin=5.0, seed=0):
    """The official DTU evaluation files for a known surface, in the frame
    p -> scale * rot @ p + trans of the scene (DTU's millimetres): 64
    `Calibration/cal18/pos_*.txt` projection matrices whose first centres
    are `train_centers` in that frame (the rest seeded), `ObsMask{scan}_10.mat`
    all true over the surface's box grown by `margin` at `res`,
    `Plane{scan}.mat` below every surface point, and
    `Points/stl/stl{scan:03}_total.ply` = `surface` in that frame."""
    from scipy.io import savemat

    from gsjax_torch.data.ply import write_pointcloud

    sim = lambda p: scale * np.asarray(p, np.float64) @ np.asarray(rot).T + trans
    centers = sim(train_centers)
    rest = np.random.default_rng(seed).normal(0, scale, (64 - len(centers), 3))
    centers = np.concatenate([centers, rest + centers.mean(0)])
    cal = os.path.join(root, "Calibration", "cal18")
    obs = os.path.join(root, "ObsMask")
    stl = os.path.join(root, "Points", "stl")
    for d in (cal, obs, stl):
        os.makedirs(d, exist_ok=True)
    k = np.array([[2892.0, 0, 800], [0, 2892, 600], [0, 0, 1]])
    for i, c in enumerate(centers):
        np.savetxt(os.path.join(cal, f"pos_{i + 1:03d}.txt"),
                   k @ np.concatenate([np.eye(3), -c[:, None]], 1))
    pts = sim(surface)
    bb = np.stack([pts.min(0) - margin, pts.max(0) + margin])
    shape = tuple(int(x) for x in np.ceil((bb[1] - bb[0]) / res) + 1)
    savemat(os.path.join(obs, f"ObsMask{scan}_10.mat"),
            {"ObsMask": np.ones(shape, bool), "BB": bb, "Res": np.array([[res]])})
    savemat(os.path.join(obs, f"Plane{scan}.mat"),
            {"P": np.array([[0.0], [0.0], [1.0], [margin - pts[:, 2].min()]])})
    write_pointcloud(os.path.join(stl, f"stl{scan:03}_total.ply"), pts)


def write_trajectory_log(path, c2ws):
    """A Tanks-and-Temples `.log` trajectory: per camera a `i i 0` line and
    its 4x4 cam-to-world matrix."""
    with open(path, "w") as f:
        for i, m in enumerate(np.asarray(c2ws, np.float64)):
            f.write(f"{i} {i} 0\n")
            f.write("".join(" ".join(f"{x:.17g}" for x in row) + "\n" for row in m))


def write_synthetic_tnt(root, scene, surface, c2ws, lo, hi):
    """Tanks-and-Temples evaluation files for a known surface, in the
    scene's own frame: `<scene>.ply` = `surface`, an axis-aligned crop
    volume `<scene>.json` over [lo, hi], `<scene>_trans.txt` = identity and
    the ground-truth trajectory `<scene>.log` = `c2ws`."""
    from gsjax_torch.data.ply import write_pointcloud

    os.makedirs(root, exist_ok=True)
    write_pointcloud(os.path.join(root, f"{scene}.ply"), np.asarray(surface, np.float64))
    poly = [[lo[0], lo[1], 0.0], [hi[0], lo[1], 0.0], [hi[0], hi[1], 0.0],
            [lo[0], hi[1], 0.0]]
    with open(os.path.join(root, f"{scene}.json"), "w") as f:
        json.dump({"class_name": "SelectionPolygonVolume", "orthogonal_axis": "Z",
                   "axis_min": float(lo[2]), "axis_max": float(hi[2]),
                   "bounding_polygon": [[float(x) for x in p] for p in poly]}, f)
    np.savetxt(os.path.join(root, f"{scene}_trans.txt"), np.eye(4))
    write_trajectory_log(os.path.join(root, f"{scene}.log"), c2ws)
