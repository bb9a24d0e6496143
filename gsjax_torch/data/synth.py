"""Consistent synthetic datasets: views RENDERED from a known gaussian set.

The part of `gsjax/data/synth.py` the port needs: the blob scene
(`make_gaussians`) on a camera arc (`arc_pose`) and the sphere scene
(`sphere_gaussians`, a known surface for meshing) on a full camera ring
(`ring_pose`), copied unchanged, and `write_rendered_colmap`, which renders
through the port. It writes a photometrically consistent binary COLMAP scene
from a seed, so the CLIs and their tests need no external dataset.
"""

from __future__ import annotations

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


def write_rendered_colmap(root, n_images=6, width=96, height=64,
                          n_gauss=250, seed=0, gaussians=None, pose_fn=None,
                          max_per_tile=1 << 9, points_stride=3,
                          device: str | torch.device | None = None):
    """Render a known gaussian scene from an arc of poses and save it as a
    binary COLMAP dataset. Returns the gaussian tuple used.

    `gaussians` overrides the default blob scene (a 5-tuple as returned by
    make_gaussians or sphere_gaussians); `pose_fn(i, n)` overrides arc_pose. The sparse points
    (what training initialises from) are every `points_stride`-th gaussian
    centre with its DC colour. Renders on `device` (cuda unless asked for
    the CPU)."""
    from PIL import Image

    from gsjax_torch import resolve_device
    from gsjax_torch.ops.raster import Camera, RasterConfig, render

    dev = resolve_device(device)
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
    cfg = RasterConfig(max_per_tile=max_per_tile, sh_degree=0, require_depth=False)
    args = tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in g)
    bg = torch.zeros(3, device=dev)

    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in range(n_images):
            r_w2c, tvec = pose_fn(i, n_images)
            cam = Camera.create(r_w2c.T, tvec, fovx, fovy, width, height,
                                device=dev)
            with torch.no_grad():
                out = render(*args, cam, cfg, bg)
            img = np.clip(out["render"].cpu().numpy(), 0, 1)
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
