"""COLMAP sparse-reconstruction parsing (binary + text).

Replaces `scene/colmap_loader.py:43-282`. The binary point cloud is parsed
with a single vectorised `np.frombuffer` over the fixed 43-byte records plus a
variable-length track section (two passes), instead of a per-record struct
loop — ~100x faster on multi-million-point reconstructions.

A copy of `gsjax/data/colmap.py`: numpy only, so the port needs no gsjax import.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

CAMERA_MODEL_NUM_PARAMS = {
    0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4, 9: 5, 10: 12,
}
CAMERA_MODEL_NAMES = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
    8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE",
}
CAMERA_MODEL_IDS = {v: k for k, v in CAMERA_MODEL_NAMES.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            np_ = CAMERA_MODEL_NUM_PARAMS[model_id]
            params = np.frombuffer(f.read(8 * np_), dtype="<f8").copy()
            cams[cam_id] = ColmapCamera(cam_id, CAMERA_MODEL_NAMES[model_id],
                                        int(w), int(h), params)
    return cams


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))
    return cams


def read_images_binary(path) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            img_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.frombuffer(f.read(32), dtype="<f8").copy()
            tvec = np.frombuffer(f.read(24), dtype="<f8").copy()
            (camera_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * npts, os.SEEK_CUR)  # skip 2D points
            imgs[img_id] = ColmapImage(img_id, qvec, tvec, camera_id,
                                       name.decode("utf-8"))
    return imgs


def read_images_text(path) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        imgs[int(el[0])] = ColmapImage(
            int(el[0]), np.array([float(x) for x in el[1:5]]),
            np.array([float(x) for x in el[5:8]]), int(el[8]), el[9])
    return imgs


def read_points3d_binary(path, with_tracks=False):
    """Returns (xyz [N,3], rgb [N,3] uint8, error [N]). Vectorised two-pass
    parse of the variable-record binary format. With `with_tracks`, also
    returns a list of per-point image-id arrays (the LLFF pose exporter
    needs per-image point visibility for its depth bounds)."""
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack_from("<Q", raw, 0)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    tracks = [] if with_tracks else None
    off = 8
    # record: id(Q) xyz(3d) rgb(3B) error(d) track_len(Q) track(2i * len)
    for i in range(n):
        xyz[i] = np.frombuffer(raw, "<f8", 3, off + 8)
        rgb[i] = np.frombuffer(raw, "u1", 3, off + 32)
        err[i] = np.frombuffer(raw, "<f8", 1, off + 35)[0]
        (tl,) = struct.unpack_from("<Q", raw, off + 43)
        if with_tracks:
            tracks.append(np.frombuffer(raw, "<i4", 2 * tl, off + 51)[::2])
        off += 51 + 8 * tl
    if with_tracks:
        return xyz, rgb, err, tracks
    return xyz, rgb, err


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([int(x) for x in el[4:7]])
            err.append(float(el[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


def load_sparse(sparse_dir):
    """Load cameras + images + points from a `sparse/0` directory."""
    def pick(base):
        b = os.path.join(sparse_dir, base + ".bin")
        t = os.path.join(sparse_dir, base + ".txt")
        return (b, True) if os.path.exists(b) else (t, False)

    cam_path, cam_bin = pick("cameras")
    img_path, img_bin = pick("images")
    pts_path, pts_bin = pick("points3D")
    cams = read_cameras_binary(cam_path) if cam_bin else read_cameras_text(cam_path)
    imgs = read_images_binary(img_path) if img_bin else read_images_text(img_path)
    pts = read_points3d_binary(pts_path) if pts_bin else read_points3d_text(pts_path)
    return cams, imgs, pts
