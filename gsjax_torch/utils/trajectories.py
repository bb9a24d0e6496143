"""Novel-view camera trajectories for turntable/flythrough rendering (a copy
of `gsjax/utils/trajectories.py` on the port's `Camera`).

Equivalent of the reference's ellipse-path machinery
(utils/render_utils.py:127-282, itself from mip-NeRF 360): recentre the
capture poses, fit an ellipse around the scene's focus point, and emit a
smooth loop of look-at cameras. The path is numpy; its cameras are made on
the reference camera's device.
"""

from __future__ import annotations

import os

import numpy as np

from gsjax_torch.ops.raster.camera import Camera


def _viewmatrix(lookdir, up, position):
    """[4,4] cam-to-world with -z ... reference convention: z = lookdir."""
    z = lookdir / np.linalg.norm(lookdir)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, position
    return m


def focus_point(c2ws: np.ndarray) -> np.ndarray:
    """Least-squares point closest to all camera optical axes
    (render_utils.py focus_point_fn)."""
    directions = c2ws[:, :3, 2:3]
    origins = c2ws[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.squeeze(
        np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0))


def generate_ellipse_path(c2ws: np.ndarray, n_frames: int = 120,
                          z_variation: float = 0.0,
                          z_phase: float = 0.0) -> np.ndarray:
    """[N,4,4] cam-to-world poses on an ellipse through the capture ring
    (render_utils.py:127-179)."""
    center = focus_point(c2ws)
    offset = np.array([center[0], center[1], 0.0])
    sc = np.percentile(np.abs(c2ws[:, :3, 3] - offset), 90, axis=0)
    low, high = -sc + offset, sc + offset
    z_low = np.percentile(c2ws[:, :3, 3], 10, axis=0)
    z_high = np.percentile(c2ws[:, :3, 3], 90, axis=0)

    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)[:-1]
    positions = np.stack([
        low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
        low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
        z_variation * (z_low[2] + (z_high - z_low)[2]
                       * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
    ], -1)

    avg_up = c2ws[:, :3, 1].mean(0)
    avg_up = avg_up / np.linalg.norm(avg_up)
    ind = int(np.argmax(np.abs(avg_up)))
    up = np.eye(3)[ind] * np.sign(avg_up[ind])
    return np.stack([_viewmatrix(p - center, up, p) for p in positions])


def generate_path(cameras, n_frames: int = 240,
                  z_variation: float = 0.0) -> list[Camera]:
    """Ellipse-path Camera list matching the training cameras' intrinsics
    (render_utils.py generate_path), on the first camera's device."""
    c2ws = np.stack([np.linalg.inv(c.world_view.cpu().numpy())
                     for c in cameras])
    poses = generate_ellipse_path(c2ws, n_frames, z_variation)
    ref = cameras[0]
    fovx = 2.0 * np.arctan(float(ref.tan_fovx))
    fovy = 2.0 * np.arctan(float(ref.tan_fovy))
    out = []
    for c2w in poses:
        w2c = np.linalg.inv(c2w)
        # Camera.create expects COLMAP-style (R = cam->world rotation, T)
        out.append(Camera.create(w2c[:3, :3].T.astype(np.float32),
                                 w2c[:3, 3].astype(np.float32),
                                 fovx, fovy, ref.width, ref.height,
                                 device=ref.device))
    return out


def apply_depth_colormap(depth: np.ndarray, near=None, far=None) -> np.ndarray:
    """[H,W] depth -> [H,W,3] uint8 turbo-ish visualisation (vis_utils.py)."""
    valid = depth > 0
    if near is None:
        near = float(depth[valid].min()) if valid.any() else 0.0
    if far is None:
        far = float(depth[valid].max()) if valid.any() else 1.0
    t = np.clip((depth - near) / max(far - near, 1e-9), 0, 1)
    # simple 3-stop colormap (dark blue -> green -> yellow)
    r = np.clip(2 * t - 0.5, 0, 1)
    g = np.clip(2 * t, 0, 1) * (t < 0.75) + np.clip(4 - 4 * t, 0, 1) * (t >= 0.75)
    b = np.clip(1 - 2 * t, 0, 1)
    img = np.stack([r, g, b], -1)
    img[~valid] = 0
    return (img * 255).astype(np.uint8)


def save_img_u8(img, path):
    """[H,W,3] float [0,1] -> 8-bit PNG/JPG (render_utils.py:276-279)."""
    from PIL import Image

    Image.fromarray(
        (np.clip(np.asarray(img), 0, 1) * 255 + 0.5).astype(np.uint8)
    ).save(path)


def save_img_f32(depthmap, path):
    """[H,W] float32 -> TIFF (render_utils.py:282-285 saves .tiff via PIL)."""
    from PIL import Image

    Image.fromarray(np.asarray(depthmap, np.float32), mode="F").save(path)


def create_videos(base_dir, input_dir, out_name, num_frames=480, fps=30):
    """Stitch rendered frame trees into .mp4s (render_utils.py:210-273).

    `input_dir` is a render-set directory as written by render.py
    (subdirs `renders/`, `depth/`, `gt/` holding %05d.png frames); one
    <base_dir>/<out_name>_<kind>.mp4 is written per present kind with cv2
    (no ffmpeg binary needed). Raises ImportError where cv2 does not
    import."""
    import glob

    import cv2

    written = []
    for kind in ("renders", "depth", "gt"):
        frames = sorted(glob.glob(os.path.join(input_dir, kind, "*.png")))
        if not frames:
            continue
        frames = frames[:num_frames]
        first = cv2.imread(frames[0])
        h, w = first.shape[:2]
        path = os.path.join(base_dir, f"{out_name}_{kind}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        for f in frames:
            vw.write(cv2.imread(f))
        vw.release()
        written.append(path)
    return written
