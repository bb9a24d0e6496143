"""Scene readers: COLMAP and Blender (transforms_train.json) datasets (port
of `gsjax/data/readers.py`: `read_colmap_scene`, `read_blender_scene`,
`load_scene`, and the numpy-only `camera_to_json`, `write_scene_artifacts`
and `build_nearest_view_graph`, copied).

Replaces `scene/dataset_readers.py` (:202-341) and the resolution handling of
`utils/camera_utils.py:22-74`. Produces `SceneView` records holding numpy
images (channels-last, [0,1]) plus the port's `Camera` on the scene's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from gsjax_torch import resolve_device
from gsjax_torch.core.transforms import focal2fov, fov2focal
from gsjax_torch.data import colmap
from gsjax_torch.data.ply import read_pointcloud, write_pointcloud
from gsjax_torch.ops.raster.camera import Camera


@dataclasses.dataclass
class SceneView:
    uid: int
    image_name: str
    R: np.ndarray          # cam->world rotation
    T: np.ndarray          # world->cam translation
    fovx: float
    fovy: float
    image: np.ndarray      # [H,W,3] float32 in [0,1]
    mask: Optional[np.ndarray]  # [H,W] float32 or None
    width: int
    height: int
    device: torch.device = torch.device("cpu")
    nearest_ids: list = dataclasses.field(default_factory=list)

    _camera: Optional[Camera] = None
    _gray: Optional[np.ndarray] = None

    @property
    def camera(self) -> Camera:
        if self._camera is None:
            self._camera = Camera.create(self.R, self.T, self.fovx, self.fovy,
                                         self.width, self.height,
                                         device=self.device)
        return self._camera

    @property
    def gray(self) -> np.ndarray:
        """[H,W] luma of the unmasked image, for the NCC (scene/cameras.py:45)."""
        if self._gray is None:
            i = self.image
            self._gray = (0.299 * i[..., 0] + 0.587 * i[..., 1]
                          + 0.114 * i[..., 2]).astype(np.float32)
        return self._gray

    @property
    def camera_center(self) -> np.ndarray:
        return self.R @ (-self.T)  # c2w translation


@dataclasses.dataclass
class SceneInfo:
    points: np.ndarray
    colors: np.ndarray
    train_views: list
    test_views: list
    radius: float          # cameras_extent (getNerfppNorm)
    ply_path: str


def _resolve_resolution(width, height, resolution, scale=1.0):
    """utils/camera_utils.py:28-42: -1 caps the long side at 1600px; k>0
    downsamples by k."""
    if resolution in (-1, None):
        if width > 1600:
            gs = width / 1600
            return round(width / gs), round(height / gs)
        return width, height
    return round(width / (resolution * scale)), round(height / (resolution * scale))


def _load_image(path, size):
    from PIL import Image

    img = Image.open(path)
    if img.size != size:
        img = img.resize(size, Image.LANCZOS)
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    alpha = None
    if np.asarray(img).ndim == 3 and np.asarray(img).shape[-1] == 4:
        alpha = np.asarray(img, dtype=np.float32)[..., 3] / 255.0
    return np.clip(arr, 0, 1), alpha


def _nerfpp_norm(views):
    """Camera-extent radius (dataset_readers.py:getNerfppNorm :60-81)."""
    centers = np.stack([v.camera_center for v in views], axis=0)
    avg = centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(centers - avg, axis=1)
    return float(dist.max() * 1.1)


def read_colmap_scene(path, images_dir="images", masks_dir=None, eval_split=False,
                      resolution=-1, llffhold=8,
                      device: str | torch.device | None = None) -> SceneInfo:
    dev = resolve_device(device)
    cams, imgs, (xyz, rgb, _err) = colmap.load_sparse(os.path.join(path, "sparse", "0"))

    views = []
    for key in sorted(imgs.keys(), key=lambda k: imgs[k].name):
        extr = imgs[key]
        intr = cams[extr.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[0], intr.height)
        elif intr.model == "PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[1], intr.height)
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {intr.model}; undistort first "
                "(reference supports PINHOLE/SIMPLE_PINHOLE only, "
                "dataset_readers.py:142-153)")
        w, h = _resolve_resolution(intr.width, intr.height, resolution)
        img_path = os.path.join(path, images_dir, os.path.basename(extr.name))
        image, _alpha = _load_image(img_path, (w, h))
        mask = None
        if masks_dir:
            mpath = os.path.join(path, masks_dir, extr.name)
            if os.path.exists(mpath):
                m, _ = _load_image(mpath, (w, h))
                mask = m[..., 0]
        R = colmap.qvec2rotmat(extr.qvec).T
        views.append(SceneView(
            uid=len(views), image_name=os.path.basename(extr.name).split(".")[0],
            R=R.astype(np.float32), T=extr.tvec.astype(np.float32),
            fovx=float(fovx), fovy=float(fovy), image=image, mask=mask,
            width=w, height=h, device=dev))

    if eval_split:
        train = [v for i, v in enumerate(views) if i % llffhold != 0]
        test = [v for i, v in enumerate(views) if i % llffhold == 0]
    else:
        train, test = views, []
    for i, v in enumerate(train):
        v.uid = i
    ply_path = os.path.join(path, "sparse", "0", "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            write_pointcloud(ply_path, xyz, rgb)
        except OSError:
            pass
    return SceneInfo(points=xyz.astype(np.float32),
                     colors=(rgb.astype(np.float32) / 255.0),
                     train_views=train, test_views=test,
                     radius=_nerfpp_norm(train), ply_path=ply_path)


def read_blender_scene(path, white_background=False, eval_split=True,
                       resolution=-1, extension=".png",
                       device: str | torch.device | None = None) -> SceneInfo:
    """transforms_{train,test}.json reader (dataset_readers.py:257-334)."""
    dev = resolve_device(device)

    def read_split(fname):
        views = []
        with open(os.path.join(path, fname)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        for idx, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1          # blender->colmap axes
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            img_path = os.path.join(path, frame["file_path"] + extension)
            from PIL import Image
            with Image.open(img_path) as im:
                w0, h0 = im.size
            w, h = _resolve_resolution(w0, h0, resolution)
            image, alpha = _load_image(img_path, (w, h))
            if alpha is not None:
                bgc = 1.0 if white_background else 0.0
                image = image * alpha[..., None] + bgc * (1 - alpha[..., None])
            fovy = focal2fov(fov2focal(fovx, w), h)
            views.append(SceneView(
                uid=idx, image_name=os.path.basename(frame["file_path"]),
                R=R.astype(np.float32), T=T.astype(np.float32),
                fovx=float(fovx), fovy=float(fovy), image=image,
                mask=None, width=w, height=h, device=dev))
        return views

    train = read_split("transforms_train.json")
    test = read_split("transforms_test.json") if (
        eval_split and os.path.exists(os.path.join(path, "transforms_test.json"))) else []

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        pts, colors, _ = read_pointcloud(ply_path)
    else:
        # random init inside the synthetic bounds (dataset_readers.py:300-310)
        rng = np.random.default_rng(0)
        n = int(os.environ.get("GSJAX_BLENDER_INIT_POINTS", 100_000))
        pts = (rng.random((n, 3)).astype(np.float32) * 2.6 - 1.3)
        colors = rng.random((n, 3)).astype(np.float32)
        try:
            write_pointcloud(ply_path, pts, (colors * 255).astype(np.uint8))
        except OSError:
            pass
    return SceneInfo(points=pts, colors=colors, train_views=train,
                     test_views=test, radius=_nerfpp_norm(train),
                     ply_path=ply_path)


def load_scene(source_path, images="images", masks=None, eval_split=False,
               resolution=-1, white_background=False,
               device: str | torch.device | None = None) -> SceneInfo:
    """Detect the dataset type (scene/__init__.py:50-54). A Blender scene
    always loads its test split, whatever `eval_split` says, as gsjax's
    does (ROADMAP queue C)."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene(source_path, images, masks, eval_split,
                                 resolution, device=device)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return read_blender_scene(source_path, white_background, True,
                                  resolution, device=device)
    raise ValueError(f"no COLMAP sparse/ or transforms_train.json under {source_path}")


def camera_to_json(idx, view: SceneView) -> dict:
    """Viewer-facing camera record (utils/camera_utils.py:76-96): c2w
    position/rotation plus pixel focal lengths, consumed by the SIBR
    ecosystem's cameras.json."""
    return {
        "id": idx,
        "img_name": view.image_name,
        "width": int(view.width),
        "height": int(view.height),
        "position": [float(x) for x in view.camera_center],
        "rotation": [[float(x) for x in row] for row in view.R],
        "fy": float(fov2focal(view.fovy, view.height)),
        "fx": float(fov2focal(view.fovx, view.width)),
    }


def write_scene_artifacts(model_path: str, info: SceneInfo) -> None:
    """Model-dir artifacts the reference Scene writes on a fresh run
    (scene/__init__.py:56-68): the initialisation point cloud copied to
    input.ply and all cameras (test first, then train) as cameras.json."""
    os.makedirs(model_path, exist_ok=True)
    try:
        with open(info.ply_path, "rb") as src, \
                open(os.path.join(model_path, "input.ply"), "wb") as dst:
            dst.write(src.read())
    except OSError:
        pass  # source scenes without a materialised ply (read-only dirs)
    cams = [camera_to_json(i, v)
            for i, v in enumerate(list(info.test_views) + list(info.train_views))]
    with open(os.path.join(model_path, "cameras.json"), "w") as f:
        json.dump(cams, f)


def build_nearest_view_graph(views, max_angle=30.0, min_dis=0.01, max_dis=1.5,
                             multi_view_num=8, radius: float | None = None):
    """Nearest-view selection by lexsort(angle, distance) with thresholds
    (scene/__init__.py:83-118). Sets views[i].nearest_ids. `min_dis` and
    `max_dis` are absolute distances. `radius` is accepted and unused, as in
    gsjax, whose docstring says it scales them (ROADMAP queue C)."""
    centers = np.stack([v.camera_center for v in views], axis=0)
    rays = np.stack([v.R @ np.array([0.0, 0.0, 1.0]) for v in views], axis=0)
    rays = rays / np.maximum(np.linalg.norm(rays, axis=1, keepdims=True), 1e-12)
    diss = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    cosang = np.clip((rays[:, None] * rays[None]).sum(-1), -1, 1)
    angles = np.arccos(cosang) * 180 / 3.14159
    for i, v in enumerate(views):
        order = np.lexsort((angles[i], diss[i]))
        m = ((angles[i][order] < max_angle) & (diss[i][order] > min_dis)
             & (diss[i][order] < max_dis))
        v.nearest_ids = [int(s) for s in order[m][:multi_view_num]]
    return views
