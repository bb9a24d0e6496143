"""The benchmark's scene generator: a trained scene, its cameras and its target
frames, made on the device from `--seed` (never by the program).

A configuration file (`configs/<name>.json`) fixes the sizes; this module
fills them in:

- Geometry. Flat gaussians, as RaDe-GS / GGGS training leaves them, lie on
  three surfaces: a central object (an ellipsoid), a ground disk under it and
  a background sphere that closes every view, so every pixel has a median
  depth. The thin axis of each gaussian is its surface's normal.
- Scale. A gaussian's in-plane sigma is `scale_factor * sqrt(area / count)`
  of its surface, jittered log-normally: the number of gaussians over a
  surface point, the depth complexity, does not depend on the count. Its thin
  axis is `thin_ratio` of that, and never under its Mip-Splatting 3D filter
  (the least camera depth over the largest focal, times sqrt(0.2)), as a
  scene trained with the filter leaves it.
- Opacity. A seeded mixture of opaque and faint gaussians, drawn as the
  opacity after the 3D filter (the raw opacity is that over the filter's
  factor, at most 0.995): a trained scene's surfaces are opaque.
- Colour. Random DC colours, small higher SH bands and SG lobes.
- Cameras. An orbit round the object at a fixed radius, its height
  wobbling; the same cameras for every seed. The flythrough (`flythrough`)
  is a second orbit at the mean height, between the training views, looking
  at the object: novel views, as a viewer's client asks for them.
- Targets. Seeded smooth noise per view, made on the device in a few large
  calls; the step's work does not depend on its values.

Every random draw comes from one `torch.Generator` on the device, seeded with
`--seed`, in a fixed order, so a seed gives the same scene on every run.
`scale` < 1 shrinks the frame by `scale` and the count by its cube (the CPU
tests).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
                "rotation", "sg_axis", "sg_sharpness", "sg_color")
SH_C0 = 0.28209479177387814


@dataclasses.dataclass
class View:
    """One camera in COLMAP's convention: R cam->world, T world->cam."""
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    width: int
    height: int

    @property
    def center(self) -> np.ndarray:
        return self.R @ (-self.T)


@dataclasses.dataclass
class Scene:
    """What the generator made: raw (pre-activation) parameter leaves at
    `capacity` rows with the first `n` alive, the views, the target frames
    (host float32 [V, H, W, 3] and their luma [V, H, W]) and the camera
    extent radius."""
    params: dict
    alive: torch.Tensor
    n: int
    capacity: int
    views: list
    images: np.ndarray | None
    grays: np.ndarray | None
    radius: float


def frame_size(cfg: dict, scale: float = 1.0) -> tuple[int, int]:
    w, h = cfg["resolution"]
    return max(32, int(round(w * scale))), max(32, int(round(h * scale)))


def gaussian_count(cfg: dict, scale: float = 1.0) -> int:
    """The count at `scale`: scale^3 of the configuration's, so that a
    tile's list shrinks with the frame (the CPU tests' sizes)."""
    return max(64, int(round(cfg["gaussians"] * scale ** 3)))


def capacity_for(n: int) -> int:
    """The model's row count: the smallest power of two that keeps the
    alive share at or under 0.9, where the port's trainer leaves it (its
    capacity grows by powers of two once alive rows pass 90%)."""
    cap = 1
    while n > 0.9 * cap:
        cap *= 2
    return cap


def look_at(center: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)):
    """(R cam->world, T world->cam) of a camera at `center` looking at
    `target`: x right, y down, z forward."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(z, np.asarray(up, np.float64))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    return R.astype(np.float32), (-R.T @ center).astype(np.float32)


def orbit_views(cfg: dict, scale: float = 1.0) -> list[View]:
    cam = cfg["cameras"]
    width, height = frame_size(cfg, scale)
    fovx = float(cam["fovx"])
    fovy = 2.0 * math.atan(math.tan(fovx / 2) * height / width)
    target = np.asarray(cam["target"], np.float64)
    views = []
    n = int(cfg["train_views"])
    for i in range(n):
        a = 2 * math.pi * i / n
        h = cam["height"] + cam["height_wobble"] * math.sin(cam["wobbles"] * a)
        c = np.array([cam["radius"] * math.cos(a), cam["radius"] * math.sin(a), h])
        R, T = look_at(c, target)
        views.append(View(i, R, T, fovx, fovy, width, height))
    return views


def camera_extent(views) -> float:
    """getNerfppNorm's radius (dataset_readers.py:60-81)."""
    centers = np.stack([v.center for v in views])
    d = np.linalg.norm(centers - centers.mean(0, keepdims=True), axis=1)
    return float(d.max() * 1.1)


def _ellipsoid_area(a, b, c):
    p = 1.6075       # Knud Thomsen's approximation, within 1.1%
    return 4 * math.pi * (((a * b) ** p + (a * c) ** p + (b * c) ** p) / 3) ** (1 / p)


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def _surface(kind: str, spec: dict, n: int, gen, dev):
    """n points on one surface -> (xyz [n,3], normal [n,3], area)."""
    if kind == "ellipsoid":
        r = torch.tensor(spec["radii"], dtype=torch.float32, device=dev)
        c = torch.tensor(spec["center"], dtype=torch.float32, device=dev)
        u = _unit(torch.randn(n, 3, generator=gen, device=dev))
        return c + u * r, _unit(u / r), _ellipsoid_area(*spec["radii"])
    if kind == "disk":
        rad = float(spec["radius"])
        rr = rad * torch.sqrt(torch.rand(n, generator=gen, device=dev))
        th = 2 * math.pi * torch.rand(n, generator=gen, device=dev)
        xyz = torch.stack([rr * torch.cos(th), rr * torch.sin(th),
                           torch.full_like(rr, float(spec["z"]))], -1)
        nrm = torch.zeros_like(xyz)
        nrm[:, 2] = 1.0
        return xyz, nrm, math.pi * rad * rad
    if kind == "sphere":
        rad = float(spec["radius"])
        u = _unit(torch.randn(n, 3, generator=gen, device=dev))
        return u * rad, -u, 4 * math.pi * rad * rad
    raise ValueError(f"unknown surface kind {kind!r}")


def _flat_quaternion(normal, gen, dev):
    """wxyz quaternions whose local z axis is `normal`, turned about it by a
    random angle: q = q(e_z -> normal) * q(about z)."""
    half = math.pi * torch.rand(normal.shape[0], generator=gen, device=dev)
    c, s = torch.cos(half), torch.sin(half)
    a = 1.0 + normal[:, 2]
    bx, by = -normal[:, 1], normal[:, 0]
    flip = a < 1e-6                               # normal = -e_z: turn about x
    a = torch.where(flip, torch.zeros_like(a), a)
    bx = torch.where(flip, torch.ones_like(bx), bx)
    by = torch.where(flip, torch.zeros_like(by), by)
    q = torch.stack([a * c, c * bx + s * by, c * by - s * bx, a * s], -1)
    return _unit(q)


def flythrough(cfg: dict, n_frames: int, scale: float = 1.0) -> list[View]:
    """Novel views: an orbit at the training orbit's radius and mean height,
    its frames half a step off the training views', looking at the target."""
    cam = cfg["cameras"]
    width, height = frame_size(cfg, scale)
    fovx = float(cam["fovx"])
    fovy = 2.0 * math.atan(math.tan(fovx / 2) * height / width)
    target = np.asarray(cam["target"], np.float64)
    out = []
    for i in range(n_frames):
        a = 2 * math.pi * (i + 0.5) / n_frames
        c = np.array([cam["radius"] * math.cos(a), cam["radius"] * math.sin(a), cam["height"]])
        R, T = look_at(c, target)
        out.append(View(i, R, T, fovx, fovy, width, height))
    return out


def filter_3d(xyz: torch.Tensor, views) -> torch.Tensor:
    """The Mip-Splatting 3D filter of each point (scene/gaussian_model.py:
    226-262): its least depth over the views that see it, over the largest
    focal, times sqrt(0.2); points no view sees take the largest."""
    dist = torch.full((xyz.shape[0],), float("inf"), device=xyz.device)
    fmax = 0.0
    for v in views:
        fx = v.width / (2 * math.tan(v.fovx / 2))
        fy = v.height / (2 * math.tan(v.fovy / 2))
        fmax = max(fmax, fx)
        R = torch.tensor(v.R.T, dtype=torch.float32, device=xyz.device)
        T = torch.tensor(v.T, dtype=torch.float32, device=xyz.device)
        cam = xyz @ R.T + T
        z = cam[:, 2]
        zs = torch.where(z > 0.2, z, torch.ones_like(z))
        seen = (z > 0.2) & ((cam[:, 0] / zs).abs() <= v.width / fx * 0.575) & \
            ((cam[:, 1] / zs).abs() <= v.height / fy * 0.575)
        dist = torch.where(seen, torch.minimum(dist, z), dist)
    finite = torch.isfinite(dist)
    dist = torch.where(finite, dist, dist[finite].max() if finite.any() else 1.0)
    return dist / fmax * (0.2 ** 0.5)


def make_gaussians(cfg: dict, n: int, capacity: int, gen, dev,
                   views=None) -> tuple[dict, torch.Tensor]:
    """The parameter leaves [capacity, ...] (dead rows zero, identity
    rotation) and the alive mask; `views` (default: the orbit at full size)
    set the 3D filter the scales and opacities are drawn against."""
    g = cfg["generator"]
    shares = [s["share"] for s in g["surfaces"]]
    counts = [int(n * s / sum(shares)) for s in shares]
    counts[0] += n - sum(counts)
    xyz, nrm, sigma = [], [], []
    for spec, k in zip(g["surfaces"], counts):
        p, q, area = _surface(spec["kind"], spec, k, gen, dev)
        xyz.append(p)
        nrm.append(q)
        sigma.append(torch.full((k,), g["scale_factor"] * math.sqrt(area / max(k, 1)),
                                device=dev))
    xyz, nrm, sigma = torch.cat(xyz), torch.cat(nrm), torch.cat(sigma)
    sigma = sigma * torch.exp(g["scale_jitter"] * torch.randn(n, generator=gen, device=dev))
    filt = filter_3d(xyz, orbit_views(cfg) if views is None else views)
    thin = torch.maximum(sigma * g["thin_ratio"], filt)
    scaling = torch.log(torch.stack([sigma, sigma, thin], -1))
    f2 = filt * filt
    keep = torch.sqrt((sigma * sigma / (sigma * sigma + f2)) ** 2 * (thin * thin / (thin * thin + f2)))
    rotation = _flat_quaternion(nrm, gen, dev)
    op_cfg = g["opacity"]
    opaque = torch.rand(n, generator=gen, device=dev) < op_cfg["opaque_share"]
    lo = torch.where(opaque, op_cfg["opaque"][0], op_cfg["faint"][0])
    hi = torch.where(opaque, op_cfg["opaque"][1], op_cfg["faint"][1])
    op = (lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)) / keep
    op = torch.clamp(op, 0.005, 0.995)
    sh_degree, sg_degree = int(cfg["sh_degree"]), int(cfg["sg_degree"])
    m = (sh_degree + 1) ** 2
    lobes = max(sg_degree, 1)                       # the port keeps one lobe slot
    rgb = 0.1 + 0.8 * torch.rand(n, 3, generator=gen, device=dev)
    rest = g["sh_rest_std"] * torch.randn(n, m - 1, 3, generator=gen, device=dev)
    sg_axis = torch.randn(n, lobes, 3, generator=gen, device=dev)
    sg_sharp = g["sg_sharpness"][0] + g["sg_sharpness"][1] * torch.randn(
        n, lobes, generator=gen, device=dev)
    sg_color = g["sg_color_std"] * torch.randn(n, lobes, 3, generator=gen, device=dev)
    if sg_degree == 0:
        sg_axis, sg_sharp, sg_color = (torch.zeros_like(t) for t in (sg_axis, sg_sharp, sg_color))
    leaves = dict(xyz=xyz, features_dc=((rgb - 0.5) / SH_C0)[:, None, :],
                  features_rest=rest, opacity=torch.log(op / (1 - op))[:, None],
                  scaling=scaling, rotation=rotation, sg_axis=sg_axis,
                  sg_sharpness=sg_sharp, sg_color=sg_color)
    out = {}
    for k in PARAM_FIELDS:
        t = torch.zeros((capacity,) + tuple(leaves[k].shape[1:]), device=dev)
        t[:n] = leaves[k]
        out[k] = t
    out["rotation"][n:, 0] = 1.0
    alive = torch.arange(capacity, device=dev) < n
    return out, alive


def make_targets(views, gen, dev, cell: int = 32, chunk: int = 16):
    """Smooth noise frames: per view, noise on a grid of `cell`-pixel cells,
    upsampled bilinearly -> host float32 [V, H, W, 3] in [0, 1] and their
    luma [V, H, W] (scene/cameras.py:45's weights)."""
    w, h = views[0].width, views[0].height
    gh, gw = -(-h // cell) + 1, -(-w // cell) + 1
    images = np.empty((len(views), h, w, 3), np.float32)
    grays = np.empty((len(views), h, w), np.float32)
    luma = torch.tensor([0.299, 0.587, 0.114], device=dev)
    for i in range(0, len(views), chunk):
        k = min(chunk, len(views) - i)
        low = torch.rand(k, 3, gh, gw, generator=gen, device=dev)
        img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear",
                                              align_corners=False).permute(0, 2, 3, 1)
        images[i:i + k] = img.cpu().numpy()
        grays[i:i + k] = (img * luma).sum(-1).cpu().numpy()
    return images, grays


def make_scene(cfg: dict, seed: int, device, scale: float = 1.0,
               targets: bool = True) -> Scene:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    n = gaussian_count(cfg, scale)
    capacity = capacity_for(n)
    views = orbit_views(cfg, scale)
    params, alive = make_gaussians(cfg, n, capacity, gen, dev, views)
    images, grays = make_targets(views, gen, dev) if targets else (None, None)
    return Scene(params=params, alive=alive, n=n, capacity=capacity, views=views,
                 images=images, grays=grays, radius=camera_extent(views))
