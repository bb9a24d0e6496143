"""Per-gaussian preprocess: projection, 2D covariance with Mip-Splatting
dilation, RaDe-GS ray plane and normal, SH+SG colour, tile footprint.

Port of `gsjax/ops/raster/preprocess.py` (`preprocessCUDA` / `computeCov2D`,
render_forward.cu:81-386) as plain PyTorch over [N] rows: in gsjax this
stage is XLA, not a Pallas kernel, so it has no hand-written kernel here
either. The derivation notes in the gsjax module apply line for line.

Its gradient is torch autograd, as gsjax's is XLA autodiff. Where a square
root or a norm meets zero the forward guards with a clamp or a double
`where` (`torch.linalg.norm` itself has a zero gradient at zero), so an
alive gaussian never gets a NaN gradient; dead slots are masked to zero by
the caller (train/step.py).
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.core import quaternion, rowwise, sg, sh
from gsjax_torch.core.transforms import ndc_to_pix
from gsjax_torch.ops.raster.camera import Camera
from gsjax_torch.ops.raster.config import RasterConfig
from gsjax_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class Preprocessed:
    """Per-gaussian screen-space quantities ([N] leading dim)."""
    mean2d: torch.Tensor       # [N,2] pixel-space centre
    depth: torch.Tensor        # [N]   |p_view| (sort key), inf when culled
    radius: torch.Tensor       # [N]   int32 screen radius (0 => culled)
    conic: torch.Tensor        # [N,3] inverse 2D covariance (a,b,c)
    opacity: torch.Tensor      # [N]   opacity * mip coefficient
    color: torch.Tensor        # [N,3] SH+SG colour (clamped >= 0)
    ray_plane: torch.Tensor    # [N,4] (rp0, rp1, tc, rsigma)
    normal: torch.Tensor       # [N,3] camera-space unit normal
    rect_min: torch.Tensor     # [N,2] int32 tile rect (x,y) inclusive
    rect_wh: torch.Tensor      # [N,2] int32 tile rect extent
    tiles_touched: torch.Tensor  # [N] int32
    valid: torch.Tensor        # [N] bool


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[N,3,3] @ [N,3] -> [N,3], written out elementwise (exact f32, no
    reduced-precision matmul path on any device)."""
    return (m * v[:, None, :]).sum(-1)


@spans.spanned("raster.preprocess")
def preprocess(means3d: torch.Tensor,
               scales: torch.Tensor,
               rotations: torch.Tensor,
               opacities: torch.Tensor,
               shs: torch.Tensor,
               sg_axis: torch.Tensor | None,
               sg_sharpness: torch.Tensor | None,
               sg_color: torch.Tensor | None,
               camera: Camera,
               cfg: RasterConfig,
               alive: torch.Tensor | None = None) -> Preprocessed:
    """Vectorised preprocess over all (padded) gaussians.

    `scales`/`opacities` are post-activation and 3D-filtered, `rotations`
    raw quaternions (normalised here), `alive` masks padding slots."""
    n = means3d.shape[0]
    wv = camera.world_view
    R_wc = wv[:3, :3]
    full = camera.full_proj

    # --- view/clip transforms (rowwise: a shard's rows give the full run's
    # bits, as the multi-device step's sharded preprocess needs) ------------
    p_view = rowwise.affine(means3d, R_wc, wv[:3, 3])
    tz = p_view[:, 2]
    in_front = tz > cfg.near_plane

    p_hom = rowwise.affine(means3d, full[:3, :3], full[:3, 3])
    p_w = rowwise.affine(means3d, full[3:4, :3], full[3:4, 3])[:, 0]
    p_proj = p_hom / (p_w[:, None] + 1e-7)

    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))
    tc = torch.linalg.norm(p_view, dim=-1)

    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    u = torch.clamp(p_view[:, 0] / tz_safe, -limx, limx)
    v = torch.clamp(p_view[:, 1] / tz_safe, -limy, limy)
    txc = u * tz_safe
    tyc = v * tz_safe
    l = torch.sqrt(txc * txc + tyc * tyc + tz_safe * tz_safe)

    # --- world covariance & camera-frame inverse --------------------------
    q = quaternion.normalize(rotations)
    R_g = quaternion.to_rotation_matrix(q)
    s = scales * cfg.scale_modifier
    s_safe = s.clamp_min(1e-12)
    RS = R_g * s[:, None, :]
    sigma_world = (RS[:, :, None, :] * RS[:, None, :, :]).sum(-1)
    tmp = (R_wc[None, :, None, :] * sigma_world[:, None, :, :]).sum(-1)
    sigma_cam = (tmp[:, :, None, :] * R_wc[None, None, :, :]).sum(-1)
    V = (R_wc[None, :, :, None] * R_g[:, None, :, :]).sum(2) / s_safe[:, None, :]
    sigma_cam_inv = (V[:, :, None, :] * V[:, None, :, :]).sum(-1)

    # --- 2D covariance via EWA Jacobian (fov-clamped point) ----------------
    fx, fy = camera.fx, camera.fy
    j00 = fx / tz_safe
    j11 = fy / tz_safe
    j02 = -fx * txc / (tz_safe * tz_safe)
    j12 = -fy * tyc / (tz_safe * tz_safe)
    zero = torch.zeros_like(j00)
    a_row0 = torch.stack([j00, zero, j02], -1)
    a_row1 = torch.stack([zero, j11, j12], -1)
    sa0 = _mv(sigma_cam, a_row0)
    sa1 = _mv(sigma_cam, a_row1)
    c_xx = (a_row0 * sa0).sum(-1)
    c_xy = (a_row0 * sa1).sum(-1)
    c_yy = (a_row1 * sa1).sum(-1)

    det_raw = torch.clamp_min(c_xx * c_yy - c_xy * c_xy, 1e-6)
    cov_x = c_xx + cfg.kernel_size
    cov_y = c_xy
    cov_z = c_yy + cfg.kernel_size
    det_dil = torch.clamp_min(cov_x * cov_z - cov_y * cov_y, 1e-6)
    mip_coef = torch.sqrt(det_raw / det_dil)

    det = cov_x * cov_z - cov_y * cov_y
    det_ok = det > 0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cov_z / det_safe, -cov_y / det_safe, cov_x / det_safe], -1)

    # --- screen footprint ---------------------------------------------------
    mid = 0.5 * (cov_x + cov_z)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det_safe, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam))
    px = ndc_to_pix(p_proj[:, 0], camera.width)
    py = ndc_to_pix(p_proj[:, 1], camera.height)
    mean2d = torch.stack([px, py], -1)

    tiles_x, tiles_y = cfg.grid(camera.width, camera.height)
    t_sz = float(cfg.tile)

    def rect(v, hi):
        return torch.clamp(torch.floor(v / t_sz), 0, hi).to(torch.int32)

    rx_min = rect(px - radius_f, tiles_x)
    ry_min = rect(py - radius_f, tiles_y)
    rx_max = rect(px + radius_f + t_sz - 1, tiles_x)
    ry_max = rect(py + radius_f + t_sz - 1, tiles_y)
    rect_w = rx_max - rx_min
    rect_h = ry_max - ry_min
    area = rect_w * rect_h

    valid = in_front & det_ok & (area > 0)
    if alive is not None:
        valid = valid & alive
    area = torch.where(valid, area, torch.zeros_like(area))
    radius = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)

    # --- RaDe-GS ray-plane & normal -----------------------------------------
    uvh = torch.stack([u, v, torch.ones_like(u)], -1)
    m = _mv(sigma_cam_inv, uvh)
    vb = (m * uvh).sum(-1)
    vb_safe = torch.where(vb.abs() > 1e-20, vb, torch.full_like(vb, 1e-20))
    ray_len2 = u * u + v * v + 1.0
    factor = l / ray_len2
    plane0 = ((v * v + 1.0) * m[:, 0] - u * v * m[:, 1]) / vb_safe
    plane1 = (-u * v * m[:, 0] + (u * u + 1.0) * m[:, 1]) / vb_safe
    # sqrt(max(vb, 0) / len2), with no inf/NaN gradient where vb <= 0
    vb_pos = vb > 0
    rsigma = torch.where(vb_pos, torch.sqrt(torch.where(vb_pos, vb, 1.0) / ray_len2),
                         torch.zeros_like(vb))
    ray_plane = torch.stack([plane0 * factor / fx, plane1 * factor / fy, tc, rsigma], -1)

    rnv0 = -plane0 * factor
    rnv1 = -plane1 * factor
    n0 = rnv0 / tz_safe + txc / (tz_safe * tz_safe)
    n1 = rnv1 / tz_safe + tyc / (tz_safe * tz_safe)
    n2 = (rnv0 * txc + rnv1 * tyc - tz_safe) / l
    nvec = torch.stack([n0, n1, n2], -1)
    normal = nvec / torch.linalg.norm(nvec, dim=-1, keepdim=True).clamp_min(1e-12)

    # --- appearance ---------------------------------------------------------
    dirs = means3d - camera.campos
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    color = sh.eval_sh(cfg.sh_degree, shs, dirs)
    if cfg.sg_degree > 0:
        color = color + sg.eval_sg(cfg.sg_degree, sg_axis, sg_sharpness, sg_color, dirs)
    color = torch.clamp_min(color + 0.5, 0.0)

    depth = torch.where(valid, tc, torch.full_like(tc, float("inf")))

    return Preprocessed(
        mean2d=mean2d,
        depth=depth,
        radius=radius,
        conic=conic,
        opacity=opacities.reshape(n) * mip_coef,
        color=color,
        ray_plane=ray_plane,
        normal=normal,
        rect_min=torch.stack([rx_min, ry_min], -1),
        rect_wh=torch.stack([rect_w, rect_h], -1),
        tiles_touched=area.to(torch.int32),
        valid=valid,
    )
