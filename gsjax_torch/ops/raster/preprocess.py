"""Per-gaussian preprocess: projection, 2D covariance with Mip-Splatting
dilation, RaDe-GS ray plane and normal, SH+SG colour, tile footprint.

Port of `gsjax/ops/raster/preprocess.py` (`preprocessCUDA` / `computeCov2D`,
render_forward.cu:81-386). In gsjax this stage is XLA, not a Pallas kernel;
here `preprocess` runs, for CUDA tensors, the hand-written kernel pair
`csrc/preprocess_fwd.cu` / `csrc/preprocess_bwd.cu` (forward, and its VJP
from the inputs, through the autograd Function `Preprocess`) and, for CPU
tensors, the plain-PyTorch twin `preprocess_ref` with torch autograd, as
gsjax's gradient is XLA autodiff. The derivation notes in the gsjax module
apply line for line. `preprocess_fwd.launches` and `preprocess_bwd.launches`
count kernel launches.

Where a square root or a norm meets zero the twin guards with a clamp or a
double `where` (`torch.linalg.norm` itself has a zero gradient at zero), so
an alive gaussian never gets a NaN gradient; dead slots are masked to zero
by the caller (train/step.py), and the kernel VJP writes zeros there. The
kernels reproduce the twin's bits in every integer field and the side of
every branch, and their VJP the zeros of the twin's gradient
(`csrc/preprocess_bwd.cu`).
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch import _build
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


def preprocess_ref(means3d: torch.Tensor,
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
    """The plain twin: vectorised preprocess over all (padded) gaussians.

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


# --- the kernel pair ---------------------------------------------------------

FIELDS = tuple(f.name for f in dataclasses.fields(Preprocessed))
INT_FIELDS = ("radius", "rect_min", "rect_wh", "tiles_touched", "valid")
# the float fields, in FIELDS order, with their widths: the VJP's cotangents
GRAD_FIELDS = {"mean2d": 2, "depth": 1, "conic": 3, "opacity": 1, "color": 3,
               "ray_plane": 4, "normal": 3}
# the differentiable inputs, in `preprocess`'s order
INPUTS = ("means3d", "scales", "rotations", "opacities", "shs", "sg_axis",
          "sg_sharpness", "sg_color")
# the VJP's gradients: the rotation's in two parts, through its normalised
# quaternion and through its norm (`Preprocess` takes `rotations` twice)
GRAD_INPUTS = ("means3d", "scales", "rotations", "rotations_norm", "opacities", "shs",
               "sg_axis", "sg_sharpness", "sg_color")
MAX_SH_DEGREE, MAX_SG_DEGREE = 3, 7     # the kernels' template instances


def _launch_args(inputs, camera: Camera, cfg: RasterConfig, alive):
    """Checks what the kernels take -> (their input pointers, alive's, the
    row count, SH bands, SG lobes, the degrees, the camera arguments and the
    camera tensors they point into, to be kept alive over the launch)."""
    from gsjax_torch.ops.raster.render_cuda import _check   # render_cuda imports this module

    means3d, scales, rotations, opacities, shs, sg_axis, sg_sharpness, sg_color = inputs
    dev = means3d.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernels run on cuda or cpu tensors, not {dev}")
    if not 0 <= cfg.sh_degree <= MAX_SH_DEGREE:
        raise ValueError(f"the preprocess kernels take SH degree 0-{MAX_SH_DEGREE}, "
                         f"got {cfg.sh_degree}")
    if not 0 <= cfg.sg_degree <= MAX_SG_DEGREE:
        raise ValueError(f"the preprocess kernels take 0-{MAX_SG_DEGREE} SG lobes, "
                         f"got {cfg.sg_degree}")
    n = means3d.shape[0]
    if n >= 2 ** 31:
        raise ValueError("more than 2^31 gaussians do not fit the kernels' int32 rows")
    f32 = torch.float32
    _check("means3d", means3d, f32, (n, 3), dev)
    _check("scales", scales, f32, (n, 3), dev)
    _check("rotations", rotations, f32, (n, 4), dev)
    _check("opacities", opacities, f32, (n,) + tuple(opacities.shape[1:]), dev)
    if opacities.numel() != n:
        raise ValueError(f"opacities has shape {tuple(opacities.shape)}, expected {n} values")
    bands = shs.shape[1] if shs.dim() == 3 else 0
    _check("shs", shs, f32, (n, bands, 3), dev)
    if bands < (cfg.sh_degree + 1) ** 2:
        raise ValueError(f"shs has {bands} bands, SH degree {cfg.sh_degree} needs "
                         f"{(cfg.sh_degree + 1) ** 2}")
    ptrs = [t.data_ptr() for t in (means3d, scales, rotations, opacities, shs)]
    lobes = 0
    if cfg.sg_degree > 0:
        if sg_axis is None or sg_sharpness is None or sg_color is None:
            raise ValueError(f"sg_degree {cfg.sg_degree} needs sg_axis, sg_sharpness "
                             f"and sg_color")
        lobes = sg_axis.shape[1] if sg_axis.dim() == 3 else 0
        _check("sg_axis", sg_axis, f32, (n, lobes, 3), dev)
        _check("sg_sharpness", sg_sharpness, f32, (n, lobes), dev)
        _check("sg_color", sg_color, f32, (n, lobes, 3), dev)
        if lobes < cfg.sg_degree:
            raise ValueError(f"the SG leaves hold {lobes} lobes, sg_degree is {cfg.sg_degree}")
        ptrs += [t.data_ptr() for t in (sg_axis, sg_sharpness, sg_color)]
    else:
        ptrs += [0, 0, 0]
    if alive is not None:
        _check("alive", alive, torch.bool, (n,), dev)
    mats = []
    for name in ("world_view", "full_proj", "campos"):
        t = getattr(camera, name).contiguous()   # 16 floats at most
        _check(f"camera.{name}", t, f32, (3,) if name == "campos" else (4, 4), dev)
        mats.append(t)
    tiles_x, tiles_y = cfg.grid(camera.width, camera.height)
    cam = (*(t.data_ptr() for t in mats), camera.fx, camera.fy, 1.3 * camera.tan_fovx,
           1.3 * camera.tan_fovy, cfg.near_plane, cfg.kernel_size, cfg.scale_modifier,
           camera.width, camera.height, cfg.tile, tiles_x, tiles_y)
    return (ptrs, 0 if alive is None else alive.data_ptr(), n, bands, lobes,
            cfg.sh_degree, cfg.sg_degree, cam, mats)


def _run(name, fn, *args):
    dev = torch.cuda.current_device()
    rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def preprocess_fwd(means3d, scales, rotations, opacities, shs, sg_axis, sg_sharpness,
                   sg_color, camera: Camera, cfg: RasterConfig,
                   alive: torch.Tensor | None = None) -> Preprocessed:
    """The forward kernel (`csrc/preprocess_fwd.cu`) for CUDA tensors, the
    twin `preprocess_ref` for CPU tensors; arguments as `preprocess`. Float32
    contiguous inputs; `opacities` [N] or [N, 1]; with `cfg.sg_degree` > 0
    the SG leaves [N, G, 3], [N, G], [N, G, 3] with G >= sg_degree."""
    inputs = (means3d, scales, rotations, opacities, shs, sg_axis, sg_sharpness, sg_color)
    if means3d.device.type == "cpu":
        return preprocess_ref(*inputs, camera, cfg, alive)
    ptrs, alive_p, n, bands, lobes, shd, sgd, cam, _mats = _launch_args(inputs, camera, cfg,
                                                                      alive)
    dev = means3d.device
    f = lambda *shape: torch.empty(n, *shape, device=dev)
    i = lambda *shape: torch.empty(n, *shape, dtype=torch.int32, device=dev)
    out = Preprocessed(mean2d=f(2), depth=f(), radius=i(), conic=f(3), opacity=f(),
                       color=f(3), ray_plane=f(4), normal=f(3), rect_min=i(2),
                       rect_wh=i(2), tiles_touched=i(),
                       valid=torch.empty(n, dtype=torch.bool, device=dev))
    if n:
        with torch.cuda.device(dev):
            _run("preprocess_fwd", _build.load("preprocess_fwd").gsjax_preprocess_fwd,
                 *ptrs, alive_p, *(getattr(out, k).data_ptr() for k in FIELDS),
                 n, bands, lobes, shd, sgd, *cam)
        preprocess_fwd.launches += 1
    return out


preprocess_fwd.launches = 0


def preprocess_vjp_ref(inputs, camera: Camera, cfg: RasterConfig, alive, cotangents):
    """The twin's VJP: torch autograd through `preprocess_ref` -> a gradient
    per input (None where the input is None or the graph does not read it).
    `cotangents`: one per GRAD_FIELDS entry, None for a zero one."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(True) for t in inputs]
        out = preprocess_ref(*leaves, camera, cfg, alive)
        pairs = [(getattr(out, k), g) for k, g in zip(GRAD_FIELDS, cotangents)
                 if g is not None]
        wrt = [t for t in leaves if t is not None]
        if not pairs:
            return tuple(None if t is None else torch.zeros_like(t) for t in inputs)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(None if t is None else next(got) for t in leaves)


def preprocess_bwd(inputs, camera: Camera, cfg: RasterConfig, alive, cotangents,
                   needs=(True,) * (len(INPUTS) + 1)):
    """The VJP kernel (`csrc/preprocess_bwd.cu`) for CUDA tensors, the twin
    `preprocess_vjp_ref` for CPU tensors: `inputs` as `preprocess`'s eight
    differentiable arguments, `cotangents` one per GRAD_FIELDS entry (None
    for zero; any strides) -> a gradient per GRAD_INPUTS entry (the
    rotation's in its two parts, through the normalised quaternion and
    through the quaternion's norm, whose sum the twin's graph adds to the
    leaf), None where `needs` does not ask for it, the input is None or (SG
    leaves with `cfg.sg_degree` 0) the function does not read it. Dead rows
    get zeros. On CPU tensors the twin's graph has added the rotation's
    parts: the first holds their sum, the second is None."""
    if inputs[0].device.type == "cpu":
        g = preprocess_vjp_ref(inputs, camera, cfg, alive, cotangents)
        return (*g[:3], None, *g[3:])
    ptrs, alive_p, n, bands, lobes, shd, sgd, cam, _mats = _launch_args(inputs, camera, cfg,
                                                                      alive)
    dev = inputs[0].device
    cots = []
    for (k, w), g in zip(GRAD_FIELDS.items(), cotangents):
        if g is None:
            cots += [0, 0, 0]
            continue
        shape = (n,) if w == 1 else (n, w)
        if g.device != dev or g.dtype != torch.float32 or tuple(g.shape) != shape:
            raise ValueError(f"the cotangent of {k} is {g.dtype} {tuple(g.shape)} on "
                             f"{g.device}, expected float32 {shape} on {dev}")
        cots += [g.data_ptr(), g.stride(0), g.stride(1) if w > 1 else 0]
    args = (*inputs[:3], inputs[2], *inputs[3:])   # as GRAD_INPUTS
    grads = [torch.empty_like(t) if t is not None and need and (j < 6 or sgd > 0) else None
             for j, (t, need) in enumerate(zip(args, needs))]
    if n:
        with torch.cuda.device(dev):
            _run("preprocess_bwd", _build.load("preprocess_bwd").gsjax_preprocess_bwd,
                 *ptrs, alive_p, *cots, *(0 if g is None else g.data_ptr() for g in grads),
                 n, bands, lobes, shd, sgd, *cam)
        preprocess_bwd.launches += 1
    return tuple(grads)


preprocess_bwd.launches = 0


class Preprocess(torch.autograd.Function):
    """`preprocess_fwd` with `preprocess_bwd` as its VJP, on CUDA tensors.
    Keeps only the inputs (the VJP recomputes the forward from them); the
    integer fields and `valid` carry no gradient.

    `rotations` comes in twice, the same tensor both times, as in the twin's
    graph, which reads it through its normalised quaternion and through its
    norm: the VJP returns the two parts of its gradient apart, one to each,
    and the autograd engine adds them to the leaf in that order, after
    those of a later view (the multi-view step's neighbour), as it adds the
    twin's. Round-off is all the gradient holds along a gaussian's in-plane
    turn, and only the same sums in the same order leave its zeros where the
    twin's are."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, rotations_again, opacities, shs, sg_axis,
                sg_sharpness, sg_color, camera, cfg, alive):
        out = preprocess_fwd(means3d, scales, rotations, opacities, shs, sg_axis,
                             sg_sharpness, sg_color, camera, cfg, alive)
        ctx.save_for_backward(means3d, scales, rotations, opacities, shs, sg_axis,
                              sg_sharpness, sg_color, alive)
        ctx.camera, ctx.cfg = camera, cfg
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*(getattr(out, k) for k in INT_FIELDS))
        return tuple(getattr(out, k) for k in FIELDS)

    @staticmethod
    @spans.spanned("raster.preprocess")
    def backward(ctx, *grads):
        *inputs, alive = ctx.saved_tensors
        cot = dict(zip(FIELDS, grads))
        d = preprocess_bwd(inputs, ctx.camera, ctx.cfg, alive, [cot[k] for k in GRAD_FIELDS],
                           ctx.needs_input_grad[:len(GRAD_INPUTS)])
        return (*d, None, None, None)


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
    """Vectorised preprocess over all (padded) gaussians, differentiable in
    its float inputs: the kernel pair (`Preprocess`) for CUDA tensors, the
    twin `preprocess_ref` under torch autograd for CPU tensors.

    `scales`/`opacities` are post-activation and 3D-filtered, `rotations`
    raw quaternions (normalised here), `alive` masks padding slots."""
    if means3d.device.type == "cpu":
        return preprocess_ref(means3d, scales, rotations, opacities, shs, sg_axis,
                              sg_sharpness, sg_color, camera, cfg, alive)
    return Preprocessed(*Preprocess.apply(means3d, scales, rotations, rotations, opacities,
                                          shs, sg_axis, sg_sharpness, sg_color, camera,
                                          cfg, alive))
