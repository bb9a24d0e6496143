# Frozen copy of gsjax_torch/ops/sample.py at commit 95f6082 (the benchmark's plain
# reference; edited only where it named a kernel or another module of the port).
"""Point queries: differentiable cross-view median-depth sampling.

Port of `gsjax/ops/sample.py` (`sample_depth`, `evaluate_sdf`; the
reference's `sampleDepthCUDA` / `evaluateSDFCUDA`, sample_forward.cu
:171-700). Query points are projected into the view, sorted by their
pixel's tile with a stable sort and cut into blocks of at most 256 points of
one tile; each point marches its tile's depth-sorted pair list and finds its
median ray distance through `sample_cuda.SampleDepth` (kernels B3 / B5 for
CUDA tensors, their twins in `sample_ref` for CPU tensors or backend
"torch"). The binning is the blend's with `continuous_coords=True`, since
points sit at continuous coordinates.

Gradients flow to the gaussians (through the pair payload and preprocess)
and to the query points: B5 gives d(px), d(py), and torch autograd carries
them back through the projection, as it carries the ray-to-z factor.
Points outside the view's frustum are not queried: their values are exact
zeros with zero gradient.

`integrate` (evaluateTransmittanceCUDA, sample_forward.cu:55-169) gives the
half-gaussian-CDF transmittance at each point's own ray distance through
`sample_cuda.integrate_fwd` (kernel B4, or its twin); it is forward only and
serves meshing. A query is built in two halves: `prepare_view` (preprocess,
binning, pair payload: what depends on the gaussians and the camera) and
`prepare_points` (projection, tile sort, block table), so a caller that
queries one fixed model many times, as mesh extraction does, builds each
view's half once (`integrate_view`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gsbench.reference import rowwise
from gsbench.reference import precision, sample_ref
from gsbench.reference import render_ref
from gsbench.reference.binning import Binning, bin_gaussians
from gsbench.reference.camera import Camera
from gsbench.reference.config import RasterConfig
from gsbench.reference.preprocess import preprocess


def _project_points(points, camera: Camera, cfg: RasterConfig):
    """Project query points into the view. Returns (px, py, t_ray, inside0)."""
    wv = camera.world_view
    pv = rowwise.affine(points, wv[:3, :3], wv[:3, 3])
    in_front = pv[:, 2] > cfg.near_plane
    full = camera.full_proj
    ph = rowwise.affine(points, full[:3, :3], full[:3, 3])
    pw = rowwise.affine(points, full[3:4, :3], full[3:4, 3])[:, 0]
    pp = ph / (pw[:, None] + 1e-7)
    px = ((pp[:, 0] + 1) * camera.width - 1) * 0.5
    py = ((pp[:, 1] + 1) * camera.height - 1) * 0.5
    inside0 = in_front & (px >= 0) & (px <= camera.width - 1) & \
        (py >= 0) & (py <= camera.height - 1)
    return px, py, torch.linalg.norm(pv, dim=-1), inside0


def _point_tile(px, py, camera: Camera, cfg: RasterConfig):
    tiles_x, tiles_y = cfg.grid(camera.width, camera.height)
    tx = torch.clamp(torch.floor(px / cfg.tile), 0, tiles_x - 1).to(torch.int64)
    ty = torch.clamp(torch.floor(py / cfg.tile), 0, tiles_y - 1).to(torch.int64)
    return ty * tiles_x + tx


@functools.lru_cache(maxsize=8)
def _pixel_keys(width: int, height: int, tile: int, device: torch.device) -> torch.Tensor:
    """[height * width] int32: each pixel's key in the integrate's pixel
    order, its tile times tile^2 plus the Z order of the pixel within the
    tile (built once per image size, so a call pays one gather for it)."""
    if tile > 256:
        raise ValueError(f"pixel order takes tiles of at most 256 pixels, got {tile}")
    tiles_x = -(-width // tile)
    y, x = torch.meshgrid(torch.arange(height, dtype=torch.int32, device=device),
                          torch.arange(width, dtype=torch.int32, device=device), indexing="ij")
    tile_id = (y // tile) * tiles_x + x // tile
    return (tile_id * tile * tile + _z_order(x % tile) + 2 * _z_order(y % tile)).flatten()


def _z_order(v):
    """The bits of v (< 256) spread to the even bit positions."""
    v = (v | (v << 4)) & 0x0F0F
    v = (v | (v << 2)) & 0x3333
    return (v | (v << 1)) & 0x5555


def point_blocks(sorted_tile: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """[NB, 3] int32 block table of points sorted by tile: (tile, first point,
    count), each tile's points cut into blocks of at most BLOCK."""
    dev = sorted_tile.device
    per_tile = torch.bincount(sorted_tile, minlength=num_tiles)
    n_blk = (per_tile + sample_ref.BLOCK - 1) // sample_ref.BLOCK
    tile = torch.repeat_interleave(torch.arange(num_tiles, device=dev), n_blk)
    j = torch.arange(tile.shape[0], device=dev) - (torch.cumsum(n_blk, 0) - n_blk)[tile]
    first = (torch.cumsum(per_tile, 0) - per_tile)[tile] + j * sample_ref.BLOCK
    count = torch.clamp_max(per_tile[tile] - j * sample_ref.BLOCK, sample_ref.BLOCK)
    return torch.stack([tile, first, count], 1).to(torch.int32).contiguous()


@dataclasses.dataclass(frozen=True)
class ViewPairs:
    """The per-view half of a point query: the view's pair payload and its
    lists."""
    feats: torch.Tensor        # [K,16] pair payload, binning order
    binning: Binning           # its lists (continuous_coords)


def prepare_view(means3d, scales, rotations, opacities, camera: Camera,
                 cfg: RasterConfig, alive=None) -> ViewPairs:
    """Preprocess and bin the gaussians for point queries in `camera` (SH/SG
    degree 0: colour is unused)."""
    cfg0 = dataclasses.replace(cfg, sh_degree=0, sg_degree=0)
    shs = means3d.new_zeros(means3d.shape[0], 1, 3)
    prep = preprocess(means3d, scales, rotations, opacities, shs, None, None, None,
                      camera, cfg0, alive)
    binning = bin_gaussians(prep, cfg0, camera.width, camera.height,
                            continuous_coords=True)
    return ViewPairs(feats=render_ref.prepare_pairs(prep, binning), binning=binning)


@dataclasses.dataclass(frozen=True)
class Query:
    """What the kernels of a point query read, and the projection."""
    feats: torch.Tensor        # [K,16] pair payload of the view, binning order
    binning: Binning           # its lists (continuous_coords)
    pts: torch.Tensor          # [Q',2] (px, py) of the points inside, sorted by tile
    blocks: torch.Tensor       # [NB,3] int32 block table (point_blocks)
    sorted_q: torch.Tensor     # [Q'] index of each sorted point in the query
    px: torch.Tensor           # [Q] projected pixel coordinates
    py: torch.Tensor
    t_ray: torch.Tensor        # [Q] the point's own ray distance
    inside0: torch.Tensor      # [Q] in front of the near plane and on screen


def prepare_points(view: ViewPairs, points, camera: Camera, cfg: RasterConfig,
                   pixel_order: bool = False) -> Query:
    """Project the points and sort the ones inside the frustum by tile (a
    stable sort), or with `pixel_order` by tile and then by the Z order of
    their pixel within the tile, so that a warp's points lie close together
    (the integrate's order, `integrate_view`)."""
    px, py, t_ray, inside0 = _project_points(points, camera, cfg)
    tiles_x, tiles_y = cfg.grid(camera.width, camera.height)
    sel = torch.nonzero(inside0).squeeze(1)
    x, y = px.detach()[sel], py.detach()[sel]
    if pixel_order:    # on-screen points: 0 <= x <= width - 1, so truncation floors
        pix = y.to(torch.int32) * camera.width + x.to(torch.int32)
        key, order = torch.sort(
            _pixel_keys(camera.width, camera.height, cfg.tile, x.device)[pix], stable=True)
        sorted_tile = key // (cfg.tile * cfg.tile)
    else:
        sorted_tile, order = torch.sort(_point_tile(x, y, camera, cfg), stable=True)
    sorted_q = sel[order]
    return Query(feats=view.feats, binning=view.binning,
                 pts=torch.stack([px[sorted_q], py[sorted_q]], -1).contiguous(),
                 blocks=point_blocks(sorted_tile, tiles_x * tiles_y),
                 sorted_q=sorted_q, px=px, py=py, t_ray=t_ray, inside0=inside0)


def prepare_query(points, means3d, scales, rotations, opacities, camera: Camera,
                  cfg: RasterConfig, alive=None) -> Query:
    """Both halves of a query: `prepare_view`, then `prepare_points`."""
    view = prepare_view(means3d, scales, rotations, opacities, camera, cfg, alive)
    return prepare_points(view, points, camera, cfg)


def _query(points, means3d, scales, rotations, opacities, camera: Camera,
           cfg: RasterConfig, alive):
    """Median ray distance of each point -> (m_t [Q], in_range [Q], Query)."""
    qr = prepare_query(points, means3d, scales, rotations, opacities, camera, cfg, alive)
    fwd, bwd = sample_ref.sample_fwd_rows, sample_ref.sample_bwd_rows
    res = SampleDepth.apply(precision.stage(qr.feats, cfg), qr.pts, qr.binning.tile_start,
                                        qr.binning.tile_count, qr.blocks, cfg, fwd, bwd)
    res = precision.stage(res, cfg)
    q = points.shape[0]
    m_t = res.new_zeros(q).index_copy(0, qr.sorted_q, res[0])
    in_range = torch.zeros(q, dtype=torch.bool, device=res.device)
    in_range[qr.sorted_q] = res[1].detach() > 0
    return m_t, in_range, qr


def sample_depth(points: torch.Tensor, means3d, scales, rotations, opacities,
                 camera: Camera, cfg: RasterConfig, alive=None) -> dict:
    """Differentiable cross-view median-depth sampling.

    Args:
      points: [Q,3] world-space query points (gradients flow into them).
      means3d/scales/rotations/opacities: gaussian parameters (scales and
        opacities post-activation, 3D-filtered; raw quaternions).

    Returns dict(point_cam [Q,3] in the camera frame, sampled_depth [Q]
    z-depth, inside [Q] bool, max_tile_count: the view's largest tile list,
    a Python int; lists are clamped at `cfg.max_per_tile`)."""
    md, in_r, qr = _query(points, means3d, scales, rotations, opacities, camera, cfg,
                          alive)
    pnx = (qr.px - (camera.width - 1) / 2.0) / camera.fx
    pny = (qr.py - (camera.height - 1) / 2.0) / camera.fy
    rln = torch.rsqrt(pnx * pnx + pny * pny + 1.0)
    depth = md * rln
    point_cam = torch.stack([pnx * depth, pny * depth, depth], -1)
    return dict(point_cam=point_cam, sampled_depth=depth, inside=in_r & qr.inside0,
                max_tile_count=qr.binning.max_tile_count)


class SampleDepth(torch.autograd.Function):
    """Copy of gsjax_torch/ops/sample_cuda.py:SampleDepth: rows = fwd(feats,
    ..., pts, ...), with (d(feats), d(pts)) = bwd(..., rows, d(rows[0]))."""

    @staticmethod
    def forward(ctx, feats, pts, tile_start, tile_count, blocks, cfg, fwd, bwd):
        res = fwd(feats, tile_start, tile_count, pts, blocks, cfg)
        ctx.save_for_backward(feats, pts, tile_start, tile_count, blocks, res)
        ctx.args = (cfg, bwd)
        return res

    @staticmethod
    def backward(ctx, grad_res):
        feats, pts, tile_start, tile_count, blocks, res = ctx.saved_tensors
        cfg, bwd = ctx.args
        d_feats, d_pts = bwd(feats, tile_start, tile_count, pts, blocks, res,
                             grad_res[0].contiguous(), cfg)
        return (d_feats, d_pts) + (None,) * 6
