"""Mesh extraction routes (port of `gsjax/mesh/extract.py`).

Two routes matching the reference:
  - `extract_mesh_tetrahedra` (TnT): gaussian corner points -> Delaunay (on
    the host) -> alpha-field SDF (0.5 - min-view integrated alpha, kernel B4)
    -> marching tetrahedra -> 10-step binary search -> scale filter ->
    cluster filter (mesh_extract_tetrahedra.py:105-181);
  - `extract_mesh_tsdf` (DTU): render median depth for all train views
    (kernel B1) and fuse into a dense TSDF voxel grid, extract via marching
    tetrahedra over the grid (mesh_extract.py:40-90; open3d's VoxelBlockGrid
    replaced by a dense fusion, plain torch on the device, as gsjax's jit).

Tensors stay on the model's device from the tetra points to the final
vertices; the triangulation and the cluster filter run on the host, as in
gsjax and the reference. The alpha field evaluates one fixed model at the
first pass and at each binary-search step: each view's pair payload
(`ops.sample.prepare_view`) is built once per extraction and reused, which
gives the same values as building it at every call (gsjax does). Each route
returns host-clock stage times (`seconds`, after a device synchronise).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gsjax_torch.core.quaternion import normalize, to_rotation_matrix
from gsjax_torch.mesh.cluster import post_process_mesh
from gsjax_torch.mesh.delaunay import triangulate
from gsjax_torch.mesh.tetra import marching_tetrahedra
from gsjax_torch.model import gaussians as gm
from gsjax_torch.ops.raster.config import RasterConfig
from gsjax_torch.ops.sample import integrate_view, prepare_view


class _Clock:
    """Host-clock stage times; each `lap` first waits for the device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}
        self._t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        t = self._now()
        self.seconds[name] = self.seconds.get(name, 0.0) + t - self._t
        self._t = t


# --- tetra points (scene/gaussian_model.py:495-519) --------------------------

_BOX_CORNERS = ((-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1),
                (1, -1, -1), (1, -1, 1), (1, 1, -1), (1, 1, 1))
_FACE_CENTERS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0), (0, 0, -1))


@torch.no_grad()
def get_tetra_points(params: gm.GaussianParams, aux: gm.GaussianAux,
                     min_opacity: float = 0.0):
    """8 box corners x1.5 + 6 face centers x3 per gaussian (filtered scales)
    + centres; per-vertex scale = 3 * max filtered scale. Returns (points
    [14N+N, 3], scales [14N+N]) float32 on the model's device.

    Non-finite gaussians are dropped (Delaunay rejects NaN); min_opacity > 0
    culls gaussians whose filtered opacity is below it first (free-space
    floaters otherwise seed tetra vertices)."""
    alive = aux.alive
    scale_all, opac_all = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    xyz = params.xyz[alive]
    scale = scale_all[alive]
    rot = to_rotation_matrix(normalize(params.rotation))[alive]
    ok = (torch.isfinite(xyz).all(1) & torch.isfinite(scale).all(1)
          & torch.isfinite(rot).flatten(1).all(1))
    if min_opacity > 0.0:
        ok = ok & (opac_all[:, 0][alive] >= min_opacity)
    xyz, scale, rot = xyz[ok], scale[ok], rot[ok]

    verts = torch.tensor(_BOX_CORNERS, dtype=torch.float32, device=xyz.device) * 1.5
    verts = torch.cat([verts, torch.tensor(_FACE_CENTERS, dtype=torch.float32,
                                           device=xyz.device) * 3.0])      # [14,3]
    local = verts[None, :, :] * scale[:, None, :]                          # [N,14,3]
    world = torch.einsum("nij,nkj->nki", rot, local) + xyz[:, None, :]
    pts = torch.cat([world.reshape(-1, 3), xyz])
    s = scale.amax(1) * 3.0
    return pts.contiguous(), torch.cat([s.repeat_interleave(14), s])


# --- alpha-cull SDF (mesh_extract_tetrahedra.py:64-87) -----------------------

def _sample_mask(camera, mask: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear gt-mask validation (mesh_extract_tetrahedra.py:44-61)."""
    wv = camera.world_view
    pc = pts @ wv[:3, :3].T + wv[:3, 3]
    z = torch.clamp_min(pc[:, 2], 1e-7)
    u = pc[:, 0] / z * camera.fx + camera.cx
    v_ = pc[:, 1] / z * camera.fy + camera.cy
    h, w = mask.shape
    ui = torch.clamp(u, 0, w - 1)
    vi = torch.clamp(v_, 0, h - 1)
    u0, v0 = torch.floor(ui).long(), torch.floor(vi).long()
    u1, v1 = torch.clamp_max(u0 + 1, w - 1), torch.clamp_max(v0 + 1, h - 1)
    fu, fv = ui - u0, vi - v0
    m = mask
    val = (m[v0, u0] * (1 - fu) * (1 - fv) + m[v0, u1] * fu * (1 - fv)
           + m[v1, u0] * (1 - fu) * fv + m[v1, u1] * fu * fv)
    return val > 0.5


@torch.no_grad()
def evaluate_alpha_cull(points: torch.Tensor, params, aux, views, cfg: RasterConfig,
                        chunk_size: int = 1 << 20, view_pairs: dict | None = None):
    """sdf = 0.5 - min over views of integrated alpha; invalid points -> 0.5.
    Returns (sdf [P] float32, valid [P] bool) on the points' device.

    Points go to the integrate in chunks of `chunk_size`, view by view.
    `view_pairs` caches each view's prepared pairs by view index: pass the
    same dict to every call on one model (the binary search does)."""
    dev = points.device
    n = points.shape[0]
    if n == 0:      # e.g. binary search on a mesh with no crossing edges
        return torch.zeros(0, device=dev), torch.zeros(0, dtype=torch.bool, device=dev)
    view_pairs = {} if view_pairs is None else view_pairs
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    final = torch.ones(n, device=dev)
    any_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    for vi, v in enumerate(views):
        if vi not in view_pairs:
            view_pairs[vi] = prepare_view(params.xyz, scales, params.rotation, opac,
                                          v.camera, cfg, aux.alive)
        mask = None if v.mask is None else torch.as_tensor(
            np.asarray(v.mask, np.float32), device=dev)
        for c0 in range(0, n, chunk_size):
            pts = points[c0:c0 + chunk_size]
            ret = integrate_view(view_pairs[vi], pts, v.camera, cfg)
            ok = ret["inside"]
            if mask is not None:
                ok = ok & _sample_mask(v.camera, mask, pts)
            sl = slice(c0, c0 + pts.shape[0])
            any_valid[sl] |= ok
            final[sl] = torch.where(ok, torch.minimum(ret["alpha"], final[sl]), final[sl])
    final = torch.where(any_valid, final, 0.0)
    return 0.5 - final, any_valid


def _to_np(mesh):
    v, f = mesh
    return v.cpu().numpy(), f.cpu().numpy()


@torch.no_grad()
def extract_mesh_tetrahedra(params, aux, views, cfg: RasterConfig,
                            n_binary_steps: int = 10, cluster_to_keep: int = 1,
                            min_opacity: float = 0.0, verbose=True):
    """Full tetra route. Returns dict of meshes (init/raw/post), each
    (vertices [V,3] float32, faces [F,3] int64) numpy; `counts`: tetra
    points, cells and crossing edges (the points of the first alpha-field
    pass and of each binary-search step); `seconds`: the stage split
    (tetra_points, triangulation, alpha_field, marching_tetrahedra,
    binary_search, post_process).
    min_opacity: optional pre-cull of low-opacity gaussians (floaters)
    before tetra-point generation (see get_tetra_points)."""
    dev = params.xyz.device
    clock = _Clock(dev)
    points, points_scale = get_tetra_points(params, aux, min_opacity)
    clock.lap("tetra_points")
    if verbose:
        print(f"tetra points: {len(points)}; triangulating...", flush=True)
    cells = torch.as_tensor(triangulate(points.cpu().numpy()), dtype=torch.int64,
                            device=dev)
    clock.lap("triangulation")
    if verbose:
        print(f"cells: {len(cells)}; evaluating alpha field...", flush=True)
    view_pairs = {}
    sdf, valid = evaluate_alpha_cull(points, params, aux, views, cfg,
                                     view_pairs=view_pairs)
    clock.lap("alpha_field")

    edge_verts, edge_sdf, edge_scales, faces, _ = marching_tetrahedra(
        points, cells, sdf, points_scale, valid)
    mesh_init = ((edge_verts[:, 0] + edge_verts[:, 1]) * 0.5, faces)
    clock.lap("marching_tetrahedra")

    left, right = edge_verts[:, 0].clone(), edge_verts[:, 1].clone()
    left_sdf, right_sdf = edge_sdf[:, 0].clone(), edge_sdf[:, 1].clone()
    distance = torch.linalg.norm(left - right, dim=-1)
    scale_sum = edge_scales[:, 0] + edge_scales[:, 1]

    for step in range(n_binary_steps):
        if verbose:
            print(f"binary search step {step}", flush=True)
        mid = (left + right) * 0.5
        mid_sdf, _ = evaluate_alpha_cull(mid, params, aux, views, cfg,
                                         view_pairs=view_pairs)
        low = ((mid_sdf < 0) & (left_sdf < 0)) | ((mid_sdf > 0) & (left_sdf > 0))
        left_sdf = torch.where(low, mid_sdf, left_sdf)
        right_sdf = torch.where(low, right_sdf, mid_sdf)
        left = torch.where(low[:, None], mid, left)
        right = torch.where(low[:, None], right, mid)
    verts = (left + right) * 0.5
    del view_pairs
    clock.lap("binary_search")

    # scale-based edge filter (mesh_extract_tetrahedra.py:166-169)
    vmask = distance <= scale_sum
    fmask = vmask[faces].all(dim=1)
    faces_f = faces[fmask]
    used = torch.unique(faces_f.reshape(-1))
    remap = torch.full((len(verts),), -1, dtype=torch.int64, device=dev)
    remap[used] = torch.arange(len(used), device=dev)
    mesh_raw = _to_np((verts[used], remap[faces_f]))
    mesh_post = post_process_mesh(*mesh_raw, cluster_to_keep)
    clock.lap("post_process")
    return dict(init=_to_np(mesh_init), raw=mesh_raw, post=mesh_post,
                counts=dict(points=len(points), cells=len(cells), edges=len(edge_verts)),
                seconds=clock.seconds)


# --- TSDF route (mesh_extract.py) --------------------------------------------

def _depth_bounds(depths, views, depth_trunc):
    """The AABB (lo, hi: numpy float64 [3]) of every view's valid depth
    pixels, backprojected to world space, in float64 on the depth maps'
    device: gsjax's numpy arithmetic op for op, except the 3x3 rotation
    product, whose sums may round in another order (an ulp of float64)."""
    mins, maxs = [], []
    for d, v in zip(depths, views):
        ys, xs = torch.nonzero((d > 0) & (d < depth_trunc), as_tuple=True)
        if ys.numel() == 0:
            continue
        cam = v.camera
        z = d[ys, xs].to(torch.float64)
        x = (xs.to(torch.float64) - cam.cx) / cam.fx * z
        y = (ys.to(torch.float64) - cam.cy) / cam.fy * z
        wv = cam.world_view.to(torch.float64)
        pw = (torch.stack([x, y, z], -1) - wv[:3, 3]) @ wv[:3, :3]
        mins.append(pw.amin(0))
        maxs.append(pw.amax(0))
    return (torch.stack(mins).amin(0).cpu().numpy(),
            torch.stack(maxs).amax(0).cpu().numpy())


@torch.no_grad()
def fuse_tsdf(depths, colors, views, voxel_size=0.002, depth_trunc=8.0,
              sdf_trunc=None, grid_bounds=None, max_voxels=64_000_000,
              verbose=True, with_color=False):
    """Dense TSDF fusion over an AABB derived from the depth maps.

    depths: list of [H,W] z-depth tensors (0 = invalid) on the device;
    colors: list of [H,W,3] tensors. Returns (tsdf [X,Y,Z], weight [X,Y,Z],
    color [3,X,Y,Z] or [1,1], origin (numpy float64 [3]), voxel_size), the
    grids float32 on the depth maps' device. The voxel is coarsened by 1.26x
    until the grid holds at most `max_voxels`; colour is fused only when
    asked (the meshing route discards it)."""
    dev = depths[0].device
    if sdf_trunc is None:
        sdf_trunc = 4 * voxel_size
    if grid_bounds is None:
        lo, hi = _depth_bounds(depths, views, depth_trunc)
        lo = lo - 4 * voxel_size
        hi = hi + 4 * voxel_size
    else:
        lo, hi = grid_bounds
    dims = np.maximum(np.ceil((hi - lo) / voxel_size).astype(int) + 1, 2)
    # bound memory: coarsen if necessary
    while np.prod(dims.astype(np.int64)) > max_voxels:
        voxel_size *= 1.26
        sdf_trunc = 4 * voxel_size
        dims = np.maximum(np.ceil((hi - lo) / voxel_size).astype(int) + 1, 2)
    if verbose:
        print(f"TSDF grid {dims} voxel={voxel_size:.4f}", flush=True)

    shape = tuple(int(d) for d in dims)
    tsdf = torch.zeros(shape, device=dev)
    weight = torch.zeros(shape, device=dev)
    color = torch.zeros(((3,) + shape) if with_color else (1, 1), device=dev)
    axis = lambda i: torch.as_tensor(
        (lo[i] + voxel_size * np.arange(dims[i])).astype(np.float32), device=dev)
    gx, gy, gz = axis(0)[:, None, None], axis(1)[None, :, None], axis(2)[None, None, :]

    for d, c, v in zip(depths, colors, views):
        cam = v.camera
        h, w = d.shape
        wv = cam.world_view
        px = wv[0, 0] * gx + wv[0, 1] * gy + wv[0, 2] * gz + wv[0, 3]
        py = wv[1, 0] * gx + wv[1, 1] * gy + wv[1, 2] * gz + wv[1, 3]
        pz = wv[2, 0] * gx + wv[2, 1] * gy + wv[2, 2] * gz + wv[2, 3]
        zc = torch.clamp_min(pz, 1e-7)
        u = px / zc * cam.fx + cam.cx
        v_ = py / zc * cam.fy + cam.cy
        del px, py, zc
        ui = torch.clamp(torch.round(u).to(torch.int64), 0, w - 1)
        vi = torch.clamp(torch.round(v_).to(torch.int64), 0, h - 1)
        pix = vi * w + ui
        del ui, vi
        dv = d.reshape(-1)[pix]
        valid = (pz > 0) & (u >= 0) & (u <= w - 1) & (v_ >= 0) & (v_ <= h - 1) & \
            (dv > 0) & (dv < depth_trunc)
        del u, v_
        sdf_val = dv - pz
        del dv, pz
        valid &= sdf_val > -sdf_trunc
        sdf_val = torch.clamp(sdf_val / sdf_trunc, -1.0, 1.0)
        wnew = weight + valid
        tsdf = torch.where(valid, (tsdf * weight + sdf_val) / torch.clamp_min(wnew, 1),
                           tsdf)
        if with_color:
            c3 = c.reshape(-1, 3)[pix].permute(3, 0, 1, 2)
            color = torch.where(valid[None],
                                (color * weight[None] + c3) / torch.clamp_min(wnew, 1)[None],
                                color)
        weight = wnew
        del valid, sdf_val, pix
    return tsdf, weight, color, np.asarray(lo, np.float64), float(voxel_size)


_CUBE_CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                 (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
_CUBE_TETS = ((0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
              (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6))


SLAB_CUBES = 1 << 23      # cubes per x-slab of `tsdf_to_mesh`'s active-cube selection


@torch.no_grad()
def tsdf_to_mesh(tsdf: torch.Tensor, weight: torch.Tensor, origin, voxel_size,
                 min_weight=1.0):
    """Extract the zero isosurface by marching tetrahedra over the grid
    (6 tets per cube). Functional equivalent of o3d extract_triangle_mesh.
    Returns (vertices [V,3] float64, faces [F,3] int64) numpy.

    Active cubes (every corner weighted, some corner inside the truncation
    band, both signs) are selected in x-slabs of at most SLAB_CUBES cubes,
    in gsjax's cube order, so no [cubes, 8] table over the whole grid is
    built."""
    dev = tsdf.device
    nx, ny, nz = tsdf.shape
    flat_t = tsdf.reshape(-1)
    flat_w = weight.reshape(-1)
    off = torch.tensor([(dx * ny + dy) * nz + dz for dx, dy, dz in _CUBE_CORNERS],
                       dtype=torch.int64, device=dev)
    yz = (torch.arange(ny - 1, device=dev)[:, None] * nz
          + torch.arange(nz - 1, device=dev)[None, :]).reshape(-1)
    slab = max(1, SLAB_CUBES // max(yz.numel(), 1))
    kept = []
    for x0 in range(0, nx - 1, slab):
        xs = torch.arange(x0, min(x0 + slab, nx - 1), device=dev)
        cids = ((xs[:, None] * ny * nz) + yz[None, :]).reshape(-1)[:, None] + off
        ct = flat_t[cids]
        active = (flat_w[cids] >= min_weight).all(1) & \
            (ct.abs() < 1.0 - 1e-6).any(1) & (ct > 0).any(1) & (ct < 0).any(1)
        kept.append(cids[active])
    cids = torch.cat(kept) if kept else torch.zeros(0, 8, dtype=torch.int64, device=dev)
    tets = cids[:, torch.tensor(_CUBE_TETS, device=dev)].reshape(-1, 4)

    ids = torch.arange(nx * ny * nz, device=dev)
    coords = torch.stack([ids // (ny * nz), (ids // nz) % ny, ids % nz], -1)
    verts_all = torch.as_tensor(origin, dtype=torch.float64, device=dev)[None, :] \
        + coords.to(torch.float64) * voxel_size
    del ids, coords
    valid = flat_w >= min_weight
    ev, es, _, faces, _ = marching_tetrahedra(
        verts_all, tets, flat_t, torch.zeros_like(flat_t), valid)
    if len(faces) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    # interpolate the crossing per edge
    s0, s1 = es[:, 0], es[:, 1]
    t = s0 / torch.where((s0 - s1).abs() > 1e-12, s0 - s1, 1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    verts = ev[:, 0] + t[:, None] * (ev[:, 1] - ev[:, 0])
    return verts.cpu().numpy(), faces.cpu().numpy()


@torch.no_grad()
def extract_mesh_tsdf(render_fn, views, voxel_size=0.002, depth_trunc=8.0,
                      cluster_to_keep=1, verbose=True):
    """TSDF route (mesh_extract.py:40-90): render all train views, fuse, mesh.
    Returns dict(raw, post: (vertices, faces) numpy; depths: the per-view
    median-depth tensors, masked; grid: the TSDF grid's shape; voxel_size;
    seconds: the stage split render, fuse, tsdf_to_mesh, post_process)."""
    depths, colors = [], []
    clock = _Clock(views[0].camera.device)
    for i, v in enumerate(views):
        out = render_fn(v)
        d = out["median_depth"]
        if v.mask is not None:
            d = torch.where(torch.as_tensor(np.asarray(v.mask), device=d.device) > 0.5,
                            d, 0.0)
        depths.append(d)
        colors.append(torch.clamp(out["render"], 0, 1))
        if verbose:
            print(f"\rrendered {i + 1}/{len(views)}", end="", flush=True)
    if verbose:
        print()
    clock.lap("render")
    lo, hi = _depth_bounds(depths, views, depth_trunc)
    clock.lap("bounds")
    tsdf, weight, _color, origin, vs = fuse_tsdf(
        depths, colors, views, voxel_size, depth_trunc, verbose=verbose,
        grid_bounds=(lo - 4 * voxel_size, hi + 4 * voxel_size))
    clock.lap("fuse")
    verts, faces = tsdf_to_mesh(tsdf, weight, origin, vs)
    grid = tuple(tsdf.shape)
    del tsdf, weight, _color
    clock.lap("tsdf_to_mesh")
    post = post_process_mesh(verts, faces, cluster_to_keep)
    clock.lap("post_process")
    return dict(raw=(verts, faces), post=post, depths=depths, grid=grid,
                voxel_size=vs, seconds=clock.seconds)
