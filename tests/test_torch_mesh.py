"""The port's meshing (`gsjax_torch.mesh`, both CLIs) against gsjax's, on the
same seeded numpy inputs.

- `get_tetra_points`: within 1e-6 of the points' scale (float32 rotations
  and an einsum in another order), with and without the opacity cull;
- `triangulate`: equal (the same Qhull call);
- `marching_tetrahedra`: exactly equal, edges in their order and faces, on
  the sphere SDF of tests/test_mesh.py:14 (its int64 edge key sorts as
  gsjax's `np.unique(axis=0)`);
- `post_process_mesh` / `cull_mesh`: equal on tests/test_mesh.py's cases;
- `fuse_tsdf`: tsdf, weight and colour within 1e-6 of gsjax's, the grid
  equal and the origin within 1e-12 (the port backprojects the depth maps
  on their device, where the 3x3 rotation's float64 sums may round in
  another order), on the six-view sphere of tests/test_mesh.py:46;
  `tsdf_to_mesh`: faces equal and vertices within 1e-6;
- `evaluate_alpha_cull`: `valid` equal and the sdf within 2e-5, the
  integrate's tolerance against gsjax's XLA path (test_torch_integrate.py),
  on two views, one with a gt mask; gsjax runs with one chunk per tile list
  (its chunked march resumes a stopped point, ROADMAP queue C);
- `extract_mesh_tetrahedra` on gsjax's 60-gaussian, 64x64 scene
  (tests/test_mesh.py:100, 2 binary-search steps), both from gsjax's tetra
  points (an ulp of difference in a point can make Qhull pick another
  triangulation at degenerate points, so the stages after it are compared
  on identical inputs): the initial mesh equal, the raw mesh finite with
  each vertex within 1e-5 of gsjax's (the binary search reads sdf signs,
  which the two evaluation orders may flip at a crossing: a flip would move
  a vertex by a quarter of its edge; read: the raw meshes are equal);
- both CLIs with `--device cpu` on a small written scene of 400 gaussians
  tangent to the unit sphere: the PLYs load back, non-empty, finite, with
  the median | |v| - 1 | below 0.12. The 400 discs (1-sigma radius 0.16)
  lie outside the sphere away from their centres, so the alpha-0.5 and
  median-depth surfaces sit ~0.05 outside it (the render's median depth
  at the centre pixel reads 0.055 short of the analytic sphere); the
  meshes read 0.078 (both routes).
"""

import dataclasses
import os
from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from gsjax.mesh import cluster as jcluster
from gsjax.mesh import extract as jextract
from gsjax.mesh.delaunay import triangulate as jtriangulate
from gsjax.mesh.tetra import marching_tetrahedra as jmarching
from gsjax.model import gaussians as jgm
from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster.camera import Camera as JCamera
from gsjax_torch import mesh_extract as tsdf_cli
from gsjax_torch import mesh_extract_tetrahedra as tetra_cli
from gsjax_torch.config import dump_cfg_args
from gsjax_torch.data.ply import read_ply
from gsjax_torch.data.synth import ring_pose, sphere_gaussians, write_rendered_colmap
from gsjax_torch.mesh import cluster as tcluster
from gsjax_torch.mesh import extract as textract
from gsjax_torch.mesh.delaunay import triangulate
from gsjax_torch.mesh.tetra import marching_tetrahedra
from gsjax_torch.model import gaussians as tgm
from gsjax_torch.model.io import save_ply
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster.camera import Camera as TCamera
from tests.test_train_step import make_model
from tests.util import random_gaussians

torch.set_num_threads(1)


class V:
    """A view as the meshing routes read it: a camera and an optional mask."""

    def __init__(self, camera, mask=None):
        self.camera = camera
        self.mask = mask


def _leaves(tree):
    return {f.name: np.array(getattr(tree, f.name)) for f in dataclasses.fields(tree)}


def _both(jp, ja):
    """gsjax's model and the port's, from the same leaves."""
    return (jp, ja), tgm.params_from_numpy(_leaves(jp), _leaves(ja), "cpu")


def _cams(r, t, fovx, fovy, w, h):
    return (JCamera.create(r, t, fovx, fovy, w, h),
            TCamera.create(r, t, fovx, fovy, w, h, device="cpu"))


def _opaque_model(n=60, capacity=100, seed=4):
    """tests/test_mesh.py:100's model (gsjax's init_from_pcd) with the
    opacities, scales and rotations of `random_gaussians`, so the alpha field
    crosses 0.5."""
    jp, ja = make_model(n=n, capacity=capacity, seed=seed)
    _, scales, q, op, _ = random_gaussians(n, seed=seed + 1)
    leaves = _leaves(jp)
    leaves["opacity"][:n, 0] = np.log(op / (1 - op)) + 1.0
    leaves["scaling"][:n] = np.log(scales * 1.5)
    leaves["rotation"][:n] = q
    return _both(jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in leaves.items()}), ja)


@pytest.mark.parametrize("min_opacity", [0.0, 0.5])
def test_get_tetra_points_matches_gsjax(min_opacity):
    (jp, ja), (tp, ta) = _opaque_model()
    want_pts, want_s = jextract.get_tetra_points(jp, ja, min_opacity)
    got_pts, got_s = textract.get_tetra_points(tp, ta, min_opacity)
    assert 0 < len(want_pts) <= 60 * 15 and (min_opacity == 0) == (len(want_pts) == 60 * 15)
    scale = np.abs(want_pts).max()
    np.testing.assert_allclose(got_pts.numpy(), want_pts, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-6 * want_s.max())


@pytest.mark.parametrize("partial", [False, True], ids=["all_valid", "some_invalid"])
def test_marching_tetrahedra_equals_gsjax(partial):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.5, 1.5, (4000, 3)).astype(np.float32)
    cells = jtriangulate(pts)
    np.testing.assert_array_equal(triangulate(pts), cells)
    sdf = np.linalg.norm(pts, axis=1) - 1.0
    scales = rng.uniform(0.01, 0.1, len(pts)).astype(np.float32)
    valid = rng.uniform(size=len(pts)) > 0.1 if partial else np.ones(len(pts), bool)
    want = jmarching(pts, cells.astype(np.int64), sdf, scales, valid)
    got = marching_tetrahedra(torch.as_tensor(pts), torch.as_tensor(cells, dtype=torch.int64),
                              torch.as_tensor(sdf), torch.as_tensor(scales),
                              torch.as_tensor(valid))
    assert len(want[3]) > 500
    for name, w, g in zip(("edge_verts", "edge_sdf", "edge_scales", "faces", "edge_ids"),
                          want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_post_process_mesh_equals_gsjax():
    v_big = np.random.default_rng(1).normal(0, 1, (80, 3))
    f_big = np.stack([np.zeros(78, int), np.arange(1, 79), np.arange(2, 80)], -1)
    verts = np.concatenate([v_big, v_big + 100])
    faces = np.concatenate([f_big, np.array([[0, 1, 2]]) + 80])
    for keep in (1, 2):
        w, g = (m.post_process_mesh(verts, faces, keep) for m in (jcluster, tcluster))
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    assert len(g[1]) == 78


def test_cull_mesh_equals_gsjax():
    jcam, tcam = _cams(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                       0.9, 0.9, 32, 32)
    verts = np.array([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0], [0.0, 0.1, 2.0],
                      [0.0, 0.0, -2.0], [0.1, 0.0, -2.0], [0.0, 0.1, -2.0]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    depth = np.full((32, 32), 1.0, np.float32)
    for depths, n_faces in ((None, 1), ([depth], 0)):
        w = jcluster.cull_mesh(verts, faces, [jcam], depths=depths)
        g = tcluster.cull_mesh(verts, faces, [V(tcam)],
                               depths=None if depths is None else [torch.as_tensor(depth)])
        assert len(g[1]) == n_faces
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def _sphere_depths(radius=0.5, w=64, h=64):
    """tests/test_mesh.py:46's six analytic depth maps of a sphere."""
    views, depths = [], []
    for axis in range(6):
        eye = np.zeros(3)
        eye[axis % 3] = 2.0 * (1 if axis < 3 else -1)
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0, 0, 1.0]) if axis % 3 != 2 else np.array([0, 1.0, 0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        R = np.stack([right, down, forward], axis=1)
        T = -R.T @ eye
        jcam, tcam = _cams(R.astype(np.float32), T.astype(np.float32), 0.6, 0.6, w, h)
        xs = (np.arange(w) - (w - 1) / 2) / float(jcam.fx)
        ys = (np.arange(h) - (h - 1) / 2) / float(jcam.fy)
        dirs = np.stack(np.broadcast_arrays(xs[None, :], ys[:, None], np.ones((h, w))), -1)
        dirs_n = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        b = -2.0 * dirs_n[..., 2]
        disc = b * b - (4.0 - radius * radius)
        t = -b - np.sqrt(np.maximum(disc, 0))
        depths.append(np.where(disc > 0, t * dirs_n[..., 2], 0.0).astype(np.float32))
        views.append((jcam, tcam))
    return views, depths


def test_fuse_tsdf_and_tsdf_to_mesh_match_gsjax(monkeypatch):
    views, depths = _sphere_depths()
    rng = np.random.default_rng(2)
    colors = [rng.uniform(0, 1, (64, 64, 3)).astype(np.float32) for _ in depths]
    want = jextract.fuse_tsdf(depths, colors, [V(j) for j, _ in views], voxel_size=0.025,
                              verbose=False, with_color=True)
    got = textract.fuse_tsdf([torch.as_tensor(d) for d in depths],
                             [torch.as_tensor(c) for c in colors], [V(t) for _, t in views],
                             voxel_size=0.025, verbose=False, with_color=True)
    assert got[0].shape == want[0].shape and want[0].size > 10_000
    for name, w, g in zip(("tsdf", "weight", "color"), want[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12, atol=0)
    assert got[4] == want[4]
    wv, wf = jextract.tsdf_to_mesh(*(want[i] for i in (0, 1, 3, 4)))
    monkeypatch.setattr(textract, "SLAB_CUBES", 5000)     # several x-slabs
    gv, gf = textract.tsdf_to_mesh(got[0], got[1], got[3], got[4])
    assert len(wf) > 1000
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
    assert abs(np.median(np.linalg.norm(gv, axis=1)) - 0.5) < 0.05


def _two_views(w=96, h=64):
    """Two views of tests/util.py's scene, the second turned 0.3 rad, with a
    gt mask over its left two thirds."""
    out = []
    for angle, mask in ((0.0, None), (0.3, np.zeros((h, w), np.float32))):
        c, s = np.cos(angle), np.sin(angle)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        jcam, tcam = _cams(r, np.zeros(3, np.float32), 0.9, 0.7, w, h)
        if mask is not None:
            mask[:, : 2 * w // 3] = 1.0
        out.append((V(jcam, mask), V(tcam, mask)))
    return out


def test_evaluate_alpha_cull_matches_gsjax():
    (jp, ja), (tp, ta) = _opaque_model()
    pts, _ = jextract.get_tetra_points(jp, ja)
    views = _two_views()
    jcfg = JConfig(tile=32, chunk=256, tile_batch=2, pair_capacity=1 << 14,
                   max_per_tile=256, backend="ref")
    want_sdf, want_valid = jextract.evaluate_alpha_cull(pts, jp, ja, [j for j, _ in views],
                                                        jcfg)
    got_sdf, got_valid = textract.evaluate_alpha_cull(
        torch.as_tensor(pts), tp, ta, [t for _, t in views],
        TConfig(tile=32, chunk=256, max_per_tile=256), chunk_size=256)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    assert 0.2 < want_valid.mean() < 1.0
    assert (want_sdf < 0).any() and (want_sdf[want_valid] > 0).any()
    np.testing.assert_allclose(got_sdf.numpy(), want_sdf, rtol=0, atol=2e-5)


def test_extract_mesh_tetrahedra_matches_gsjax(monkeypatch):
    (jp, ja), (tp, ta) = _opaque_model()
    pts, scale = jextract.get_tetra_points(jp, ja)
    monkeypatch.setattr(textract, "get_tetra_points",
                        lambda *a: (torch.as_tensor(pts), torch.as_tensor(scale)))
    jcam, tcam = _cams(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0.9, 0.7, 64, 64)
    jcfg = JConfig(tile=32, chunk=256, tile_batch=2, pair_capacity=1 << 14,
                   max_per_tile=256, sh_degree=0)
    tcfg = TConfig(tile=32, chunk=256, max_per_tile=256, sh_degree=0)
    want = jextract.extract_mesh_tetrahedra(jp, ja, [V(jcam)], jcfg, n_binary_steps=2,
                                            verbose=False)
    got = textract.extract_mesh_tetrahedra(tp, ta, [V(tcam)], tcfg, n_binary_steps=2,
                                           verbose=False)
    assert set(got["seconds"]) == {"tetra_points", "triangulation", "alpha_field",
                                   "marching_tetrahedra", "binary_search", "post_process"}
    np.testing.assert_array_equal(got["init"][1], want["init"][1])
    np.testing.assert_allclose(got["init"][0], want["init"][0], rtol=0, atol=1e-6)
    gv, gf = got["raw"]
    wv, wf = want["raw"]
    assert len(wf) > 100 and np.isfinite(gv).all()
    assert gf.min() >= 0 and gf.max() < len(gv)
    for a, b in ((gv, wv), (wv, gv)):
        dist, _ = cKDTree(b).query(a)
        assert dist.max() <= 1e-5, dist.max()


@pytest.fixture(scope="module")
def sphere_model(tmp_path_factory):
    """A 4-view 96x64 ring scene of 400 sphere gaussians and its PLY."""
    root = tmp_path_factory.mktemp("mesh")
    scene, model_dir = str(root / "scene"), str(root / "model")
    g = sphere_gaussians(400, seed=1)
    write_rendered_colmap(scene, n_images=4, width=96, height=64, gaussians=g,
                          pose_fn=ring_pose, device="cpu")
    means, scales, quats, opac, shs = g
    n = len(means)
    params = dict(xyz=means, features_dc=shs[:, :1], features_rest=shs[:, 1:],
                  opacity=np.log(opac / (1 - opac)), scaling=np.log(scales),
                  rotation=quats, sg_axis=np.zeros((n, 1, 3), np.float32),
                  sg_sharpness=np.zeros((n, 1), np.float32),
                  sg_color=np.zeros((n, 1, 3), np.float32))
    aux = dict(alive=np.ones(n, bool), filter_3d=np.zeros(n, np.float32),
               grad_accum=np.zeros(n), grad_accum_abs=np.zeros(n),
               denom=np.zeros(n), max_radii=np.zeros(n, np.int32))
    save_ply(os.path.join(model_dir, "point_cloud", "iteration_5", "point_cloud.ply"),
             *tgm.params_from_numpy(params, aux, "cpu"))
    dump_cfg_args(model_dir, Namespace(
        sh_degree=3, sg_degree=0, source_path=scene, model_path=model_dir,
        images="images", masks="", resolution=-1, white_background=False,
        eval=False, kernel_size=0.0))
    return scene, model_dir


def _load_mesh(path):
    v = read_ply(path)
    return np.stack([v["x"], v["y"], v["z"]], 1), v["__faces__"]


@pytest.mark.parametrize("route", ["tetrahedra", "tsdf"])
def test_cli_writes_meshes_on_the_sphere(sphere_model, route):
    scene, model_dir = sphere_model
    if route == "tetrahedra":
        meshes = tetra_cli.main(["-s", scene, "-m", model_dir, "--device", "cpu"])
        names = ("recon_init", "recon", "recon_post")
    else:
        meshes = tsdf_cli.main(["-s", scene, "-m", model_dir, "--voxel_size", "0.04",
                                "--cull", "--device", "cpu"])
        names = ("recon", "recon_post")
    for name in names:
        verts, faces = _load_mesh(os.path.join(model_dir, f"{name}.ply"))
        assert len(verts) > 50 and len(faces) > 50, name
        assert np.isfinite(verts).all() and faces.max() < len(verts), name
    verts, _ = _load_mesh(os.path.join(model_dir, "recon_post.ply"))
    np.testing.assert_array_equal(verts, meshes["post"][0].astype(np.float32))
    assert np.median(np.abs(np.linalg.norm(verts, axis=1) - 1.0)) < 0.12
