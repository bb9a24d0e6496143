"""The port's Blender (NeRF-synthetic) reader and the CLIs on a Blender scene,
against gsjax on the same files.

- `read_blender_scene`: images, R, T, fovx, fovy, the split sizes, the
  initial points and colours and the camera radius equal to gsjax's (the same
  PIL and numpy operations in the same order), with and without a
  `points3d.ply`, with the composite over black and over white (`-w`), and at
  `resolution=2` (PIL's LANCZOS resize); without a `points3d.ply` both write
  the same one;
- `load_scene` dispatches a `transforms_train.json` scene to it, and loads
  its test split whatever `eval_split` says, as gsjax's does (ROADMAP queue
  C); a directory with neither layout raises as gsjax's does;
- `write_rendered_blender` round-trips through the reader: the composite over
  black gives the render back to 8 bits, pose and fov equal;
- the training CLI (`--eval -w --device cpu`) against gsjax's (`train.py`)
  on a rendered Blender scene, the same flags and seed, each from its own
  copy of the scene without a `points3d.ply` (the reader's random points;
  a second read takes the PLY's 8-bit colours, ROADMAP queue C). With `-w`
  both reset every opacity (seen through the 3D filter) to at most 0.01 at
  `densify_from_iter` (3) and prune at 0.05 at the next densification (5),
  which empties the model:
    - per-step losses within rtol 1e-5 (read: 4e-7);
    - the densify counts equal, on step 5 and on no other;
    - the PLY saved at step 3, after the reset, within 1e-5 (read: 6e-6) on
      at least 98% of the gaussians, field by field, and within 0.016 on
      the rest. Adam's first steps move a parameter by about its lr however
      small its gradient, so a gaussian that barely reaches a pixel, whose
      gradient is at float-noise level, may step either way in either
      package: 3 steps of the largest lr (scaling, 0.005) bound that (read:
      3 of 300 f_dc_0 values 0.0034 apart where the scene's points3d.ply
      was written before the copies, none where the reader draws them).
      The rotation's vector part is all noise: the initial gaussians are
      isotropic, so its true gradient is 0; both packages keep it below 3
      steps of the rotation lr (read: 0.0016), the scalar part to 1e-5;
    - the PLY saved at step 5 empty in both;
- the TSDF mesh CLI against gsjax's (`mesh_extract.py`) on the scene's
  ground-truth model, at `-r 2` (48x32 frames). gsjax runs with one chunk
  per tile list (a `RasterConfig` whose `chunk` is 512, above the 450
  gaussians): at its default chunk its march resumes a stopped pixel
  (ROADMAP queue C, tests/test_torch_render.py), which moves the median
  depth of this saturated scene by up to 0.05. Then:
    - the vertices of `recon.ply` and `recon_post.ply` within 2e-5 (read:
      8.5e-6; the median depths agree within 2.4e-6 and the TSDF's edge
      interpolation scales that);
    - the faces equal as vertex sets, but for faces of area below 1e-8
      (the median face has ~1e-3): at a voxel corner whose TSDF is ~0 the
      edge vertices around it (nearly) coincide, and which zero-area faces
      are emitted there follows that value's float sign (read: 2 such
      faces in gsjax's meshes and none in the port's);
    - `recon_post.ply` lies on the two foreground spheres (median
      `blobs_surface_distance` below 0.15; read 0.109 from 4 views of 450
      foreground gaussians whose tangent discs, 1-sigma radius ~0.16, sag
      off the spheres, as the sphere scene's 400 do in
      tests/test_torch_mesh.py).
"""

import dataclasses
import json
import os
import shutil
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from chip_smoke import bench_params, blobs_foreground
from gsjax.data import readers as jreaders
from gsjax_torch import mesh_extract as tsdf_cli
from gsjax_torch import train as train_cli
from gsjax_torch.config import dump_cfg_args
from gsjax_torch.data import readers as treaders
from gsjax_torch.data.ply import read_ply, write_pointcloud
from gsjax_torch.data.synth import blobs_surface_distance, ring_pose, write_rendered_blender
from gsjax_torch.model.io import save_ply
from gsjax_torch.ops.raster import Camera, RasterConfig, render

torch.set_num_threads(1)

W, H = 96, 64


def blender_c2w(i, n):
    """ring_pose as a Blender transform_matrix (c2w, y up, z back)."""
    r_w2c, tvec = ring_pose(i, n)
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = r_w2c, tvec
    c2w = np.linalg.inv(w2c)
    c2w[:3, 1:3] *= -1
    return c2w


def write_random_blender(root, n_train=4, n_test=2, seed=0, with_ply=False):
    """A Blender scene of seeded random RGBA PNGs on a ring of poses."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    n = n_train + n_test
    for split, ids in (("train", range(n_train)), ("test", range(n_train, n))):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for k, i in enumerate(ids):
            img = (rng.random((H, W, 4)) * 255).astype(np.uint8)
            img[: H // 4, :, 3] = 255          # opaque, transparent and
            img[H // 4: H // 2, :, 3] = 0      # partial alpha rows
            Image.fromarray(img, "RGBA").save(os.path.join(root, split, f"r_{k}.png"))
            frames.append({"file_path": f"./{split}/r_{k}",
                           "transform_matrix": blender_c2w(i, n).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    if with_ply:
        pts = rng.normal(0, 1, (200, 3)).astype(np.float32)
        cols = (rng.random((200, 3)) * 255).astype(np.uint8)
        write_pointcloud(os.path.join(root, "points3d.ply"), pts, cols)


def assert_scenes_equal(got, want):
    assert len(got.train_views) == len(want.train_views)
    assert len(got.test_views) == len(want.test_views)
    for a, b in zip(got.train_views + got.test_views, want.train_views + want.test_views):
        assert (a.uid, a.image_name, a.width, a.height) == (b.uid, b.image_name,
                                                            b.width, b.height)
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        assert (a.fovx, a.fovy) == (b.fovx, b.fovy)
        assert a.mask is None and b.mask is None
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.radius == want.radius


@pytest.mark.parametrize("with_ply,white,resolution", [
    (False, False, -1), (True, False, -1), (False, True, -1), (True, True, 2)],
    ids=["random_points", "ply_points", "white", "ply_white_res2"])
def test_read_blender_scene_matches_gsjax(tmp_path, monkeypatch, with_ply, white,
                                          resolution):
    monkeypatch.setenv("GSJAX_BLENDER_INIT_POINTS", "300")
    write_random_blender(str(tmp_path / "a"), with_ply=with_ply)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    want = jreaders.read_blender_scene(str(tmp_path / "a"), white, True, resolution)
    got = treaders.read_blender_scene(str(tmp_path / "b"), white, True, resolution,
                                      device="cpu")
    assert_scenes_equal(got, want)
    assert got.train_views[0].width == (W if resolution == -1 else W // 2)
    assert len(got.points) == (200 if with_ply else 300)
    # without a points3d.ply both readers write the same one
    for d in ("a", "b"):
        assert os.path.exists(tmp_path / d / "points3d.ply")
    assert (tmp_path / "a" / "points3d.ply").read_bytes() == \
        (tmp_path / "b" / "points3d.ply").read_bytes()
    cam = got.train_views[0].camera
    assert cam.device == torch.device("cpu") and (cam.width, cam.height) == (
        got.train_views[0].width, got.train_views[0].height)


@pytest.mark.parametrize("eval_split", [False, True])
def test_load_scene_dispatches_blender(tmp_path, monkeypatch, eval_split):
    monkeypatch.setenv("GSJAX_BLENDER_INIT_POINTS", "300")
    write_random_blender(str(tmp_path / "a"))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    want = jreaders.load_scene(str(tmp_path / "a"), eval_split=eval_split,
                               white_background=True)
    got = treaders.load_scene(str(tmp_path / "b"), eval_split=eval_split,
                              white_background=True, device="cpu")
    assert_scenes_equal(got, want)
    assert len(got.test_views) == 2          # loaded whatever eval_split says
    os.makedirs(tmp_path / "empty")
    for reader, kw in ((jreaders, {}), (treaders, {"device": "cpu"})):
        with pytest.raises(ValueError, match="transforms_train.json"):
            reader.load_scene(str(tmp_path / "empty"), **kw)


@pytest.fixture(scope="module")
def blobs_blender(tmp_path_factory):
    """A rendered 4 + 2-view 96x64 Blender scene of the blobs foreground
    (600 gaussians, 450 kept) and its ground-truth model at iteration 7."""
    root = tmp_path_factory.mktemp("blobs")
    scene, model_dir = str(root / "scene"), str(root / "gt_model")
    g = blobs_foreground(600)
    write_rendered_blender(scene, n_train=4, n_test=2, width=W, height=H, fovx=0.9,
                           gaussians=g, device="cpu")
    save_ply(os.path.join(model_dir, "point_cloud", "iteration_7", "point_cloud.ply"),
             *bench_params(g, "cpu"))
    dump_cfg_args(model_dir, Namespace(
        sh_degree=3, sg_degree=0, source_path=scene, model_path=model_dir,
        images="images", masks="", resolution=-1, white_background=True,
        eval=True, kernel_size=0.0))
    return scene, model_dir, g


def test_rendered_blender_round_trips(blobs_blender, monkeypatch):
    monkeypatch.setenv("GSJAX_BLENDER_INIT_POINTS", "300")
    scene, _, g = blobs_blender
    info = treaders.read_blender_scene(scene, white_background=False, device="cpu")
    assert [v.image_name for v in info.test_views] == ["r_0", "r_1"]
    cfg = RasterConfig(sh_degree=0, require_depth=False)
    args = tuple(torch.as_tensor(a) for a in g)
    for k, v in ((0, info.test_views[0]), (4, info.train_views[2])):
        r_w2c, tvec = ring_pose(k, 6)
        np.testing.assert_allclose(v.R, r_w2c.T, atol=1e-6)
        np.testing.assert_allclose(v.T, tvec, atol=1e-6)
        cam = Camera.create(r_w2c.T, tvec, 0.9, v.fovy, W, H, device="cpu")
        with torch.no_grad():
            want = render(*args, cam, cfg, torch.zeros(3))["render"].numpy()
        assert np.abs(v.image - np.clip(want, 0, 1)).max() < 2.5 / 255
    assert info.train_views[0].fovx == pytest.approx(0.9)


TRAIN_FLAGS = ["--eval", "-w", "--iterations", "5", "--densify_from_iter", "3",
               "--densification_interval", "5", "--densify_until_iter", "11",
               "--regularization_from_iter", "7", "--lambda_multi_view_ncc", "0",
               "--lambda_multi_view_geo", "0", "--save_iterations", "3", "5", "--seed", "0"]
COUNTS = ("n_alive", "n_cloned", "n_split", "n_pruned", "n_dropped")


@pytest.fixture(scope="module")
def train_runs(blobs_blender, tmp_path_factory):
    """The port's and gsjax's training CLIs, 5 steps each with TRAIN_FLAGS,
    each on its own copy of the Blender scene (no points3d.ply yet)."""
    import train as jtrain_cli
    from gsjax.train import loop as jloop

    scene, _, _ = blobs_blender
    root = tmp_path_factory.mktemp("train")
    for d in ("port_scene", "gsjax_scene"):
        shutil.copytree(scene, root / d)
        (root / d / "points3d.ply").unlink(missing_ok=True)    # another test's read wrote it
    ports, gsj = [], []
    step = jloop.Trainer.step

    def recording_step(self):
        m = step(self)
        gsj.append({"loss": float(m["loss"]), "densify": m.get("densify")})
        return m

    mp = pytest.MonkeyPatch()
    mp.setenv("GSJAX_BLENDER_INIT_POINTS", "300")
    try:
        trainer = train_cli.main(
            ["-s", str(root / "port_scene"), "-m", str(root / "port"), *TRAIN_FLAGS,
             "--test_iterations", "5", "--device", "cpu"],
            on_step=lambda t, m: ports.append(m))
        mp.setattr(jloop.Trainer, "step", recording_step)
        mp.setattr(sys, "argv", ["train.py", "-s", str(root / "gsjax_scene"), "-m",
                                 str(root / "gsjax"), *TRAIN_FLAGS, "--test_iterations", "99",
                                 "--ip", ""])
        jtrain_cli.main()
    finally:
        mp.undo()
    return str(root), trainer, ports, gsj


def _ply(path):
    return {k: np.asarray(v) for k, v in read_ply(path).items()}


def test_train_cli_on_blender(train_runs):
    root, trainer, ports, _ = train_runs
    out = os.path.join(root, "port")
    assert len(ports) == 5 and np.isfinite([m["loss"] for m in ports]).all()
    assert trainer.white_background
    assert len(trainer.scene.train_views) == 4 and len(trainer.scene.test_views) == 2
    v = read_ply(os.path.join(out, "point_cloud", "iteration_3", "point_cloud.ply"))
    assert len(v["x"]) == 300 and np.isfinite(v["x"]).all()
    with open(os.path.join(out, "cameras.json")) as f:
        assert len(json.load(f)) == 6


def test_train_cli_on_blender_matches_gsjax(train_runs):
    root, _, ports, gsj = train_runs
    assert len(gsj) == 5
    np.testing.assert_allclose([m["loss"] for m in ports], [m["loss"] for m in gsj],
                               rtol=1e-5)
    assert [i for i, m in enumerate(gsj) if m["densify"]] == [4]
    assert [i for i, m in enumerate(ports) if m.get("densify")] == [4]
    want, got = gsj[4]["densify"], ports[4]["densify"]
    assert {k: int(got[k]) for k in COUNTS} == {k: int(want[k]) for k in COUNTS}
    assert want["n_alive"] == 0 and want["n_pruned"] == 300

    ply = os.path.join("point_cloud", "iteration_{}", "point_cloud.ply")
    a = _ply(os.path.join(root, "port", ply.format(3)))
    b = _ply(os.path.join(root, "gsjax", ply.format(3)))
    assert sorted(a) == sorted(b) and len(a["x"]) == 300
    rot_noise = ("rot_1", "rot_2", "rot_3")
    for k in b:
        if k in rot_noise:
            assert np.abs(a[k]).max() < 3e-3 and np.abs(b[k]).max() < 3e-3, k
        else:
            close = np.isclose(a[k], b[k], rtol=1e-5, atol=1e-5)
            assert close.mean() >= 0.98, (k, np.flatnonzero(~close))
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=0.016, err_msg=k)
    # the reset: every opacity seen through the 3D filter at most 0.01
    for p in (a, b):
        sq = np.exp(2 * np.stack([p[f"scale_{i}"] for i in range(3)], 1).astype(np.float64))
        coef = np.sqrt(sq.prod(1) / (sq + p["filter_3D"][:, None] ** 2).prod(1))
        assert (coef / (1 + np.exp(-p["opacity"].astype(np.float64)))).max() <= 0.01 + 1e-7
    for d in ("port", "gsjax"):
        assert len(read_ply(os.path.join(root, d, ply.format(5)))["x"]) == 0


def _face_areas(verts, faces):
    v = verts[faces].astype(np.float64)
    return 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=1)


def _faces_apart(verts, faces, other):
    """The faces of (verts, faces) whose vertex set is no face of `other`,
    and their areas."""
    theirs = {tuple(r) for r in np.sort(other, 1)}
    apart = np.array([tuple(r) not in theirs for r in np.sort(faces, 1)], bool)
    return faces[apart], _face_areas(verts, faces[apart])


def test_tsdf_mesh_cli_on_blender(blobs_blender, tmp_path, monkeypatch):
    import mesh_extract as jmesh_cli
    from gsjax.ops import raster as jraster

    scene, model_dir, _ = blobs_blender
    gsjax_dir = str(tmp_path / "gsjax_model")
    shutil.copytree(model_dir, gsjax_dir)
    meshes = tsdf_cli.main(["-m", model_dir, "-r", "2", "--voxel_size", "0.06", "--device", "cpu"])

    @dataclasses.dataclass(frozen=True)
    class OneChunk(jraster.RasterConfig):
        chunk: int = 512

    monkeypatch.setattr(jraster, "RasterConfig", OneChunk)
    monkeypatch.setattr(sys, "argv", ["mesh_extract.py", "-m", gsjax_dir, "-r", "2",
                                      "--voxel_size", "0.06"])
    jmesh_cli.main()
    for name in ("recon", "recon_post"):
        got, gf = _read_mesh(os.path.join(model_dir, f"{name}.ply"))
        want, wf = _read_mesh(os.path.join(gsjax_dir, f"{name}.ply"))
        assert len(gf) > 100 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5, err_msg=name)
        only_port, port_areas = _faces_apart(got, gf, wf)
        only_gsjax, gsjax_areas = _faces_apart(want, wf, gf)
        assert len(only_port) + len(only_gsjax) <= 8, (name, only_port, only_gsjax)
        assert (port_areas < 1e-8).all() and (gsjax_areas < 1e-8).all(), name
        assert np.median(_face_areas(got, gf)) > 1e-4
    verts, faces = _read_mesh(os.path.join(model_dir, "recon_post.ply"))
    np.testing.assert_array_equal(verts, meshes["post"][0].astype(np.float32))
    np.testing.assert_array_equal(faces, meshes["post"][1])
    assert np.median(blobs_surface_distance(verts)) < 0.15


def _read_mesh(path):
    v = read_ply(path)
    return np.stack([v["x"], v["y"], v["z"]], 1), np.asarray(v["__faces__"])
