"""The port's flythrough (`gsjax_torch.utils.trajectories`) and the render
CLI's `--traj_frames` / `--video` against gsjax's.

- `generate_path` on the port's CPU cameras against gsjax's on the same
  poses: every camera's world->view and full projection within 1e-6, the
  same size and fov tangents, made on the reference camera's device;
- the render CLI with `--traj_frames 3 --save_depth --device cpu` on a
  Blender scene writes 3 frames of each kind under traj/ours_<it>/, from
  the cameras gsjax's `generate_path` makes of the scene's training views
  (1e-6); with `--video`, one .mp4 per kind where cv2 imports, and an error
  naming cv2 where it does not;
- `apply_depth_colormap`, `save_img_u8` and `save_img_f32` equal gsjax's;
  `create_videos` writes gsjax's files where cv2 imports.
"""

import os
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from chip_smoke import bench_params, blobs_foreground
from gsjax.data import readers as jreaders
from gsjax.ops.raster.camera import Camera as JCamera
from gsjax.utils import trajectories as jtraj
from gsjax_torch import render as render_cli
from gsjax_torch.config import dump_cfg_args
from gsjax_torch.data.synth import arc_pose, ring_pose
from gsjax_torch.model.io import save_ply
from gsjax_torch.ops.raster.camera import Camera as TCamera
from gsjax_torch.utils import trajectories as ttraj
from tests.test_torch_blender import write_random_blender

torch.set_num_threads(1)


def assert_cameras_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.world_view.numpy(), np.asarray(b.world_view),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.full_proj.numpy(), np.asarray(b.full_proj),
                                   rtol=0, atol=1e-6)
        assert (a.width, a.height) == (b.width, b.height)
        assert a.tan_fovx == pytest.approx(float(b.tan_fovx), rel=1e-6)
        assert a.tan_fovy == pytest.approx(float(b.tan_fovy), rel=1e-6)
        assert a.device == torch.device("cpu")


@pytest.mark.parametrize("pose_fn", [arc_pose, ring_pose], ids=["arc", "ring"])
def test_generate_path_matches_gsjax(pose_fn):
    tcams, jcams = [], []
    for i in range(8):
        r, t = pose_fn(i, 8)
        tcams.append(TCamera.create(r.T, t, 0.9, 0.7, 64, 48, device="cpu"))
        jcams.append(JCamera.create(r.T, t, 0.9, 0.7, 64, 48))
    got = ttraj.generate_path(tcams, n_frames=12)
    assert_cameras_close(got, jtraj.generate_path(jcams, n_frames=12))
    centres = np.stack([c.campos.numpy() for c in got])
    assert np.ptp(centres, axis=0).max() > 0.5


@pytest.fixture(scope="module")
def traj_model(tmp_path_factory, monkeypatch_module):
    """A 4 + 2-view 96x64 Blender scene and a 60-gaussian model of it."""
    monkeypatch_module.setenv("GSJAX_BLENDER_INIT_POINTS", "50")
    root = tmp_path_factory.mktemp("traj")
    scene, model = str(root / "scene"), str(root / "model")
    write_random_blender(scene)
    save_ply(os.path.join(model, "point_cloud", "iteration_3", "point_cloud.ply"),
             *bench_params(blobs_foreground(80), "cpu"))
    dump_cfg_args(model, Namespace(
        sh_degree=3, sg_degree=0, source_path=scene, model_path=model,
        images="images", masks="", resolution=-1, white_background=True,
        eval=True, kernel_size=0.0))
    return scene, model


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_render_cli_writes_the_flythrough(traj_model):
    scene, model = traj_model
    cams = {}
    render_cli.main(["-m", model, "--traj_frames", "3", "--save_depth", "--device", "cpu"],
                    on_view=lambda i, v, o: cams.setdefault(
                        "traj" if isinstance(v, render_cli._TrajView) else "set", []
                    ).append(v.camera))
    for name, n in (("train", 4), ("test", 2), ("traj", 3)):
        base = os.path.join(model, name, "ours_3")
        for kind in ("renders", "gt", "depth"):
            assert sorted(os.listdir(os.path.join(base, kind))) == [
                f"{i:05d}.png" for i in range(n)], (name, kind)
    jscene = jreaders.load_scene(scene, white_background=True)
    want = jtraj.generate_path([v.camera for v in jscene.train_views], n_frames=3)
    assert_cameras_close(cams["traj"], want)
    assert not [f for f in os.listdir(model) if f.endswith(".mp4")]


def test_render_cli_video(traj_model, monkeypatch):
    pytest.importorskip("cv2")
    _, model = traj_model
    render_cli.main(["-m", model, "--traj_frames", "3", "--skip_train", "--skip_test",
                     "--save_depth", "--video", "--device", "cpu"])
    for kind in ("renders", "depth", "gt"):
        assert os.path.getsize(os.path.join(model, f"traj_3_{kind}.mp4")) > 500
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        render_cli.main(["-m", model, "--traj_frames", "3", "--skip_train", "--skip_test",
                         "--video", "--device", "cpu"])


def test_image_helpers_match_gsjax(tmp_path):
    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 5, (16, 24)).astype(np.float32)
    depth[:3] = 0
    np.testing.assert_array_equal(ttraj.apply_depth_colormap(depth),
                                  jtraj.apply_depth_colormap(depth))
    np.testing.assert_array_equal(ttraj.apply_depth_colormap(depth, 1.0, 4.0),
                                  jtraj.apply_depth_colormap(depth, 1.0, 4.0))
    img = rng.uniform(-0.1, 1.1, (16, 24, 3))
    for mod, side in ((ttraj, "t"), (jtraj, "j")):
        mod.save_img_u8(img, str(tmp_path / f"{side}.png"))
        mod.save_img_f32(depth, str(tmp_path / f"{side}.tiff"))
    for ext in ("png", "tiff"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


def test_create_videos_matches_gsjax(tmp_path):
    pytest.importorskip("cv2")
    rset = tmp_path / "traj" / "ours_1"
    rng = np.random.default_rng(0)
    for kind in ("renders", "depth"):
        (rset / kind).mkdir(parents=True)
        for i in range(4):
            ttraj.save_img_u8(rng.uniform(0, 1, (32, 48, 3)), str(rset / kind / f"{i:05d}.png"))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = ttraj.create_videos(str(tmp_path / "t"), str(rset), "traj_1", num_frames=4)
    want = jtraj.create_videos(str(tmp_path / "j"), str(rset), "traj_1", num_frames=4)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "traj_1_renders.mp4", "traj_1_depth.mp4"]
    for p in got:
        assert os.path.getsize(p) > 500
