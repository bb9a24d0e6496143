"""The port's golden-scene quality CLIs (`gsjax_torch.golden_quality`,
`quality_r04`, `blobs_mesh_ab`) against gsjax's scripts, at 64x48 on the CPU.

- `write_rendered_colmap(points_noise=0.03)`: cameras.bin, images.bin and
  points3D.bin equal to gsjax's byte for byte (the same numpy stream); each
  view's render within the colour tolerance of tests/test_torch_render.py
  (3e-5) of gsjax's with one chunk per tile list, and its PNG that render's
  8-bit levels except where the value lies within 3e-5 of a step;
  `build_nearest_view_graph`: equal to gsjax's without `radius` and with
  it (both take the argument and ignore it: ROADMAP queue C).
- Scoring parity: a checkpoint of the scene's true gaussians at
  `--iterations` sits where each package's golden script resumes from it,
  so neither trains and both score the same model on the same scene:
  test PSNR within 0.01 dB, the TSDF chamfer and its two halves within 2%,
  the TSDF mesh's vertices within 2%, the tetra chamfer within 2% with the
  port meshing from gsjax's tetra points (an ulp of difference in a point
  can make Qhull triangulate degenerate points otherwise,
  tests/test_torch_mesh.py), the JSON key sets equal.
- Resume: a run stopped after 3 steps and resumed ends bit-equal to an
  uninterrupted one (Python's `random` seeded before each run, as gsjax's
  script does not); a checkpoint with `active_sh = 2`, `active_sg = 2`
  resumes at those degrees, one without them at an uninterrupted run's;
  the run's directory is keyed by the NCC form (GSJAX_NCC_COMPACT).
- `quality_r04`: the three sub-runs' argument lists equal gsjax's, and the
  merge's `reg_chamfer_improvement` and `pass` equal gsjax's on the same
  sub-run results (`run` replaced; nothing trains).
- `blobs_mesh_ab` on a checkpoint of a tiny blobs scene: gsjax's row keys
  and grid order, and on the grid point gsjax's script also runs, its
  chamfer, both halves and the vertex count within 2% of gsjax's.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import random
import runpy
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.data import readers as jreaders
from gsjax.data import synth as jsynth
from gsjax.mesh import extract as jextract
from gsjax.train.loop import Trainer as JTrainer
from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster import render as jrender
from gsjax.ops.raster.camera import Camera as JCamera
from gsjax_torch import blobs_mesh_ab, golden_quality, quality_r04
from gsjax_torch.data import readers as treaders
from gsjax_torch.data import synth as tsynth
from gsjax_torch.mesh import extract as textract
from gsjax_torch.model.gaussians import adam_init, params_from_numpy
from gsjax_torch.model.io import save_checkpoint
from gsjax_torch.train.loop import Trainer

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H, N_IMAGES, N_GAUSS = 64, 48, 8, 300
PSNR_ATOL, CHAMFER_RTOL, VERTS_RTOL = 0.01, 0.02, 0.02
RENDER_ATOL = 3e-5     # colour, tests/test_torch_render.py


class _Stop(Exception):
    pass


def _write(writer, root, g, pose_fn, **kw):
    writer(str(root), n_images=N_IMAGES, width=W, height=H, gaussians=g, pose_fn=pose_fn,
           points_noise=0.03, max_per_tile=1 << 10, **kw)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The sphere scene written by each package's writer."""
    root = tmp_path_factory.mktemp("golden")
    g = jsynth.sphere_gaussians(N_GAUSS)
    _write(jsynth.write_rendered_colmap, root / "gsjax", g, jsynth.ring_pose,
           pair_capacity=1 << 18)
    _write(tsynth.write_rendered_colmap, root / "port", g, tsynth.ring_pose, device="cpu")
    return root, g


def test_scene_files_match_gsjax(scenes):
    root, g = scenes
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        want = (root / "gsjax" / "sparse" / "0" / name).read_bytes()
        assert (root / "port" / "sparse" / "0" / name).read_bytes() == want, name
    from PIL import Image

    # gsjax's writer renders with its default chunk of 64, whose march resumes
    # a stopped pixel at the next chunk (ROADMAP queue C): the port is held
    # to gsjax's render with one chunk per list, as tests/test_torch_render.py
    fx = 0.9 * W
    fovx, fovy = 2 * np.arctan(W / (2 * fx)), 2 * np.arctan(H / (2 * fx))
    poses = [tsynth.ring_pose(i, N_IMAGES) for i in range(N_IMAGES)]
    cfg = JConfig(chunk=-(-N_GAUSS // 64) * 64, pair_capacity=1 << 18, max_per_tile=1 << 10,
                  sh_degree=0, require_depth=False, backend="ref")
    args = tuple(map(jnp.asarray, g))
    port = tsynth._render_views(g, poses, fovx, fovy, W, H, 1 << 10, "cpu")
    for i, ((r, t), (rgb, _)) in enumerate(zip(poses, port)):
        if i % 4:
            continue
        want = np.asarray(jrender(*args, JCamera.create(r.T, t, fovx, fovy, W, H), cfg,
                                  jnp.zeros(3))["render"])
        np.testing.assert_allclose(rgb, want, atol=RENDER_ATOL)
        png = np.asarray(Image.open(root / "port" / "images" / f"img_{i:03d}.png"))
        level = np.clip(want, 0, 1) * 255
        off = png != level.astype(np.uint8)
        # 8-bit levels apart only where gsjax's value lies within the render
        # tolerance of a quantisation step
        assert np.all(np.abs(level[off] - np.round(level[off])) <= RENDER_ATOL * 255), i


def test_points_noise_moves_the_points(scenes):
    root, g = scenes
    from gsjax_torch.data.colmap import read_points3d_binary

    xyz = read_points3d_binary(str(root / "port" / "sparse" / "0" / "points3D.bin"))[0]
    d = xyz - g[0][::3]
    assert 0.02 < d.std() < 0.04


def _graph(readers, scene_dir, **kw):
    views = readers.load_scene(scene_dir, "images", None, eval_split=True,
                               **({"device": "cpu"} if readers is treaders else {})).train_views
    readers.build_nearest_view_graph(views, 60, 0.01, 1.5, 8, **kw)
    return [v.nearest_ids for v in views]


def test_nearest_view_graph_radius(scenes):
    """8 views 45 degrees apart: within 60 degrees, 2.45 apart, so no
    neighbour at 1.5, and two at 1.5 scene radii were `radius` to scale the
    distances as gsjax's docstring says. Both packages ignore it."""
    root, _ = scenes
    scene_dir = str(root / "gsjax")
    r = float(jreaders.load_scene(scene_dir, "images", None, eval_split=True).radius)
    want = _graph(jreaders, scene_dir)
    assert _graph(treaders, scene_dir) == want
    assert _graph(treaders, scene_dir, radius=r) == _graph(jreaders, scene_dir, radius=r) == want
    scaled = [v.nearest_ids for v in jreaders.build_nearest_view_graph(
        jreaders.load_scene(scene_dir, "images", None, eval_split=True).train_views,
        60, 0.01 * r, 1.5 * r, 8)]
    assert scaled != want


def _true_ckpt(path, g, iteration, extra=None, sh_degree=3):
    """A checkpoint of the gaussians `g` (all alive) at `iteration`."""
    means, scales, quats, opac, shs = g
    n = len(means)
    rest = (sh_degree + 1) ** 2 - 1
    params = dict(xyz=means, features_dc=shs[:, :1], features_rest=shs[:, 1:1 + rest],
                  opacity=np.log(opac / (1 - opac)), scaling=np.log(scales),
                  rotation=quats, sg_axis=np.tile(np.float32([[[0, 0, 1]]]), (n, 1, 1)),
                  sg_sharpness=np.zeros((n, 1), np.float32),
                  sg_color=np.zeros((n, 1, 3), np.float32))
    aux = dict(alive=np.ones(n, bool), filter_3d=np.zeros(n, np.float32),
               grad_accum=np.zeros(n), grad_accum_abs=np.zeros(n),
               denom=np.zeros(n), max_radii=np.zeros(n, np.int32))
    p, a = params_from_numpy(params, aux, "cpu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_checkpoint(path, p, a, adam_init(p), iteration, extra)


SW, SH, SN, SG = 48, 32, 4, 150       # the scoring scene: 3 train views, 1 test
GOLDEN = ["--iterations", "5", "--width", str(SW), "--height", str(SH), "--n_images",
          str(SN), "--n_gauss", str(SG), "--sh_degree", "3", "--tetra"]


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """Both golden scripts scoring the true gaussians of a scene that gsjax's
    writer made."""
    tmp = tmp_path_factory.mktemp("scored")
    g = jsynth.sphere_gaussians(SG)
    jsynth.write_rendered_colmap(str(tmp / "scene"), n_images=SN, width=SW, height=SH,
                                 gaussians=g, pose_fn=jsynth.ring_pose, points_noise=0.03,
                                 pair_capacity=1 << 18, max_per_tile=1 << 10)
    mp = pytest.MonkeyPatch()
    mp.setattr(tempfile, "tempdir", str(tmp))
    argv = GOLDEN + ["--scene_dir", str(tmp / "scene")]
    args = golden_quality.build_parser().parse_args(argv)
    jdir = os.path.join(str(tmp), f"gsjax_golden_out_{SW}x{SH}_n{SN}_g{SG}_i5_sg0"
                                  f"_no_sphere_sh3")
    for d in (jdir, golden_quality.model_dir(args)):
        _true_ckpt(os.path.join(d, "golden_ckpt.npz"), g, 5)
    points = {}
    jget = jextract.get_tetra_points

    def record(*a, **kw):
        points["gsjax"] = jget(*a, **kw)
        return points["gsjax"]

    mp.setattr(jextract, "get_tetra_points", record)
    # gsjax renders with one chunk per tile list (its chunked march resumes
    # a stopped pixel; ROADMAP queue C): no list is longer than the model
    jcfg = JTrainer.raster_cfg
    mp.setattr(JTrainer, "raster_cfg", lambda self, require_depth: dataclasses.replace(
        jcfg(self, require_depth), chunk=-(-SG // 64) * 64))
    mp.setattr(textract, "get_tetra_points", lambda *a, **kw: tuple(
        torch.as_tensor(np.asarray(x)) for x in points["gsjax"]))
    mp.setattr(sys, "argv", ["golden_quality.py", "--platform", "cpu",
                             "--out", str(tmp / "gsjax.json")] + argv)
    try:
        runpy.run_path(str(ROOT / "scripts" / "golden_quality.py"), run_name="__main__")
        port, stats = golden_quality.main(argv + ["--device", "cpu",
                                                  "--out", str(tmp / "port.json")])
    finally:
        mp.undo()
    want = json.load(open(tmp / "gsjax.json"))
    return want, json.load(open(tmp / "port.json")), port, stats


def test_scores_match_gsjax(scored):
    want, got, returned, stats = scored
    assert got == returned and set(got) == set(want)
    assert stats["resumed_at"] == 5 and stats["steps_trained"] == 0
    assert got["step_ms_device"] is None and want["step_ms_device"] is None
    assert abs(got["test_psnr_db"] - want["test_psnr_db"]) <= PSNR_ATOL
    for k in ("chamfer", "chamfer_d2s", "chamfer_s2d", "chamfer_tetra"):
        assert got[k] == pytest.approx(want[k], rel=CHAMFER_RTOL), k
    assert got["mesh_vertices"] == pytest.approx(want["mesh_vertices"], rel=VERTS_RTOL)
    same = ("scene", "iterations", "sg_degree", "appearance", "n_train_views",
            "n_test_views", "n_gaussians_final", "no_reg", "reset_interval", "sh_degree",
            "cluster_to_keep", "mesh_min_opacity", "thresholds", "pass")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}


@pytest.mark.parametrize("fn,dist", [
    ("sphere", lambda v: np.abs(np.linalg.norm(v, axis=1) - 1.0)),
    ("blobs", jsynth.blobs_surface_distance)])
def test_chamfer_of_matches_gsjax_formula(fn, dist):
    rng = np.random.default_rng(3)
    verts = rng.normal(0, 1.2, (500, 3))
    ch, d2s, s2d, n = golden_quality.chamfer_of(verts, fn)
    from scipy.spatial import cKDTree

    crop = verts[np.linalg.norm(verts, axis=1) <= {"sphere": 2.0, "blobs": 2.5}[fn]]
    samples = (golden_quality.sphere_surface_samples() if fn == "sphere"
               else jsynth.blobs_surface_samples())
    assert n == len(crop)
    assert d2s == pytest.approx(float(np.mean(dist(crop))), rel=1e-12)
    assert s2d == pytest.approx(float(np.mean(cKDTree(crop).query(samples)[0])), rel=1e-12)
    assert ch == pytest.approx(0.5 * (d2s + s2d), rel=1e-12)
    assert golden_quality.chamfer_of(np.zeros((0, 3)), fn) == (
        float("inf"), float("inf"), float("inf"), 0)


RESUME = ["--iterations", "6", "--width", "48", "--height", "32", "--n_images", "24",
          "--n_gauss", "600", "--sg_degree", "2", "--device", "cpu"]


def _run_until(argv, stop_at=None):
    """The golden CLI on `argv` until it stops training (or after step
    `stop_at`); returns the metrics of the steps it ran."""
    steps = []

    def on_step(trainer, m):
        steps.append(m)
        if trainer.iteration == stop_at:
            raise _Stop

    def on_stage(name, trainer):
        if name == "device_step":
            raise _Stop

    with pytest.raises(_Stop):
        golden_quality.main(argv, on_step=on_step, on_stage=on_stage)
    return steps


def test_resume_is_bit_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = RESUME + ["--scene_dir", str(tmp_path / "scene")]
    ckpt = os.path.join(golden_quality.model_dir(
        golden_quality.build_parser().parse_args(argv)), "golden_ckpt.npz")
    random.seed(7)
    whole = _run_until(argv)
    assert any(m["near"] is not None for m in whole), "no multi-view step"
    want = dict(np.load(ckpt))
    os.remove(ckpt)
    random.seed(7)
    assert len(_run_until(argv, stop_at=3)) == 3
    assert int(np.load(ckpt)["iteration"]) == 2
    random.seed(123)        # the checkpoint restores the stream
    resumed = _run_until(argv)
    assert [m["loss"] for m in resumed] == [m["loss"] for m in whole[2:]]
    got = dict(np.load(ckpt))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_model_dir_keyed_by_ncc_form(monkeypatch):
    """A run with the compacted NCC never resumes a default run's checkpoint."""
    args = golden_quality.build_parser().parse_args(RESUME)
    monkeypatch.delenv("GSJAX_NCC_COMPACT", raising=False)
    dense = golden_quality.model_dir(args)
    monkeypatch.setenv("GSJAX_NCC_COMPACT", "0")
    assert golden_quality.model_dir(args) == dense
    monkeypatch.setenv("GSJAX_NCC_COMPACT", "1")
    assert golden_quality.model_dir(args) != dense


@pytest.mark.parametrize("saved", [{"active_sh": 2, "active_sg": 2}, {}])
def test_resume_degrees(tmp_path, monkeypatch, saved):
    """A checkpoint with the degrees resumes at them; one without them (as
    gsjax writes it) at those an uninterrupted run has at its iteration."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    it = 2500
    argv = ["--iterations", str(it), "--width", str(W), "--height", str(H),
            "--n_images", str(N_IMAGES), "--n_gauss", "60", "--sh_degree", "3",
            "--sg_degree", "2", "--device", "cpu", "--scene_dir", str(tmp_path / "scene")]
    args = golden_quality.build_parser().parse_args(argv)
    _true_ckpt(os.path.join(golden_quality.model_dir(args), "golden_ckpt.npz"),
               jsynth.sphere_gaussians(60), it, {k: np.asarray(v) for k, v in saved.items()})
    seen = {}

    def on_stage(name, trainer):
        seen.update(sh=trainer.active_sh, sg=trainer.active_sg, it=trainer.iteration)
        raise _Stop

    with pytest.raises(_Stop):
        golden_quality.main(argv, on_stage=on_stage)
    assert seen == {"sh": 2, "sg": 2, "it": it}


def _load_gsjax_quality():
    spec = importlib.util.spec_from_file_location(
        "gsjax_quality_r04", ROOT / "scripts" / "quality_r04.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("results", [
    {"main": {"chamfer": 0.0184, "pass": True}, "noreg": {"chamfer": 0.0206, "pass": True},
     "blobs": {"chamfer": 0.328, "pass": True}},
    {"main": {"chamfer": 0.0206, "pass": True}, "noreg": {"chamfer": 0.0184, "pass": True},
     "blobs": {"chamfer": 0.328, "pass": True}},
    {"main": {"chamfer": 0.0184, "pass": True}, "noreg": {"chamfer": 0.0206, "pass": True},
     "blobs": {"chamfer": 0.35, "pass": False}},
    {"main": None, "noreg": {"chamfer": 0.0206, "pass": True},
     "blobs": {"chamfer": 0.328, "pass": True}}],
    ids=["pass", "reg_worse", "blobs_miss", "main_missing"])
def test_quality_r04_matches_gsjax(tmp_path, monkeypatch, results):
    tags = ("main", "noreg", "blobs")
    calls = {"gsjax": [], "port": []}

    def fake(side):
        def run(args_list, out, *rest):
            calls[side].append(list(args_list))
            return results[tags[len(calls[side]) - 1]]
        return run

    jq = _load_gsjax_quality()
    monkeypatch.setattr(jq, "run", fake("gsjax"))
    monkeypatch.setattr(sys, "argv", ["quality_r04.py", "--out", str(tmp_path / "j.json")])
    jq.main()
    monkeypatch.setattr(quality_r04, "run", fake("port"))
    got = quality_r04.main(["--out", str(tmp_path / "t.json"), "--device", "cpu"])
    assert calls["port"] == calls["gsjax"] and len(calls["gsjax"]) == 3
    want = json.load(open(tmp_path / "j.json"))
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cpu" and got["main_sphere_repeats"] == []


def test_quality_r04_repeats_main_from_scratch(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(quality_r04, "run",
                        lambda args_list, out, device: seen.append((args_list, out, device)))
    quality_r04.main(["--out", str(tmp_path / "q.json"), "--device", "cpu",
                      "--repeat_main", "1"])
    assert len(seen) == 4 and seen[3][0] == seen[0][0] + ["--no_resume"]
    assert [os.path.basename(s[1]) for s in seen] == [
        "q_main.json", "q_noreg.json", "q_blobs.json", "q_main_repeat0.json"]
    assert all(s[2] == "cpu" for s in seen)


def test_blobs_mesh_ab_matches_gsjax(tmp_path, monkeypatch):
    """The blobs' two spheres without the background shell (whose TSDF grid
    would take minutes on the CPU), 3 training views at 48x32."""
    g = jsynth.blobs_gaussians(400)
    g = tuple(a[np.linalg.norm(g[0], axis=1) <= 2.5] for a in g)
    ring = lambda i, n: jsynth.ring_pose(i, n, radius=4.2, height_amp=1.1,
                                         target=(0.7, 0.1, 0.25))
    scene = tmp_path / "scene"
    jsynth.write_rendered_colmap(str(scene), n_images=SN, width=SW, height=SH,
                                 gaussians=g, pose_fn=ring, max_per_tile=1 << 10)
    model = tmp_path / "model"
    _true_ckpt(str(model / "golden_ckpt.npz"), g, 2400)
    # gsjax on one point of the grid (its cost is mostly compilation), the
    # port on four; min_weight 1: with 3 views a higher weight keeps a few
    # scraps whose distance to the surface moves with any pixel of the depth
    one = ["--opacities", "0.0", "--min_weights", "1", "--clusters", "3"]
    grid = ["--opacities", "0.0,0.3", "--min_weights", "1", "--clusters", "3,6"]
    base = ["--model_dir", str(model), "--scene_dir", str(scene)]
    # one chunk per tile list in gsjax's render (ROADMAP queue C)
    jcfg = JTrainer.raster_cfg
    monkeypatch.setattr(JTrainer, "raster_cfg", lambda self, require_depth: dataclasses.replace(
        jcfg(self, require_depth), chunk=-(-len(g[0]) // 64) * 64))
    monkeypatch.setattr(sys, "argv", ["blobs_mesh_ab.py", "--out", str(tmp_path / "j.json")]
                        + base + one)
    runpy.run_path(str(ROOT / "scripts" / "blobs_mesh_ab.py"), run_name="__main__")
    (want,) = json.load(open(tmp_path / "j.json"))
    got = blobs_mesh_ab.main(base + grid + ["--out", str(tmp_path / "t.json"),
                                            "--device", "cpu"])
    assert json.load(open(tmp_path / "t.json")) == got
    assert [(r["min_opacity"], r["min_weight"], r["clusters"]) for r in got] == [
        (0.0, 1.0, 3), (0.0, 1.0, 6), (0.3, 1.0, 3), (0.3, 1.0, 6)]
    assert all(set(r) == set(want) for r in got)
    a = got[0]
    assert want["nverts"] > 0
    for k in ("chamfer", "d2s", "s2d"):
        assert a[k] == pytest.approx(want[k], rel=CHAMFER_RTOL, abs=1e-4), (k, a, want)
    assert a["nverts"] == pytest.approx(want["nverts"], rel=VERTS_RTOL)


def test_trainer_restores_gsjax_checkpoint_degrees(tmp_path):
    """load_golden_ckpt on a checkpoint that lacks the degrees: SH follows
    the steps of 1000 up to the run's degree, SG unlocks at 1000."""
    g = jsynth.sphere_gaussians(60)
    scene_dir = tmp_path / "scene"
    tsynth.write_rendered_colmap(str(scene_dir), n_images=4, width=32, height=32,
                                 gaussians=g, device="cpu")
    scene = treaders.load_scene(str(scene_dir), device="cpu")
    for it, sh, sg in ((999, 0, 0), (1000, 1, 2), (3500, 3, 2), (9000, 3, 2)):
        tr = Trainer.create(scene, None, str(tmp_path), "cpu", sh_degree=3, sg_degree=2)
        path = str(tmp_path / f"c{it}.npz")
        _true_ckpt(path, g, it)
        assert golden_quality.load_golden_ckpt(tr, path) == it
        assert (tr.active_sh, tr.active_sg) == (sh, sg)
