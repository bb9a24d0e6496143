"""The port's evaluators (`gsjax_torch.eval.dtu`, `gsjax_torch.eval.tnt`) and
their CLIs against gsjax's, on synthetic files of a known surface (the blobs
scene's two spheres) made from a seed.

The port queries scipy's `cKDTree` where gsjax queries `sklearn.neighbors`.
Both return exact Euclidean distances from float64 coordinates, and both
count a neighbour at exactly the radius, so every result is held to rtol
1e-9 (read: equal), and the greedy downsample to equality, on inputs with
neighbours at exactly the radius. ICP is held to 1e-9 too: its nearest
neighbours are the same points, so each Kabsch step sees the same pairs.
"""

import json
import os
import runpy
import sys
from argparse import Namespace

import numpy as np
import pytest
from scipy.spatial import ConvexHull

import evaluate_dtu_mesh as root_dtu_cli
from gsjax.eval import dtu as jdtu
from gsjax.eval import tnt as jtnt
from gsjax_torch import eval_tnt as tnt_cli
from gsjax_torch import evaluate_dtu_mesh as dtu_cli
from gsjax_torch.config import dump_cfg_args
from gsjax_torch.data.ply import write_ply
from gsjax_torch.data.synth import (BLOBS_CENTERS, BLOBS_RADII, blobs_surface_samples,
                                    write_synthetic_dtu, write_synthetic_tnt,
                                    write_trajectory_log)
from gsjax_torch.eval import dtu as tdtu
from gsjax_torch.eval import tnt as ttnt
from tests.test_torch_blender import blender_c2w, write_random_blender

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9


def blobs_mesh(n=600, noise=0.01, seed=1):
    """A triangle mesh of the two blobs spheres (convex hulls of seeded
    samples), its vertices jittered off the surface by `noise`."""
    rng = np.random.default_rng(seed)
    verts, faces = [], []
    for c, r in zip(BLOBS_CENTERS, BLOBS_RADII):
        s = rng.normal(0, 1, (int(n * r), 3))
        s /= np.linalg.norm(s, axis=1, keepdims=True)
        faces.append(ConvexHull(s).simplices + sum(len(v) for v in verts))
        verts.append(r * s * (1 + rng.normal(0, noise, (len(s), 1))) + np.asarray(c))
    return np.concatenate(verts), np.concatenate(faces)


def similarity(seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(0, 1, (3, 3)))
    return scale, q * np.sign(np.linalg.det(q)), rng.normal(0, 10, 3)


def assert_dicts_close(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_sample_mesh_points_equals_gsjax():
    verts, faces = blobs_mesh()
    for thresh in (0.05, 0.2):
        want = jdtu.sample_mesh_points(verts * 3, faces, thresh)
        got = tdtu.sample_mesh_points(verts * 3, faces, thresh)
        np.testing.assert_array_equal(got, want)
        assert len(got) > len(verts)


@pytest.mark.parametrize("points", ["lattice", "mesh"])
def test_radius_downsample_equals_gsjax(points):
    if points == "lattice":
        # neighbours at exactly the radius: spacing 0.2 on a grid of 0.1
        pts = np.stack(np.meshgrid(*[np.arange(9) * 0.1] * 3, indexing="ij"),
                       -1).reshape(-1, 3)
    else:
        verts, faces = blobs_mesh()
        pts = tdtu.sample_mesh_points(verts * 3, faces, 0.2)
    want = jdtu.radius_downsample(pts, 0.2)
    got = tdtu.radius_downsample(pts, 0.2)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < len(pts)


@pytest.fixture(scope="module")
def dtu_files(tmp_path_factory):
    """Synthetic DTU files of the blobs surface under a known similarity, the
    ring's 8 camera centres as the first calibration centres."""
    root = str(tmp_path_factory.mktemp("dtu") / "Offical_DTU_Dataset")
    s, r, t = similarity()
    centers = np.stack([blender_c2w(i, 8)[:3, 3] for i in range(8)])
    write_synthetic_dtu(root, 24, centers, blobs_surface_samples(4000), s, r, t)
    return root, centers, (s, r, t)


def test_align_to_dtu_equals_gsjax(dtu_files):
    root, centers, (s, r, t) = dtu_files
    want_c = jdtu.load_dtu_calibration_centers(root)
    got_c = tdtu.load_dtu_calibration_centers(root)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_c[:8], s * centers @ r.T + t, rtol=0, atol=1e-9)
    want = jdtu.align_to_dtu(centers, want_c)
    got = tdtu.align_to_dtu(centers, got_c)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0] == pytest.approx(s, rel=1e-9)
    np.testing.assert_allclose(got[1], r, atol=1e-9)


def test_evaluate_mesh_chamfer_equals_gsjax(dtu_files):
    root, _, (s, r, t) = dtu_files
    verts, faces = blobs_mesh()
    verts = s * verts @ r.T + t
    want = jdtu.evaluate_mesh_chamfer(verts, faces, 24, root)
    got = tdtu.evaluate_mesh_chamfer(verts, faces, 24, root)
    assert_dicts_close(got, want)
    assert 0 < got["overall"] < 0.1 * s


def test_umeyama_icp_f1_equal_gsjax(tmp_path):
    rng = np.random.default_rng(2)
    a = rng.normal(0, 1, (40, 3))
    s, r, t = similarity(3, 2.5)
    b = s * a @ r.T + t
    for x, y in zip(ttnt.umeyama(a, b), jtnt.umeyama(a, b)):
        np.testing.assert_allclose(x, y, rtol=RTOL)
    assert ttnt.umeyama(a, b)[0] == pytest.approx(s, rel=1e-9)

    pts = blobs_surface_samples(20000, seed=3)
    moved = pts + np.array([0.02, -0.01, 0.015])
    got_t = ttnt.icp_point2point(moved, pts, max_dist=0.2)
    np.testing.assert_allclose(got_t, jtnt.icp_point2point(moved, pts, max_dist=0.2),
                               rtol=RTOL, atol=1e-12)
    assert np.abs(moved @ got_t[:3, :3].T + got_t[:3, 3] - pts).mean() < 0.005

    crop_path = str(tmp_path / "crop.json")
    with open(crop_path, "w") as f:
        json.dump({"orthogonal_axis": "Z", "axis_min": -0.8, "axis_max": 0.9,
                   "bounding_polygon": [[-1.1, -1.1, 0], [2.0, -1.1, 0],
                                        [2.0, 0.9, 0], [-1.1, 0.9, 0]]}, f)
    verts, faces = blobs_mesh()
    src = tdtu.sample_mesh_points(verts, faces, 0.05)
    tr = np.eye(4)
    tr[:3, 3] = [0.003, 0.0, -0.002]
    for crop in (None, crop_path):
        want, wd1, wd2 = jtnt.f1_score(src, pts, 0.05, crop and jtnt.CropVolume(crop), tr)
        got, gd1, gd2 = ttnt.f1_score(src, pts, 0.05, crop and ttnt.CropVolume(crop), tr)
        assert_dicts_close(got, want)
        np.testing.assert_allclose(gd1, wd1, rtol=RTOL)
        np.testing.assert_allclose(gd2, wd2, rtol=RTOL)
        assert gd1.shape == wd1.shape and gd2.shape == wd2.shape
        assert 50 < got["f1"] < 100


@pytest.fixture(scope="module")
def tnt_files(tmp_path_factory):
    """Synthetic TnT files of the blobs surface (crop around the foreground,
    identity `_trans.txt`, the ring's 8 cameras as both trajectories) and a
    jittered mesh of it. The scene is named Church for its tau, 0.025: the
    protocol samples the mesh at tau, and a smaller tau costs seconds."""
    root = tmp_path_factory.mktemp("tnt")
    data = str(root / "Church")
    c2ws = np.stack([blender_c2w(i, 8) for i in range(8)])
    write_synthetic_tnt(data, "Church", blobs_surface_samples(30000, seed=4), c2ws,
                        lo=(-1.2, -1.2, -1.2), hi=(2.2, 1.2, 1.2))
    traj = str(root / "recon.log")
    write_trajectory_log(traj, c2ws)
    verts, faces = blobs_mesh(noise=0.004)
    ply = str(root / "mesh" / "recon_post.ply")
    os.makedirs(os.path.dirname(ply))
    write_ply(ply, dict(x=verts[:, 0].astype(np.float32), y=verts[:, 1].astype(np.float32),
                        z=verts[:, 2].astype(np.float32)), faces=faces)
    return data, traj, ply, (verts.astype(np.float32).astype(np.float64), faces)


def test_run_tnt_evaluation_equals_gsjax(tnt_files, tmp_path, monkeypatch):
    data, traj, _, (verts, faces) = tnt_files
    want = jtnt.run_tnt_evaluation(verts, faces, data, "Church", traj, str(tmp_path / "j"))
    got = ttnt.run_tnt_evaluation(verts, faces, data, "Church", traj, str(tmp_path / "t"))
    assert_dicts_close(got, want)
    assert got["tau"] == 0.025 and got["f1"] > 50
    with open(tmp_path / "t" / "results.json") as f:
        assert_dicts_close(json.load(f), want)
    assert os.path.getsize(tmp_path / "t" / "Church_prf_curve.png") > 1000
    assert_dicts_close(ttnt.run_tnt_evaluation(verts, faces, data, "Church", traj), want)
    # without matplotlib: results.json is written, then the figure raises
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        ttnt.run_tnt_evaluation(verts, faces, data, "Church", traj, str(tmp_path / "n"))
    with open(tmp_path / "n" / "results.json") as f:
        assert_dicts_close(json.load(f), want)


def test_eval_tnt_cli_equals_root(tnt_files, tmp_path, monkeypatch):
    data, traj, ply, _ = tnt_files
    argv = ["--dataset-dir", data, "--traj-path", traj, "--ply-path", ply]
    monkeypatch.setattr(sys, "argv", ["run.py", *argv, "--out-dir", str(tmp_path / "j")])
    runpy.run_path(os.path.join(ROOT, "eval_tnt", "run.py"), run_name="__main__")
    got = tnt_cli.main([*argv, "--out-dir", str(tmp_path / "t")])
    with open(tmp_path / "j" / "results.json") as f:
        want = json.load(f)
    with open(tmp_path / "t" / "results.json") as f:
        assert_dicts_close(json.load(f), want)
    assert_dicts_close(got, want)
    assert os.path.exists(tmp_path / "t" / "Church_prf_curve.png")


def test_eval_tnt_cli_without_matplotlib(tnt_files, tmp_path, monkeypatch, capsys):
    """Where matplotlib does not import, the CLI writes results.json, says
    the figure was not drawn, and returns: the figure is all it leaves out."""
    data, traj, ply, (verts, faces) = tnt_files
    want = jtnt.run_tnt_evaluation(verts, faces, data, "Church", traj)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = tnt_cli.main(["--dataset-dir", data, "--traj-path", traj, "--ply-path", ply,
                        "--out-dir", str(tmp_path / "t")])
    assert_dicts_close(got, want)
    with open(tmp_path / "t" / "results.json") as f:
        assert_dicts_close(json.load(f), want)
    assert os.listdir(tmp_path / "t") == ["results.json"]
    assert "matplotlib does not import" in capsys.readouterr().out


def test_evaluate_dtu_mesh_cli_equals_root(dtu_files, tmp_path, monkeypatch):
    """Both CLIs on a Blender scene whose 8 ring cameras are the calibration's
    first centres, and a mesh of the surface in the scene's frame."""
    root, _, (s, _, _) = dtu_files
    monkeypatch.setenv("GSJAX_BLENDER_INIT_POINTS", "50")
    scene = str(tmp_path / "scan24")
    write_random_blender(scene, n_train=8, n_test=0)
    verts, faces = blobs_mesh()
    out = {}
    for side in ("root", "port"):
        model = str(tmp_path / side)
        os.makedirs(model)
        write_ply(os.path.join(model, "recon_post.ply"),
                  dict(x=verts[:, 0].astype(np.float32), y=verts[:, 1].astype(np.float32),
                       z=verts[:, 2].astype(np.float32)), faces=faces)
        dump_cfg_args(model, Namespace(
            sh_degree=3, sg_degree=0, source_path=scene, model_path=model,
            images="images", masks="", resolution=-1, white_background=False,
            eval=False, kernel_size=0.0))
        argv = ["-s", scene, "-m", model, "--DTU", root]
        if side == "root":
            # gsjax's CLI needs --scan_id (its fallback to the scene's name,
            # scan24, raises AttributeError; ROADMAP queue C); the port's reads
            # the name
            monkeypatch.setattr(sys, "argv", ["evaluate_dtu_mesh.py", *argv,
                                              "--scan_id", "24"])
            root_dtu_cli.main()
        else:
            got = dtu_cli.main([*argv, "--device", "cpu"])
        with open(os.path.join(model, "vis", "results.json")) as f:
            out[side] = json.load(f)
    assert_dicts_close(out["port"], out["root"])
    # the reader's float32 R and T move the centres by ~1e-7
    assert got["scale"] == pytest.approx(s, rel=1e-6)
    assert (tmp_path / "port" / "recon_aligned.ply").read_bytes() == \
        (tmp_path / "root" / "recon_aligned.ply").read_bytes()
