"""The port's numpy copies against gsjax's originals on the same seeded inputs:

- `blobs_gaussians`, `blobs_surface_distance`, `blobs_surface_samples` and
  the `BLOBS_*` constants equal bit for bit;
- `utils/mvs.py`: .dmb files written by either side read back equal by the
  other, `read_propagated_depth`'s cleanup and `load_pairs_relation` equal;
- `utils/llff.py`: `load_colmap_data`, `save_poses` (poses_bounds.npy),
  `minify` and `gen_poses` on an existing sparse model equal, and
  `gen_poses` runs the port's COLMAP driver where the model is missing;
- `convert.py`: the COLMAP command lines `run_colmap` builds equal the
  repository's `convert.py`'s, with `colmap` and `subprocess.run` stubbed
  (neither machine has the binary), and both stop when it is missing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

import convert as root_convert
from gsjax.data import synth as jsynth
from gsjax.utils import llff as jllff
from gsjax.utils import mvs as jmvs
from gsjax_torch import convert as tconvert
from gsjax_torch.data import synth as tsynth
from gsjax_torch.data.synth import write_rendered_colmap
from gsjax_torch.utils import llff as tllff
from gsjax_torch.utils import mvs as tmvs


@pytest.mark.parametrize("n,seed", [(2600, 0), (301, 5)])
def test_blobs_equal_gsjax_bit_for_bit(n, seed):
    assert (tsynth.BLOBS_CENTERS, tsynth.BLOBS_RADII, tsynth.BLOBS_BG_RADIUS) == (
        jsynth.BLOBS_CENTERS, jsynth.BLOBS_RADII, jsynth.BLOBS_BG_RADIUS)
    got, want = tsynth.blobs_gaussians(n, seed), jsynth.blobs_gaussians(n, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsynth.blobs_surface_samples(n, seed),
                                  jsynth.blobs_surface_samples(n, seed))
    np.testing.assert_array_equal(tsynth.blobs_surface_distance(got[0]),
                                  jsynth.blobs_surface_distance(want[0]))


def test_mvs_round_trips_against_gsjax(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"depths": rng.uniform(-1, 400, (7, 5)).astype(np.float32),
              "costs": rng.normal(0, 2, (7, 5)).astype(np.float32),
              "normals": rng.normal(0, 1, (7, 5, 4)).astype(np.float32)}
    arrays["depths"][0, 0] = np.nan
    arrays["costs"][1, 1] = np.inf
    for writer, reader, d in ((tmvs, jmvs, "t"), (jmvs, tmvs, "j")):
        os.makedirs(tmp_path / d)
        for name, a in arrays.items():
            writer.write_dmb(str(tmp_path / d / f"{name}.dmb"), a)
        np.testing.assert_array_equal(reader.read_dmb(str(tmp_path / d / "normals.dmb")),
                                      arrays["normals"])
    for d in ("t", "j"):
        for a, b in zip(tmvs.read_propagated_depth(str(tmp_path / d)),
                        jmvs.read_propagated_depth(str(tmp_path / d))):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tmvs.read_normal_dmb(str(tmp_path / d / "depths.dmb")),
                                      jmvs.read_normal_dmb(str(tmp_path / d / "depths.dmb")))
    pair = str(tmp_path / "pair.txt")
    with open(pair, "w") as f:
        f.write("3\n0\n2 1 10 2 5\n1\n3 8 0 9 7 16 3\n2\n5 17 4 3 1 1 2 5 1 6 1\n")
    assert tmvs.load_pairs_relation(pair) == jmvs.load_pairs_relation(pair)
    with open(tmp_path / "bad.dmb", "wb") as f:
        np.array([2, 1, 1, 1], "<i4").tofile(f)
    for mod in (tmvs, jmvs):
        with pytest.raises(ValueError, match="unsupported"):
            mod.read_dmb(str(tmp_path / "bad.dmb"))


def test_llff_equals_gsjax(tmp_path):
    for d in ("t", "j"):
        write_rendered_colmap(str(tmp_path / d), n_images=5, width=48, height=32,
                              n_gauss=60, device="cpu")
    got = tllff.load_colmap_data(str(tmp_path / "t"))
    want = jllff.load_colmap_data(str(tmp_path / "j"))
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1][:2], want[1][:2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[1][2] == want[1][2]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(tllff.save_poses(str(tmp_path / "t"), *got),
                                  jllff.save_poses(str(tmp_path / "j"), *want))
    for d in ("t", "j"):
        os.remove(tmp_path / d / "poses_bounds.npy")
    assert tllff.gen_poses(str(tmp_path / "t"), factors=[2])
    assert jllff.gen_poses(str(tmp_path / "j"), factors=[2])
    assert (tmp_path / "t" / "poses_bounds.npy").read_bytes() == \
        (tmp_path / "j" / "poses_bounds.npy").read_bytes()
    names = sorted(os.listdir(tmp_path / "t" / "images_2"))
    assert names == sorted(os.listdir(tmp_path / "j" / "images_2")) and len(names) == 5
    for n in names:
        assert (tmp_path / "t" / "images_2" / n).read_bytes() == \
            (tmp_path / "j" / "images_2" / n).read_bytes()


def _record_colmap(monkeypatch):
    """Stub `colmap` on PATH and `subprocess.run`; returns the list the
    command lines are recorded into."""
    calls = []
    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/" + name)
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(cmd) or
                        subprocess.CompletedProcess(cmd, 0, "", ""))
    return calls


@pytest.mark.parametrize("match,model,gpu", [("exhaustive", "PINHOLE", False),
                                             ("sequential", "SIMPLE_PINHOLE", True)])
def test_convert_command_lines_equal_root(tmp_path, monkeypatch, match, model, gpu):
    calls = _record_colmap(monkeypatch)
    root_convert.run_colmap(str(tmp_path), match, model, gpu)
    want = list(calls)
    calls.clear()
    tconvert.run_colmap(str(tmp_path), match, model, gpu)
    got = list(calls)
    assert got == want and len(got) == 3
    assert [c[1] for c in got] == ["feature_extractor", f"{match}_matcher", "mapper"]
    assert os.path.isdir(tmp_path / "sparse")


def test_convert_stops_without_colmap(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for mod in (root_convert, tconvert):
        with pytest.raises(SystemExit, match="colmap"):
            mod.run_colmap(str(tmp_path))


def test_llff_gen_poses_runs_the_ports_colmap(tmp_path, monkeypatch):
    """Without a sparse model `gen_poses` calls `gsjax_torch.convert`'s
    `run_colmap`, whose stubbed COLMAP writes nothing: it then fails reading
    the model it expected."""
    calls = _record_colmap(monkeypatch)
    os.makedirs(tmp_path / "images")
    with pytest.raises(FileNotFoundError):
        tllff.gen_poses(str(tmp_path))
    assert [c[1] for c in calls] == ["feature_extractor", "exhaustive_matcher", "mapper"]
