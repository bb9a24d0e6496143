"""The port's sharded train step (`parallel.train_step_sharded`) and the
multi-rank CLIs, on the CPU.

- the sharded step on 4 ranks against the port's single `train_step` from
  the same state: reg on (depth-normal) on a 96x64 frame (2 tile rows, so
  two ranks own no row), the multi-view terms, GOF appearance, and a 64x256
  frame (32x256, 8 tile rows) on custom bounds with an empty band, on the mirrored
  dual partition and on a freely paired one. tests/test_sharding.py's
  tolerances: metrics rtol 2e-4 / atol 2e-5, parameters rtol 1e-3 / atol
  2e-5, grad_accum rtol 2e-3 / atol 1e-7, denom and max_radii equal, the
  pair counts equal, `row_pairs` summing to the frame's live pairs, the
  first moments (0.1 g) within 1e-4 of each field's scale; the four ranks'
  states bit-equal;
- one sharded step against gsjax's `train_step_sharded` on `make_mesh(4)`
  with the same custom bounds: metrics within rtol 2e-4, `row_pairs` and
  the pair counts equal (the weights carried across as numpy arrays);
- the training CLI's `main` on 2 ranks (`parallel.launch`) through a
  densification: the ranks' states bit-equal after the run and only rank
  0's model directory written;
- the training CLI with `--n_devices 2 --device cpu` (its launcher) and with
  `--dist_*` (two processes joining one group), and the render CLI with
  `--n_devices 2 --device cpu` against its single-process PNGs.

Every multi-rank run has a launcher (or subprocess) timeout of at most 120 s.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax_torch.parallel import launch
from tests import torch_ranks as tr

torch.set_num_threads(1)
TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "reg_on": dict(reg_on=True),
    "multiview": dict(width=64, height=64, reg_on=True, mv_on=True),
    "gof": dict(width=64, height=64, require_depth=False, appearance="gof"),
    "custom": dict(width=32, height=256, reg_on=True, bounds=[0, 3, 3, 5, 8]),
    "dual": dict(width=32, height=256, reg_on=True, bounds=[0, 1, 1, 2, 4, 4, 5, 7, 8]),
    "paired": dict(width=32, height=256, reg_on=True, bounds=[0, 1, 1, 2, 4, 4, 5, 7, 8],
                   pair=[[0, 5], [1, 2], [3, 6], [4, 7]]),
    "gsjax": dict(width=64, height=96, require_depth=False, bounds=[0, 1, 1, 2, 3]),
}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every case's sharded step on one group of 4 ranks."""
    store = tmp_path_factory.mktemp("sharded") / "store"
    return launch.launch(tr.rank_steps, 4, args=(CASES,), init_method=f"file://{store}",
                         timeout=TIMEOUT)


@pytest.mark.parametrize("name", [k for k in CASES if k != "gsjax"])
def test_sharded_step_matches_single(sharded, name):
    case = CASES[name]
    m1, s1, g1 = tr.step_case(case)
    m2, s2, g2 = sharded[0][name]
    assert not m1["overflowed"] and not m2["overflowed"]
    for k in ("loss", "l1", "ssim", "dn_loss", "ncc_loss", "geo_loss"):
        np.testing.assert_allclose(m2[k], m1[k], rtol=2e-4, atol=2e-5, err_msg=k)
    if case.get("reg_on"):
        assert m1["dn_loss"] > 0
    if case.get("mv_on"):
        assert m1["ncc_loss"] > 0 and m1["geo_loss"] > 0
        assert m2["mv_queries"] == m1["mv_queries"]
    for k in ("num_pairs", "num_live_pairs", "max_tile_count"):
        assert m2[k] == m1[k], k
    assert int(m2["row_pairs"].sum()) == m1["num_live_pairs"]
    for f in tr.gm.PARAM_FIELDS:
        g = s1[f"mu.{f}"]
        scale = max(np.abs(g).max(), 1e-20)
        np.testing.assert_allclose(s2[f"mu.{f}"] / scale, g / scale, atol=1e-4, err_msg=f)
        np.testing.assert_allclose(s2[f"params.{f}"], s1[f"params.{f}"],
                                   rtol=1e-3, atol=2e-5, err_msg=f)
    np.testing.assert_allclose(s2["aux.grad_accum"], s1["aux.grad_accum"], rtol=2e-3, atol=1e-7)
    np.testing.assert_array_equal(s2["aux.denom"], s1["aux.denom"])
    np.testing.assert_array_equal(s2["aux.max_radii"], s1["aux.max_radii"])
    assert float(s1["aux.grad_accum"].sum()) > 0
    for k in g1:                                          # GOF: embedding and net grads
        np.testing.assert_allclose(g2[k], g1[k], rtol=2e-3, atol=1e-6, err_msg=k)
    assert (case.get("appearance") == "gof") == bool(g1)
    for r in range(1, 4):                                 # every rank holds the same state
        _, sr, _ = sharded[r][name]
        assert all(np.array_equal(sr[k], s2[k]) for k in s2), f"rank {r} differs"


def test_sharded_step_matches_gsjax(sharded):
    """gsjax's `train_step_sharded` on a 4-device mesh with the same bounds,
    from the same state and gt (reg off: gsjax's XLA blend on the CPU)."""
    from gsjax.model import gaussians as jgm
    from gsjax.ops.raster import RasterConfig as JConfig
    from gsjax.ops.raster.camera import Camera as JCamera
    from gsjax.parallel import make_mesh, train_step_sharded
    from gsjax.train.step import LossConfig as JLoss

    case = CASES["gsjax"]
    w, h = case["width"], case["height"]
    _, _, _, _, _, _, gt = tr.setup(w, h, require_depth=False)
    params, aux = tr.model_arrays()
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    ja = jgm.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})
    jcfg = JConfig(tile=32, chunk=128, tile_batch=8, max_per_tile=256, sh_degree=1,
                   require_depth=False, pair_capacity=1 << 12, backend="ref")
    jcam = JCamera.create(*tr.camera_rt(), 0.9, 0.7, w, h)
    _, _, _, jm = train_step_sharded(jp, ja, jgm.adam_init(jp), jcam, jnp.asarray(gt.numpy()),
                                     jnp.zeros(3), tr.LRS, jcfg, JLoss(), make_mesh(4),
                                     dev_pair_capacity=1 << 11,
                                     row_bounds=np.asarray(case["bounds"], np.int32),
                                     rows_per_max=1)
    m2, _, _ = sharded[0]["gsjax"]
    for k in ("loss", "l1", "ssim"):
        np.testing.assert_allclose(m2[k], float(jm[k]), rtol=2e-4, atol=2e-5, err_msg=k)
    np.testing.assert_array_equal(m2["row_pairs"], np.asarray(jm["row_pairs"]))
    assert m2["num_pairs"] == int(jm["num_pairs"])
    assert m2["dev_num_pairs"] == int(jm["dev_num_pairs"])
    assert int(m2["row_pairs"].sum()) > 0


# --- the loop and the CLIs ----------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from gsjax_torch.data.synth import write_rendered_colmap

    root = str(tmp_path_factory.mktemp("scene") / "s")
    write_rendered_colmap(root, n_images=3, width=64, height=48, device="cpu")
    return root


def _train_args(scene, out, iters=5, reg=3):
    return ["-s", scene, "-m", out, "--iterations", str(iters), "--ip", "",
            "--densify_from_iter", "1", "--densification_interval", "2",
            "--densify_until_iter", str(iters), "--regularization_from_iter", str(reg),
            "--save_iterations", str(iters), "--checkpoint_iterations", str(iters),
            "--test_iterations", str(iters), "--device", "cpu"]


def test_run_training_two_ranks(scene, tmp_path):
    """Two ranks through a densification (steps 2 and 4), the regularised
    (median-depth) step from 3: bit-equal states after the run; rank 1 wrote
    nothing."""
    base = str(tmp_path / "out")
    res = launch.launch(tr.rank_train, 2, args=(_train_args(scene, '{out}'), base),
                        init_method=f"file://{tmp_path / 'store'}", timeout=TIMEOUT)
    (s0, it0, n0), (s1, it1, _) = res
    assert it0 == it1 == 5 and n0 == 2
    assert all(np.array_equal(s0[k], s1[k]) for k in s0)
    assert not os.path.exists(os.path.join(base, "1"))
    out = os.path.join(base, "0")
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_5", "point_cloud.ply"))
    assert os.path.exists(os.path.join(out, "chkpnt5.npz"))
    assert os.path.exists(os.path.join(out, "multi_view.json"))


def _run(cmd, timeout=TIMEOUT):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_train_cli_n_devices(scene, tmp_path):
    out = str(tmp_path / "out")
    r = _run([sys.executable, "-m", "gsjax_torch.train", *_train_args(scene, out, 3, 100),
              "--n_devices", "2"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Starting 2 ranks" in r.stdout
    assert r.stdout.count("torch.distributed backend gloo on cpu") == 2
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_3", "point_cloud.ply"))
    assert os.path.exists(os.path.join(out, "cfg_args"))


def test_train_cli_dist_flags(scene, tmp_path):
    """Two processes of the CLI joining one group by `--dist_*`."""
    from gsjax_torch.parallel.launch import free_port

    out = str(tmp_path / "out")
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "gsjax_torch.train",
                               *_train_args(scene, out, 3, 100), "--dist_coordinator", coord,
                               "--dist_num_processes", "2", "--dist_process_id", str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
    assert "Training complete." in outs[0][0] and "Training complete." not in outs[1][0]
    assert os.path.exists(os.path.join(out, "chkpnt3.npz"))


def test_render_cli_n_devices(scene, tmp_path):
    """`render.py --n_devices 2 --device cpu` renders view-parallel: the same
    PNGs as the single-process CLI, written once."""
    from PIL import Image

    from gsjax_torch.config import ModelParams, dump_cfg_args
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.model.io import save_ply

    from argparse import Namespace

    model = str(tmp_path / "model")
    params, aux = gm.params_from_numpy(*tr.model_arrays(n=60, capacity=64, seed=3), "cpu")
    save_ply(os.path.join(model, "point_cloud", "iteration_5", "point_cloud.ply"), params, aux)
    saved = Namespace(**ModelParams._defaults())
    saved.source_path, saved.model_path, saved.sh_degree = scene, model, 1
    dump_cfg_args(model, saved)
    base = os.path.join(model, "train", "ours_5", "renders")
    pngs = {}
    for n in ("1", "2"):
        r = _run([sys.executable, "-m", "gsjax_torch.render", "-m", model, "--n_devices", n,
                  "--device", "cpu", "--skip_test"])
        assert r.returncode == 0, r.stderr[-3000:]
        files = sorted(os.listdir(base))
        assert files == [f"{i:05d}.png" for i in range(3)]
        pngs[n] = [np.asarray(Image.open(os.path.join(base, f))) for f in files]
        if n == "2":
            assert "view-parallel rendering over 2 ranks" in r.stdout
    for a, b in zip(pngs["1"], pngs["2"]):
        np.testing.assert_array_equal(a, b)
