"""The port's training CLI end to end on the CPU, against gsjax's.

`gsjax_torch.train.main` trains 12 steps on a 96x64, 6-view rendered COLMAP
scene: densify at 5 and 10, regularisation (median depth, depth-normal
loss) from 7, multi-view lambdas 0. gsjax's CLI (`train.py`) runs the same
flags and seed for its first 5 steps (the schedule up to the first densify
does not depend on the iteration count; the 5 steps keep its compile time
small). Both draw the same views from the seeded `random` stream, so:

  - per-step losses up to the first densify agree within rtol 1e-5
    (float32 in both packages; read: 3e-7);
  - the first densify's counts (n_alive, n_cloned, n_split, n_pruned) are
    equal. After it the packages draw different position samples, so the
    runs part.

A second port run keeps gsjax's default multi-view lambdas (0.6 / 0.02) and
starts from a checkpoint of the scene's own gaussians, so the median depth
is live from the first step (a model grown from the sparse points has no
pixel with alpha >= 0.55 for hundreds of steps): from step 7 every step
whose view has neighbours adds the PGSR losses, which must be finite and
non-zero, and its (view, neighbour) sequence must be gsjax's draw rule
(gsjax/train/loop.py:388-393) replayed on the seeded `random` stream.

A third run starts from the same checkpoint with GSJAX_NCC_COMPACT=1 and
GOF's appearance model (`--use_decoupled_appearance 2`): every multi-view
step runs the NCC on compacted 16x16 blocks (at most the frame's 24), the
embeddings of the drawn views and the CNN move, and its checkpoint's
`x_app/*` keys load in gsjax's `state_from_arrays` and in the port's.
"""

import json
import os
import random
import sys

import numpy as np
import pytest
import torch

import gsjax_torch.train as ttrain
from gsjax_torch.data.synth import write_rendered_colmap
from gsjax_torch.model import appearance as tapp
from gsjax_torch.model.gaussians import adam_init, params_from_numpy
from gsjax_torch.model.io import load_checkpoint, load_ply, save_checkpoint

torch.set_num_threads(1)
FLAGS = ["--densify_from_iter", "4", "--densification_interval", "5",
         "--densify_until_iter", "11", "--regularization_from_iter", "7",
         "--lambda_multi_view_ncc", "0", "--lambda_multi_view_geo", "0", "--seed", "0"]
COUNTS = ("n_alive", "n_cloned", "n_split", "n_pruned")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    scene = str(root / "scene")
    write_rendered_colmap(scene, n_images=6, width=96, height=64, device="cpu")
    ports = []
    out = str(root / "port")
    trainer = ttrain.main(["-s", scene, "-m", out, "--iterations", "12",
                           "--test_iterations", "12", "--save_iterations", "12",
                           "--checkpoint_iterations", "12", "--device", "cpu", *FLAGS],
                          on_step=lambda t, m: ports.append(m))

    import train as jtrain_cli
    from gsjax.train import loop as jloop

    gsj = []
    step = jloop.Trainer.step

    def recording_step(self):
        m = step(self)
        gsj.append({"loss": float(m["loss"]), "densify": m.get("densify")})
        return m

    mp = pytest.MonkeyPatch()
    mp.setattr(jloop.Trainer, "step", recording_step)
    mp.setattr(sys, "argv", ["train.py", "-s", scene, "-m", str(root / "gsjax"),
                             "--iterations", "5", "--test_iterations", "5",
                             "--save_iterations", "5", "--checkpoint_iterations", "5",
                             "--ip", "", *FLAGS])
    try:
        jtrain_cli.main()
    finally:
        mp.undo()
    return out, trainer, ports, gsj


def test_outputs_written(runs):
    out, trainer, ports, _ = runs
    assert trainer.iteration == 12 and len(ports) == 12
    assert all(np.isfinite(m["loss"]) for m in ports)
    ply = os.path.join(out, "point_cloud", "iteration_12", "point_cloud.ply")
    params, aux = load_ply(ply, device="cpu")
    assert int(aux.alive.sum()) == int(trainer.aux.alive.sum())
    _, aux2, adam, it, _ = load_checkpoint(os.path.join(out, "chkpnt12.npz"), device="cpu")
    assert it == 12 and adam.count == 12
    assert torch.equal(aux2.alive, trainer.aux.alive)
    assert "iterations=12" in open(os.path.join(out, "cfg_args")).read()
    cams = json.load(open(os.path.join(out, "cameras.json")))
    assert [c["img_name"] for c in cams] == [f"img_{i:03d}" for i in range(6)]
    mv = [json.loads(line) for line in open(os.path.join(out, "multi_view.json"))]
    assert len(mv) == 6 and all("nearest_name" in r for r in mv)
    assert os.path.exists(os.path.join(out, "input.ply"))


def test_losses_and_densify_match_gsjax(runs):
    _, _, ports, gsj = runs
    assert len(gsj) == 5
    np.testing.assert_allclose([m["loss"] for m in ports[:5]], [m["loss"] for m in gsj],
                               rtol=1e-5)
    want = gsj[4]["densify"]
    got = ports[4]["densify"]
    assert {k: got[k] for k in COUNTS} == {k: int(want[k]) for k in COUNTS}
    assert ports[9].get("densify") is not None, "the second densify ran"
    assert all(m.get("densify") is None for i, m in enumerate(ports) if i not in (4, 9))


def _start(root, width=96, height=64):
    """A rendered arc scene under `root` and a checkpoint of its gaussians;
    returns (scene dir, checkpoint path)."""
    scene = str(root / "scene")
    means, scales, quats, opac, shs = write_rendered_colmap(
        scene, n_images=6, width=width, height=height, device="cpu")
    n, cap = len(means), 512
    pad = lambda x, fill=0.0: np.concatenate(
        [x, np.full((cap - n,) + x.shape[1:], fill, np.float32)]).astype(np.float32)
    params = dict(xyz=pad(means), features_dc=pad(shs[:, :1]), features_rest=pad(shs[:, 1:]),
                  opacity=pad(np.log(opac / (1 - opac))), scaling=pad(np.log(scales)),
                  rotation=pad(quats), sg_axis=pad(np.zeros((n, 1, 3))),
                  sg_sharpness=pad(np.zeros((n, 1))), sg_color=pad(np.zeros((n, 1, 3))))
    params["rotation"][n:, 0] = 1.0
    aux = dict(alive=np.arange(cap) < n, filter_3d=np.zeros(cap),
               grad_accum=np.zeros(cap), grad_accum_abs=np.zeros(cap),
               denom=np.zeros(cap), max_radii=np.zeros(cap, np.int32))
    p, a = params_from_numpy(params, aux, "cpu")
    ckpt = str(root / "start.npz")
    save_checkpoint(ckpt, p, a, adam_init(p), 0)
    return scene, ckpt


@pytest.fixture(scope="module")
def mv_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_mv")
    scene, ckpt = _start(root)
    steps = []
    trainer = ttrain.main(["-s", scene, "-m", str(root / "port"), "--iterations", "12",
                           "--device", "cpu", "--start_checkpoint", ckpt, *FLAGS[:8],
                           "--seed", "0"],
                          on_step=lambda t, m: steps.append(m))
    return trainer, steps


@pytest.fixture(scope="module")
def app_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_app")
    scene, ckpt = _start(root)
    out = str(root / "port")
    steps, tables = [], []
    mp = pytest.MonkeyPatch()
    mp.setenv("GSJAX_NCC_COMPACT", "1")
    try:
        trainer = ttrain.main(["-s", scene, "-m", out, "--iterations", "12", "--device", "cpu",
                               "--start_checkpoint", ckpt, "--use_decoupled_appearance", "2",
                               "--checkpoint_iterations", "12", *FLAGS[:8], "--seed", "0"],
                              on_step=lambda t, m: (steps.append(m),
                                                    tables.append(t.app.table.clone())))
    finally:
        mp.undo()
    return trainer, steps, tables, os.path.join(out, "chkpnt12.npz")


def test_multiview_steps_train_and_draw_as_gsjax(mv_run):
    trainer, steps = mv_run
    views = trainer.scene.train_views
    assert all(v.nearest_ids for v in views), "every arc view has neighbours"
    random.seed(0)
    for it, m in enumerate(steps, start=1):
        view = random.choice(views)
        near = random.choice(view.nearest_ids) if it >= 7 else None
        assert (m["view"], m["near"]) == (view.uid, near), it
        if near is None:
            assert m["ncc_loss"] == m["geo_loss"] == 0.0
        else:
            assert np.isfinite([m["ncc_loss"], m["geo_loss"]]).all()
            assert m["ncc_loss"] > 0 and m["geo_loss"] > 0, it
            assert m["mv_queries"] > 0 and m["mv_max_tile_count"] > 0
    assert len(steps) == 12 and all(np.isfinite(m["loss"]) for m in steps)


def test_gof_with_compacted_ncc_trains(app_run):
    trainer, steps, tables, _ = app_run
    init = tapp.init_appearance("gof", 6, torch.Generator().manual_seed(0))
    assert trainer.app.kind == "gof" and len(steps) == 12
    mv = [m for m in steps if m["near"] is not None]
    assert len(mv) >= 3
    for m in steps:
        assert np.isfinite(m["loss"]) and m["app_grad"] is not None
        if m["near"] is None:
            assert m["mv_blocks"] == 0 and m["ncc_loss"] == 0.0
        else:
            assert 0 < m["mv_blocks"] <= 24, m["mv_blocks"]
            assert m["ncc_loss"] > 0 and m["geo_loss"] > 0
    # the first drawn view's row moved at the first step
    assert not torch.equal(tables[0][steps[0]["view"]], init.table[steps[0]["view"]])
    assert trainer.app.net_opt.count == trainer.app.opt.count == 12
    assert not torch.equal(trainer.app.net.conv3.weight, init.net.conv3.weight)


def test_gof_checkpoint_loads_in_both_packages(app_run):
    from gsjax.model import appearance as japp
    from tests.test_torch_appearance import _gsjax_template

    trainer, _, _, path = app_run
    *_, it, extra = load_checkpoint(path, device="cpu")
    assert it == 12 and "app/net/conv1/w" in extra and "app/net_opt/count" in extra
    want = tapp.state_to_arrays(trainer.app)
    assert sorted(extra) == sorted(want)
    gs = japp.state_to_arrays(japp.state_from_arrays(_gsjax_template("gof", 6), extra))
    back = tapp.state_to_arrays(tapp.state_from_arrays(
        tapp.init_appearance("gof", 6, torch.Generator().manual_seed(1)), extra))
    for k, v in want.items():
        np.testing.assert_array_equal(gs[k], v, err_msg=k)
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_unported_options_raise(tmp_path):
    """No option of gsjax's train CLI is left unported (its last two, the
    multi-device flags, since gsjax_torch.parallel): on a missing scene
    `--n_devices 2` starts two ranks and ends with a rank's error rather
    than waiting on its peer, and `--dist_num_processes` without a
    coordinator joins no group and fails in this process."""
    argv = ["-s", str(tmp_path / "none"), "-m", str(tmp_path / "out"), "--device", "cpu"]
    with pytest.raises(RuntimeError, match=r"rank \d raised(.|\n)*no COLMAP sparse/"):
        ttrain.main(argv + ["--n_devices", "2"])
    with pytest.raises(ValueError, match="no COLMAP sparse/"):
        ttrain.main(argv + ["--dist_num_processes", "2"])
