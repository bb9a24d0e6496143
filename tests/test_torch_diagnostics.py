"""The training loop's diagnostics in gsjax_torch, against gsjax's.

The scene is 64x32, six views, 250 gaussians; the poisoned states start
from a checkpoint of its gaussians.

- The NaN probe and `nan_stats`: the port's CLI with GSJAX_NAN_PROBE=1, and
  gsjax's `Trainer.step` with its probe on, from one state whose gaussian
  nearest the scene centre has an infinite log-scale (its position, scale,
  rotation and opacity gradients and updates go non-finite, and the render
  culls it, so the loss stays finite); one regularised step without a
  neighbour view (the step gsjax's replay runs). Both draw the same view; their
  metrics["nonfinite"] are equal field for field (exact counts), and each
  writes `nan_probe_it1.npz`: the two files hold the same keys, shapes and
  dtypes, and the CLI prints gsjax's `NAN_PROBE:` line. gsjax's dump is
  replayed by `python -m gsjax_torch.nan_hunt --no_debug_nans`, the port's
  by gsjax's `scripts/nan_hunt.py` logic (its `np.load` of the keys and its
  `train_step` call, without its CLI): the counts are equal (exact).
  Without `--no_debug_nans` the port's replay runs under
  `torch.autograd.detect_anomaly()`, which raises naming the backward op.
- The blow-up snapshot: a NaN DC colour on a visible gaussian makes the loss
  non-finite; the CLI writes `snapshot_it1.npz` with gsjax's keys and
  raises FloatingPointError naming it.
- `--profile_iter`, `--debug`, TensorBoard and `--ip` in one CLI run of five
  steps (195 -> 200, regularisation on at 200, `--eval`): the trace holds
  five step spans; the mosaic JPEG is 2W x 2H, and `Trainer.debug_mosaic`
  equals the mosaic built from the same render outputs with gsjax's
  `apply_depth_colormap` within 1/255; the event file holds gsjax's scalar
  tags (read back with tensorboard's EventAccumulator).
"""

import contextlib
import dataclasses
import io
import json
import os
import random
import socket
from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax_torch.train as ttrain
from gsjax.config import OptimizationParams as JOpt
from gsjax.data.readers import build_nearest_view_graph as jgraph
from gsjax.data.readers import load_scene as jload_scene
from gsjax.model import appearance as japp
from gsjax.model import gaussians as jgm
from gsjax.train import loop as jloop
from gsjax.train.step import LossConfig as JLoss
from gsjax.train.step import train_step as jstep
from gsjax.utils.trajectories import apply_depth_colormap as japply_depth_colormap
from gsjax_torch import nan_hunt
from gsjax_torch.model import gaussians as tgm
from gsjax_torch.model.io import load_checkpoint, save_checkpoint
from tests.test_torch_train import _start

torch.set_num_threads(1)
CAP_KW = dict(pair_capacity=1 << 12, live_capacity=1 << 12, max_per_tile=256)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _poisoned(ckpt, out, field, value):
    """A copy of checkpoint `ckpt` at `out` whose gaussian nearest the scene
    centre (seen by every view) has `field` set to `value`; returns its
    index."""
    p, a, ad, it, _ = load_checkpoint(ckpt, device="cpu")
    idx = int(torch.where(a.alive, p.xyz.detach().norm(dim=1), np.inf).argmin())
    with torch.no_grad():
        getattr(p, field)[idx] = value
    save_checkpoint(out, p, a, ad, it)
    return idx


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("diag")
    scene_dir, ckpt = _start(root, width=64, height=32)
    inf_ckpt = str(root / "inf_scale.npz")
    _poisoned(ckpt, inf_ckpt, "scaling", float("inf"))
    return root, scene_dir, ckpt, inf_ckpt


def _jtrees(z, prefix_p, prefix_a):
    """gsjax's trees from a dump, as scripts/nan_hunt.py builds them."""
    tree_of = lambda cls, prefix: cls(**{f.name: jnp.asarray(z[f"{prefix}.{f.name}"])
                                         for f in dataclasses.fields(cls)})
    return tree_of(jgm.GaussianParams, prefix_p), tree_of(jgm.GaussianAux, prefix_a), tree_of


def _jopt():
    return Namespace(**{**JOpt._defaults(), "regularization_from_iter": 1})


def _gsjax_replay(dump, scene_dir):
    """scripts/nan_hunt.py's replay of `dump` (its key reads, Trainer, cfg
    and train_step call), without its CLI and jax_debug_nans."""
    z = np.load(dump)
    params, aux, tree_of = _jtrees(z, "params", "aux")
    adam = jgm.AdamState(mu=tree_of(jgm.GaussianParams, "adam_mu"),
                         nu=tree_of(jgm.GaussianParams, "adam_nu"),
                         count=jnp.asarray(z["adam.count"]))
    sc = jload_scene(scene_dir, "images", None, eval_split=True)
    jgraph(sc.train_views, 30, 0.01, 1.5, 8)
    view = sc.train_views[int(z["view_uid"])]
    assert int(z["near_uid"]) == -1
    tr = jloop.Trainer(scene=sc, params=params, aux=aux, adam=adam, app=None,
                       opt=Namespace(**JOpt._defaults()), model_path="", **CAP_KW)
    tr.iteration = int(z["iteration"])
    tr.active_sh, tr.active_sg = int(z["active_sh"]), int(z["active_sg"])
    # the None keywords the loop passes, so both share one compiled program
    *_, m = jstep(params, aux, adam, view.camera, jnp.asarray(view.image), jnp.zeros(3),
                  tr.lrs(), tr.raster_cfg(require_depth=True),
                  JLoss(reg_on=True, mv_on=False, nan_stats=True), app_embedding=None,
                  app_net=None, near_cam=None, gray_r=None, gray_n=None)
    return {f"{k}.{f}": int(v) for k, d in m["nonfinite"].items() for f, v in d.items()}


@pytest.fixture(scope="module")
def dumps(scene):
    """The NaN probe of both packages from the infinite-scale checkpoint."""
    root, scene_dir, _, inf_ckpt = scene
    out = str(root / "port_probe")
    mp = pytest.MonkeyPatch()
    mp.setenv("GSJAX_NAN_PROBE", "1")
    printed = io.StringIO()
    steps = []
    try:
        with contextlib.redirect_stdout(printed):
            ttrain.main(["-s", scene_dir, "-m", out, "--iterations", "1", "--eval",
                         "--start_checkpoint", inf_ckpt, "--device", "cpu", "--ip", "",
                         "--regularization_from_iter", "1", "--lambda_multi_view_ncc", "0",
                         "--lambda_multi_view_geo", "0"],
                        on_step=lambda t, m: steps.append(m))
    finally:
        mp.undo()

    # gsjax's Trainer.step with its probe on, from the same state
    jdir = str(root / "gsjax_probe")
    os.makedirs(jdir)
    p, a, _, it, _ = load_checkpoint(inf_ckpt, device="cpu")
    pn, an = tgm.params_to_numpy(p, a)
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in pn.items()})
    ja = jgm.GaussianAux(**{k: jnp.asarray(v) for k, v in an.items()})
    # regularised (median depth, depth-normal loss) with no neighbour, as the
    # port's run with zero multi-view lambdas: the program the replay runs
    sc = jload_scene(scene_dir, "images", None, eval_split=True)
    tr = jloop.Trainer(scene=sc, params=jp, aux=ja, adam=jgm.adam_init(jp),
                       app=japp.init_appearance("no", len(sc.train_views)), opt=_jopt(),
                       model_path=jdir, **CAP_KW)
    tr.nan_probe = True
    random.seed(0)
    jm = tr.step()
    return dict(port=os.path.join(out, "nan_probe_it1.npz"),
                gsjax=os.path.join(jdir, "nan_probe_it1.npz"), printed=printed.getvalue(),
                port_metrics=steps[0], gsjax_metrics=jm)


def test_nan_stats_match_gsjax(dumps):
    """metrics["nonfinite"] of the poisoned step, port against gsjax."""
    tm, jm = dumps["port_metrics"], dumps["gsjax_metrics"]
    assert tm["view"] == int(np.load(dumps["gsjax"])["view_uid"]), "the same view"
    want = {k: {f: int(v) for f, v in d.items()} for k, d in jm["nonfinite"].items()}
    assert tm["nonfinite"] == want
    for kind in ("grad", "param"):
        assert {f for f, v in want[kind].items() if v} == {"xyz", "scaling", "rotation",
                                                            "opacity"}
    assert np.isfinite(tm["loss"]) and np.isfinite(float(jm["loss"]))


def test_probe_dump_has_gsjax_keys(dumps):
    port, gsj, printed = dumps["port"], dumps["gsjax"], dumps["printed"]
    zp, zg = np.load(port), np.load(gsj)
    assert sorted(zp.files) == sorted(zg.files)
    for k in zg.files:
        assert zp[k].shape == zg[k].shape and zp[k].dtype == zg[k].dtype, k
    assert "NAN_PROBE: iteration 1 produced non-finite values" in printed
    assert f"pre-step state dumped to {port}" in printed
    # the pre-step state: the poisoned scale, finite moments
    assert np.isinf(zp["params.scaling"]).any() and int(zp["adam.count"]) == 0
    assert np.isfinite(zp["adam_mu.xyz"]).all()


@pytest.fixture(scope="module")
def replays(dumps, scene):
    """gsjax's dump replayed by the port's nan_hunt, the port's by gsjax's
    script logic."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port = nan_hunt.main([dumps["gsjax"], "--scene_dir", scene[1], "--no_debug_nans",
                              "--device", "cpu"])
    return dict(port_reads_gsjax=port, gsjax_reads_port=_gsjax_replay(dumps["port"], scene[1]),
                printed=out.getvalue())


@pytest.mark.parametrize("which", ["port_reads_gsjax", "gsjax_reads_port"])
def test_nan_hunt_replays_match(replays, which):
    """Each package's replay of the other's dump: the same non-finite counts."""
    assert "replay non-finite counts:" in replays["printed"]
    got = replays[which]
    assert got == replays["gsjax_reads_port" if which == "port_reads_gsjax"
                          else "port_reads_gsjax"]
    assert {k for k, v in got.items() if v} == {
        f"{kind}.{f}" for kind in ("grad", "param")
        for f in ("xyz", "scaling", "rotation", "opacity")}


def test_snapshot_on_nonfinite_loss_and_anomaly_replay(scene, capsys):
    """A NaN colour poisons the loss: probe dump, snapshot, raise; the
    anomaly-mode replay of the probe's dump names the backward op."""
    root, scene_dir, ckpt, _ = scene
    nan_ckpt = str(root / "nan_dc.npz")
    _poisoned(ckpt, nan_ckpt, "features_dc", float("nan"))
    out = str(root / "blowup")
    mp = pytest.MonkeyPatch()
    mp.setenv("GSJAX_NAN_PROBE", "1")
    try:
        with pytest.raises(FloatingPointError) as err:
            ttrain.main(["-s", scene_dir, "-m", out, "--iterations", "3", "--eval",
                         "--start_checkpoint", nan_ckpt, "--device", "cpu", "--ip", ""])
    finally:
        mp.undo()
    snap = os.path.join(out, "snapshot_it1.npz")
    assert snap in str(err.value) and os.path.exists(snap)
    z = np.load(snap)
    assert sorted(z.files) == sorted([f"params_{i}" for i in range(9)]
                                     + [f"aux_{i}" for i in range(6)]
                                     + ["view_uid", "near_uid", "iteration"])
    assert np.isnan(z["params_1"]).any() and z["aux_0"].dtype == bool
    assert "NAN_PROBE: iteration 1" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="returned nan values"):
        nan_hunt.main([os.path.join(out, "nan_probe_it1.npz"), "--scene_dir", scene_dir,
                       "--device", "cpu"])


@pytest.fixture(scope="module")
def diag_run(scene):
    """Five steps (195 -> 200) with --profile_iter 196, --debug (reg on at
    200), TensorBoard and the viewer server, on the eval split."""
    root, scene_dir, ckpt, _ = scene
    c195 = str(root / "c195.npz")
    save_checkpoint(c195, *load_checkpoint(ckpt, device="cpu")[:3], 195)
    out = str(root / "diag_out")
    trainer = ttrain.main(["-s", scene_dir, "-m", out, "--iterations", "200", "--eval",
                           "--start_checkpoint", c195, "--device", "cpu",
                           "--profile_iter", "196", "--debug",
                           "--regularization_from_iter", "200", "--test_iterations", "200",
                           "--ip", "127.0.0.1", "--port", str(_free_port())])
    return out, trainer


def test_viewer_profile_debug_flags_accepted(diag_run):
    """--ip, --profile_iter and --debug no longer raise: the run trains."""
    out, trainer = diag_run
    assert trainer.iteration == 200 and trainer.debug
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_200", "point_cloud.ply"))


def test_profile_trace_has_five_steps(diag_run):
    out, _ = diag_run
    with open(os.path.join(out, "profile", "trace_it196.json")) as f:
        events = json.load(f)["traceEvents"]
    # the step's own span: an op-scope profiler range (utils/spans.py)
    spans = sorted(e["name"] for e in events if e.get("cat") == "cpu_op"
                   and e["name"].startswith("train_step"))
    assert spans == [f"train_step {i}" for i in range(196, 201)]


def test_debug_mosaic(diag_run):
    from PIL import Image

    out, trainer = diag_run
    files = os.listdir(os.path.join(out, "debug"))
    assert len(files) == 1 and files[0].startswith("00200_")
    view = next(v for v in trainer.scene.train_views if files[0] == f"00200_{v.image_name}.jpg")
    with Image.open(os.path.join(out, "debug", files[0])) as im:
        assert im.size == (2 * view.width, 2 * view.height)
    got = trainer.debug_mosaic(view)
    o = {k: v.numpy() for k, v in trainer.render_view(view).items() if torch.is_tensor(v)}
    gt = np.clip(trainer.gt_for(view).numpy(), 0, 1)
    dep = japply_depth_colormap(o["median_depth"]).astype(np.float32) / 255.0
    want = np.concatenate([np.concatenate([gt, np.clip(o["render"], 0, 1)], axis=1),
                           np.concatenate([np.clip((o["normal"] + 1) * 0.5, 0, 1), dep],
                                          axis=1)], axis=0)
    assert got.shape == (2 * view.height, 2 * view.width, 3)
    np.testing.assert_allclose(got, want, atol=1 / 255)
    assert (dep > 0).any(), "the median depth pane is live"


def test_tensorboard_tags(diag_run):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    out, trainer = diag_run
    ev = EventAccumulator(out)
    ev.Reload()
    tags = ev.Tags()
    assert set(tags["scalars"]) == {
        "train_loss_patches/total_loss", "train_loss_patches/l1_loss",
        "train_loss_patches/normal_loss", "train_loss_patches/ncc_loss",
        "train_loss_patches/geo_loss", "total_points", "iter_time", "test/psnr"}
    assert tags["histograms"] == ["scene/opacity_histogram"]
    names = [v.image_name for v in trainer.scene.test_views[:5]]
    assert set(tags["images"]) == {f"{n}/{k}" for n in names
                                   for k in ("render", "depth", "ground_truth")}
    assert ev.Scalars("total_points")[0].value == int(trainer.aux.alive.sum())
    assert ev.Scalars("total_points")[0].step == 200
