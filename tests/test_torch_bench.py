"""The port's benchmark entries (`bench_torch.py`, `bench_reg_torch.py`,
`bench_scaling_torch.py` over `gsjax_torch/bench*.py`) against gsjax's
`bench.py`, `bench_reg.py` and `bench_scaling.py`.

- The draws: `bench_inputs`, `bench_reg_inputs` and `scaling_inputs` equal
  gsjax's seeded draws bit for bit. Those live inside gsjax's `main`s, so the
  test restates them with their lines cited; gsjax's `init_from_pcd` runs
  between bench_reg's draws, as there, and the port's model from them equals
  gsjax's.
- The loss: at 96x64 / 300 gaussians the port's bench loss and its five
  gradients (`bench.loss_and_grads`, the twins on the CPU) equal gsjax's
  `render` + `losses` under bench.py's own RasterConfig (its XLA path on the
  CPU; one run: it compiles ~15 s and runs 7.5 s). Tolerances: the render
  and the loss at tests/test_torch_render.py's colour bound (3e-5), the
  gradients within 1e-5 of each one's largest entry, the bound
  tests/test_torch_train_step.py holds the moments to. The loss's median
  term (1e-6 of the mean depth) moves each gradient by less than that.
- The entries as a user runs them, tiny, as subprocesses started together:
  with GSJAX_PLATFORM=cpu (scaling: GSJAX_SCALING_PLATFORM=cpu,
  GSJAX_SCALING_DEVICES=2, modes train and views) at 96x64 / 300 and one
  timed iteration, each ends in gsjax's JSON line (its metric name, its
  keys, a positive value), scaling's efficiency null with rows for 1 and 2
  ranks. At this size bench_reg's model (scale 0.01, opacity 0.1) has no
  median depth anywhere, so its multi-view terms read 0 and `mv_queries` 0,
  as gsjax's own run of bench_reg.py prints; the multi-view parity is
  tests/test_torch_train_step.py's and tests/test_torch_multiview.py's.
- Without a card and without the `cpu` request (this machine), each entry
  prints the error form of its line (value 0.0) and exits non-zero; so does
  bench's watchdog when it fires.
- The untimed steps of bench_reg follow gsjax's capacity rule, and the
  scaling entry's rank counts its device rule.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.model import gaussians as jgm
from gsjax.ops.knn import mean_knn_dist2 as jknn
from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster import render as jrender
from gsjax.ops.raster.camera import Camera as JCamera
from gsjax.train import losses as jlosses
from gsjax.train.loop import mv_shrink_target as j_shrink
from gsjax.train.loop import next_pow2 as j_pow2
from gsjax_torch import bench, bench_reg, bench_scaling
from gsjax_torch.model import gaussians as tgm
from gsjax_torch.ops.knn import mean_knn_dist2 as tknn
from gsjax_torch.ops.raster import Camera as TCamera
from gsjax_torch.utils import benchsync

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H, N = 96, 64, 300
torch.set_num_threads(1)


def test_bench_inputs_are_bench_py_draws():
    got = bench.bench_inputs(W, H, N)
    # bench.py:59-66, then :73 (the camera and config between draw nothing)
    rng = np.random.default_rng(0)
    means = rng.normal(0, 1.2, (N, 3)).astype(np.float32)
    means[:, 2] += 5.0
    scales = np.exp(rng.normal(-3.3, 0.3, (N, 3))).astype(np.float32)
    quats = rng.normal(0, 1, (N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = (1 / (1 + np.exp(-rng.normal(0.0, 1.0, (N, 1))))).astype(np.float32)
    shs = rng.normal(0, 0.3, (N, 16, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    for g, w in zip(got, (means, scales, quats, opac, shs, gt), strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_bench_reg_inputs_and_model_are_bench_reg_py_draws():
    points, colors, gt, gray, poses = bench_reg.bench_reg_inputs(W, H, N)
    # bench_reg.py:57-65, then :96-97 after the init
    rng = np.random.default_rng(0)
    w_points = rng.normal(0, 1.2, (N, 3)).astype(np.float32)
    w_points[:, 2] += 5.0
    w_colors = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    knn = np.full((N,), 1e-4, np.float32)
    jp, _ = jgm.init_from_pcd(w_points, w_colors, N, sh_degree=3, sg_degree=0, knn_dist2=knn)
    w_gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    w_gray = rng.uniform(0, 1, (H, W)).astype(np.float32)
    for g, w in ((points, w_points), (colors, w_colors), (gt, w_gt), (gray, w_gray)):
        np.testing.assert_array_equal(g, w)
    # :67-76, the view and its neighbour
    th = 0.05
    r2 = np.eye(3, dtype=np.float32)
    r2[0, 0] = r2[2, 2] = np.cos(th)
    r2[0, 2] = np.sin(th)
    r2[2, 0] = -np.sin(th)
    np.testing.assert_array_equal(poses[0][0], np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(poses[0][1], np.zeros(3, np.float32))
    np.testing.assert_array_equal(poses[1][0], r2)
    np.testing.assert_array_equal(poses[1][1], np.asarray([0.15, 0.0, 0.0], np.float32))
    # the model the port's entry starts from is gsjax's
    tp, _, _, _ = bench_reg.reg_workload(W, H, N, "cpu")
    for k in tgm.PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(tp, k).detach().numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)


def test_scaling_inputs_are_bench_scaling_py_draws():
    means, colors, gt = bench_scaling.scaling_inputs(W, H, N)
    # bench_scaling.py:44-53 (the camera between draws nothing)
    rng = np.random.default_rng(0)
    w_means = rng.normal(0, 1.2, (N, 3)).astype(np.float32)
    w_means[:, 2] += 5.0
    w_colors = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    w_gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    for g, w in ((means, w_means), (colors, w_colors), (gt, w_gt)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(tknn(means), jknn(w_means), rtol=1e-6)


def test_bench_loss_and_grads_match_gsjax():
    *gauss, gt = bench.bench_inputs(W, H, N)
    cam_args = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0, 0.66, W, H)
    # gsjax: bench.py:67-87 on its own config, XLA on the CPU
    jcfg = JConfig(pair_capacity=1 << 21, live_capacity=1 << 20, max_per_tile=1 << 11,
                   sh_degree=3, require_depth=True)
    jcam = JCamera.create(*cam_args)

    def jloss(m, s, q, o, c):
        out = jrender(m, s, q, o, c, jcam, jcfg, jnp.zeros(3))
        val = (0.8 * jlosses.l1_loss(out["render"], gt)
               + 0.2 * (1 - jlosses.ssim(out["render"], gt))
               + jnp.mean(out["median_depth"]) * 1e-6)
        return val, out["render"]

    (want, j_img), j_grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*map(jnp.asarray, gauss))

    leaves = [torch.as_tensor(a).requires_grad_(True) for a in gauss]
    loss, grads, out = bench.loss_and_grads(leaves, torch.as_tensor(gt),
                                            TCamera.create(*cam_args, device="cpu"),
                                            bench.bench_config(), torch.zeros(3))
    assert out["max_tile_count"] <= (1 << 11)
    np.testing.assert_allclose(out["render"].detach().numpy(), np.asarray(j_img), atol=3e-5)
    np.testing.assert_allclose(loss.item(), float(want), rtol=3e-5)
    names = ("means", "scales", "quats", "opacity", "shs")
    for name, g, w in zip(names, grads, j_grads, strict=True):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-5, err_msg=name)


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GSJAX_") and k != "CUDA_VISIBLE_DEVICES"}
    env.update(GSJAX_BENCH_WIDTH=str(W), GSJAX_BENCH_HEIGHT=str(H), GSJAX_BENCH_N=str(N),
               GSJAX_BENCH_ITERS="1", OMP_NUM_THREADS="1", **kw)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every entry run, all started together: {case: (rc, stdout, stderr)}."""
    out = tmp_path_factory.mktemp("scaling")
    cases = {
        "bench": ("bench_torch.py", _env(GSJAX_PLATFORM="cpu")),
        "reg": ("bench_reg_torch.py", _env(GSJAX_PLATFORM="cpu")),
        "reg_compact": ("bench_reg_torch.py",
                        _env(GSJAX_PLATFORM="cpu", GSJAX_NCC_COMPACT="1")),
        **{f"scaling_{m}": ("bench_scaling_torch.py",
                            _env(GSJAX_SCALING_PLATFORM="cpu", GSJAX_SCALING_DEVICES="2",
                                 GSJAX_SCALING_MODE=m, GSJAX_SCALING_DIR=str(out / m)))
           for m in ("train", "views")},
        "no_card_bench": ("bench_torch.py", _env()),
        "no_card_reg": ("bench_reg_torch.py", _env()),
        "no_card_scaling": ("bench_scaling_torch.py", _env()),
        "watchdog": ("bench_torch.py", _env(GSJAX_PLATFORM="cpu", GSJAX_BENCH_TIMEOUT="0.05")),
    }
    for m in ("train", "views"):
        (out / m).mkdir()
    procs = {k: subprocess.Popen([sys.executable, script], cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, (script, env) in cases.items()}
    res = {}
    try:
        for k, p in procs.items():
            so, se = p.communicate(timeout=240)
            res[k] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            p.kill()
    res["tables"] = {m: json.loads((out / m / name).read_text())
                     for m, name in (("train", "SCALING_torch.json"),
                                     ("views", "SCALING_torch_views.json"))}
    return res


def _last(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


GSJAX_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.mark.parametrize("case,metric,unit", [
    ("bench", "raster_fwd_bwd_rays_per_s_1080p", "rays/s/chip"),
    ("reg", "reg_train_step_ms_1080p", "ms/iter"),
    ("reg_compact", "reg_train_step_ms_1080p", "ms/iter"),
])
def test_entry_prints_gsjax_line_on_cpu(runs, case, metric, unit):
    rc, so, se = runs[case]
    assert rc == 0, se[-3000:]
    line = _last(so)
    assert set(line) == GSJAX_KEYS, line
    assert line["metric"] == metric and line["unit"] == unit
    assert line["value"] > 0 and line["vs_baseline"] >= 0   # rounded to 4 places, as gsjax
    diag = benchsync.read_diagnostics(se)
    assert diag["device"] == "cpu" and diag["nvidia_smi"] is None
    assert set(diag["launches"]) == {"blend_fwd", "blend_bwd", "sample_fwd", "integrate_fwd",
                                     "sample_bwd", "warp_sample", "warp_sample_blocks",
                                     "preprocess_fwd", "preprocess_bwd"}
    assert not any(diag["launches"].values()), "no kernel launches on the CPU"
    warm = [ln for ln in se.splitlines() if ln.startswith("warmup ")]
    assert len(warm) == 1
    if case == "bench":
        assert f"loss={diag['loss']:.4f}" in warm[0]
        assert diag["max_tile_count"] <= diag["max_per_tile"] == 1 << 11
    else:
        first = diag["first_step"]
        assert first["mv_queries"] == 0 and first["ncc_loss"] == first["geo_loss"] == 0.0
        assert f"mv_queries={first['mv_queries']}" in warm[0]
        assert diag["untimed_steps"] == 2     # no bucket moves at this size
        assert diag["ncc_compact"] == (case == "reg_compact")
        assert ("mv_blocks=0" in se.splitlines()) == (case == "reg_compact")


@pytest.mark.parametrize("mode", ["train", "views"])
def test_scaling_entry_on_cpu(runs, mode):
    rc, so, se = runs[f"scaling_{mode}"]
    assert rc == 0, se[-3000:]
    line = _last(so)
    assert set(line) == GSJAX_KEYS, line
    assert line["metric"] == f"{mode}_scaling_correctness_2dev"
    assert line["value"] == line["vs_baseline"] == 1.0
    table = runs["tables"][mode]
    assert table["virtual_devices"] and table["mode"] == mode
    assert [r["devices"] for r in table["rows"]] == [1, 2]
    frames = [1, 2] if mode == "views" else [1, 1]
    assert [r["frames_per_round"] for r in table["rows"]] == frames
    for r in table["rows"]:
        assert r["efficiency"] is None and r["iter_s"] > 0 and r["rays_per_s"] > 0
        assert r["backend"] == "gloo" and len(r["rank_iter_s"]) == r["devices"]
    assert benchsync.read_diagnostics(se)["rows"] == table["rows"]


@pytest.mark.parametrize("case,metric", [
    ("no_card_bench", "raster_fwd_bwd_rays_per_s_1080p"),
    ("no_card_reg", "reg_train_step_ms_1080p"),
    ("no_card_scaling", "train_scaling_efficiency_1dev"),
    ("watchdog", "raster_fwd_bwd_rays_per_s_1080p"),
])
def test_entry_error_line(runs, case, metric):
    rc, so, se = runs[case]
    assert rc == 3, (rc, se[-3000:])
    line = _last(so)
    assert line["metric"] == metric and line["value"] == line["vs_baseline"] == 0.0
    assert line["error"]
    assert ("exceeded" in line["error"]) == (case == "watchdog")


@pytest.mark.parametrize("queries,blocks,compact,blk", [
    (0, 0, True, False), (48_000, 0, True, False), (400_000, 0, True, False),
    (1_000_000, 0, True, False), (48_000, 0, False, False), (48_000, 1843, True, True),
    (1_000_000, 2500, True, True), (1_000_000, 4000, True, True),
])
def test_untimed_steps_follow_gsjax_rule(queries, blocks, compact, blk):
    """bench_reg.py:107-151 at 1080p, on gsjax's own loop helpers."""
    w, h = 1920, 1080
    mv_cap = j_pow2((w * h) // 2) if compact else None
    nb_total = (-(-h // 16)) * (-(-w // 16))
    blk_cap = j_pow2(nb_total // 2) if blk else None
    new_cap = new_blk = None
    if compact and queries > 0.9 * mv_cap:
        new_cap = min(j_pow2(int(queries * 1.3)), j_pow2(w * h))
    elif compact:
        new_cap = j_shrink(queries, mv_cap)
    if blk:
        new_blk = (min(j_pow2(int(blocks * 1.3)), j_pow2(nb_total))
                   if blocks > 0.9 * blk_cap else j_shrink(blocks, blk_cap, floor=256))
    want = 3 if (new_cap is not None or new_blk is not None) else 2
    assert bench_reg.gsjax_untimed_steps(w, h, queries, blocks, compact, blk) == want


@pytest.mark.parametrize("env,cards,want", [
    ({}, 0, [1]), ({}, 4, [1, 2, 4]), ({"GSJAX_SCALING_DEVICES": "2"}, 1, [1, 2]),
    ({"GSJAX_SCALING_DEVICES": "4"}, 1, [1, 2, 4]),
    ({"GSJAX_SCALING_DEVICES": "4", "GSJAX_SCALING_MESHES": "1,3,8"}, 1, [1, 3]),
])
def test_scaling_rank_counts(monkeypatch, env, cards, want):
    for k in ("GSJAX_SCALING_DEVICES", "GSJAX_SCALING_MESHES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert bench_scaling.rank_counts(cards) == want
