"""The port's stage profilers (`gsjax_torch.profile_stages`, `profile_sample`,
`profile_reg`, `trace_reg`, `measure_trepl`) against gsjax's scripts.

- Stats: `profile_stages.stage_stats` on the port's preprocess, binning and
  B1 twin equals gsjax's formulas (scripts/profile_stages.py:191-222,
  restated here: they live inside its `main`) on gsjax's own `preprocess`,
  `bin_gaussians` and `render_ref` at the same draws (96x64, 300
  gaussians): every binning integer exactly, the n_contrib-derived numbers
  within 0.5% relative. gsjax's binning runs at a capacity that fits the
  scene's pairs; `fill` divides by the script's 2^21 on both sides.
- Keys: every JSON key of gsjax's records PROFILE_r04.json, SAMPLE_PROFILE.json
  and REG_PROFILE.json is in the port's output at 64x32 / 150 / one
  iteration, each value finite or null with its reason under `notes`
  (REG_PROFILE's sample_depth key names the query count: 1080p's "2073k"
  reads "2k" here).
- The sort stage's keys are the binning's own: sorted stably they give the
  binning's pair order.
- `measure_trepl.repl` equals gsjax's jitted `repl` (measure_trepl.py:46-55)
  within 1e-6 relative, on the script's inputs and on random ones.
- `trace_reg` prints a non-empty table of CPU ops on the CPU.
- Without a card and without `--device cpu` each new entry exits non-zero
  with its reason.
"""

import dataclasses
import functools
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.model import gaussians as jgm
from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster import render_ref as jref
from gsjax.ops.raster.binning import bin_gaussians as jbin
from gsjax.ops.raster.camera import Camera as JCamera
from gsjax.ops.raster.preprocess import preprocess as jpre
from gsjax_torch import (measure_trepl, multihost_demo, profile_reg, profile_sample,
                         profile_stages, scaling_model, trace_reg)
from gsjax_torch.ops.raster import Camera, render_cuda, render_ref
from gsjax_torch.ops.raster.binning import bin_gaussians
from gsjax_torch.ops.raster.preprocess import preprocess

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H, N = 96, 64, 300
KW, KH, KN = 64, 32, 150       # the key tests' size: a key does not depend on it
CPU = torch.device("cpu")
torch.set_num_threads(1)


@functools.lru_cache(maxsize=1)
def _port_stages():
    gauss, _, _ = profile_stages.stage_inputs(W, H, N)
    cfg = profile_stages.stage_config()
    cam = Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0, 0.66,
                        W, H, device="cpu")
    prep = preprocess(*(torch.as_tensor(a) for a in gauss), None, None, None, cam, cfg)
    binning = bin_gaussians(prep, cfg, W, H)
    planes = render_cuda.blend_fwd(render_ref.prepare_pairs(prep, binning),
                                   binning.tile_start, binning.tile_count, W, H, cam.fx,
                                   cam.fy, torch.zeros(3), profile_stages.stage_config(False))
    return gauss, cfg, prep, binning, planes


def _gsjax_stats(gauss):
    """gsjax's profile_stages.py:191-222 on gsjax's own stages."""
    means, scales, quats, opac, shs = gauss
    cam = JCamera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0, 0.66,
                         W, H)
    # n_contrib does not depend on the median depth, which gsjax's plain
    # blend would compile a bisection for
    cfg = JConfig(pair_capacity=1 << 12, max_per_tile=1 << 11, chunk=128, sh_degree=3,
                  require_depth=False)
    prep = jpre(*map(jnp.asarray, (means, scales, quats, opac, shs)), None, None, None,
                cam, cfg)
    binning = jbin(prep, cfg, W, H)
    out = jref.render_tiles(prep, binning, cam, cfg, jnp.zeros(3))
    tiles_x, tiles_y = cfg.grid(W, H)
    t = cfg.tile
    # [T, P] n_contrib of each tile's pixels (96x64 has no padded pixel)
    nc = np.asarray(out["n_contrib"]).reshape(tiles_y, t, tiles_x, t).transpose(
        0, 2, 1, 3).reshape(tiles_x * tiles_y, t * t)
    stats = {}
    stats["num_pairs"] = int(binning.num_pairs)
    stats["pair_capacity"] = 1 << 21            # the script's capacity
    stats["fill"] = round(float(binning.num_pairs) / (1 << 21), 4)
    tc = np.asarray(binning.tile_count)
    stats["tiles"] = int(tiles_x * tiles_y)
    stats["tile_count_mean"] = round(float(tc.mean()), 1)
    stats["tile_count_p50"] = int(np.percentile(tc, 50))
    stats["tile_count_p90"] = int(np.percentile(tc, 90))
    stats["tile_count_max"] = int(tc.max())
    g = 128
    chunks = np.ceil(tc / g).sum()
    stats["chunk_pad_waste"] = round(float(chunks * g / max(tc.sum(), 1)), 3)
    stats["n_contrib_mean"] = round(float(nc.mean()), 1)
    stats["n_contrib_p90"] = round(float(np.percentile(nc, 90)), 1)
    nc_tile_max = nc.max(axis=1)
    marched = np.minimum(np.ceil(nc_tile_max / g) * g, np.ceil(tc / g) * g)
    stats["marched_pairs_per_tile_mean"] = round(float(marched.mean()), 1)
    stats["useful_frac_of_marched"] = round(
        float(nc.mean()) / max(float(marched.mean()), 1e-9), 3)
    rad = np.asarray(prep.radius)
    vis = rad[rad > 0]
    stats["visible_gaussians"] = int((rad > 0).sum())
    stats["radius_px_p50"] = round(float(np.percentile(vis, 50)), 1) if len(vis) else 0
    stats["radius_px_p90"] = round(float(np.percentile(vis, 90)), 1) if len(vis) else 0
    return stats


def test_stage_stats_equal_gsjax():
    gauss, cfg, prep, binning, planes = _port_stages()
    got = profile_stages.stage_stats(prep, binning, planes[8], cfg, W, H)
    want = _gsjax_stats(gauss)
    assert got["chunk_G"] == 128
    close = ("n_contrib_mean", "n_contrib_p90", "marched_pairs_per_tile_mean",
             "useful_frac_of_marched")
    for k, v in want.items():
        if k in close:
            assert got[k] == pytest.approx(v, rel=5e-3), k
        else:
            assert got[k] == v, k
    assert want["num_pairs"] > 0 and want["n_contrib_mean"] > 0


def test_sort_stage_sorts_the_binnings_keys():
    _, cfg, prep, binning, _ = _port_stages()
    keys, gauss = profile_stages.sort_keys(prep, binning, cfg, W, H)
    assert keys.dtype == torch.int64 and keys.shape[0] == binning.num_live
    _, order = torch.sort(keys, stable=True)
    torch.testing.assert_close(gauss[order], binning.gauss_idx, rtol=0, atol=0)


def _record(name):
    if name == "stages":
        rec = profile_stages.profile(KW, KH, KN, 1, False, CPU)
        return rec["timings_ms"] | rec["stats"], rec["notes"], "PROFILE_r04.json"
    mod = profile_sample if name == "sample" else profile_reg
    rec = mod.profile(KW, KH, KN, 1, CPU)
    return rec, rec.get("notes", {}), ("SAMPLE_PROFILE.json" if name == "sample"
                                       else "REG_PROFILE.json")


@pytest.mark.parametrize("name", ["stages", "sample", "reg"])
def test_profile_keys_are_gsjax_records(name):
    got, notes, record = _record(name)
    ref = json.loads((ROOT / record).read_text())
    if record == "PROFILE_r04.json":
        assert set(ref) <= {"timings_ms", "stats", "n", "width", "height"}
        ref = ref["timings_ms"] | ref["stats"]
    for key in ref:
        k = key.replace("@2073k", f"@{KW * KH // 1000}k")
        assert k in got, k
        v = got[k]
        if v is None:
            assert notes.get(k), f"{k} is null without a reason"
        else:
            assert math.isfinite(v), (k, v)


def test_trepl_repl_equals_gsjax():
    n = 300
    for random in (False, True):
        params, adam, aux, grads, g2d, vis, radii = measure_trepl.trepl_inputs(n, CPU)
        rng = np.random.default_rng(5)
        # measure_trepl.py:32-37
        r0 = np.random.default_rng(0)
        pts = r0.normal(0, 1.2, (n, 3)).astype(np.float32)
        cols = r0.uniform(0, 1, (n, 3)).astype(np.float32)
        jp, jaux = jgm.init_from_pcd(pts, cols, n, sh_degree=3, sg_degree=0,
                                     knn_dist2=np.full((n,), 1e-4, np.float32))
        jadam = jgm.adam_init(jp)
        jgrads = jax.tree_util.tree_map(lambda x: jnp.ones_like(x) * 1e-6, jp)
        jg2d, jvis, jradii = jnp.zeros((n, 2)), jnp.ones((n,), bool), jnp.ones((n,), jnp.int32)
        if random:
            gr = {k: rng.normal(0, 1e-3, getattr(params, k).shape).astype(np.float32)
                  for k in grads}
            grads = {k: torch.as_tensor(v) for k, v in gr.items()}
            jgrads = dataclasses.replace(jgrads, **{k: jnp.asarray(v) for k, v in gr.items()})
            g = rng.normal(0, 1e-3, (n, 2)).astype(np.float32)
            v = rng.uniform(size=n) < 0.7
            rr = rng.integers(0, 40, n).astype(np.int32)
            g2d, vis, radii = torch.as_tensor(g), torch.as_tensor(v), torch.as_tensor(rr)
            jg2d, jvis, jradii = jnp.asarray(g), jnp.asarray(v), jnp.asarray(rr)

        @jax.jit
        def jrepl(params, adam, aux, grads, g2d, vis, radii):
            # scripts/measure_trepl.py:46-55
            aux = jgm.add_densification_stats(aux, g2d, vis, 1920, 1080)
            aux = dataclasses.replace(
                aux, max_radii=jnp.maximum(aux.max_radii, jnp.where(vis, radii, 0)))
            p2, a2 = jgm.adam_update(params, grads, adam, measure_trepl.LRS)
            return p2, a2, aux

        jp2, ja2, jaux2 = jrepl(jp, jadam, jaux, jgrads, jg2d, jvis, jradii)
        p2, a2, aux2 = measure_trepl.repl(params, adam, aux, grads, g2d, vis, radii)
        for k in measure_trepl.LRS:
            for got, want in ((getattr(p2, k), getattr(jp2, k)), (a2.mu[k], getattr(ja2.mu, k)),
                              (a2.nu[k], getattr(ja2.nu, k))):
                np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                           rtol=1e-6, atol=0, err_msg=k)
        for k in ("grad_accum", "grad_accum_abs", "denom"):
            np.testing.assert_allclose(getattr(aux2, k).numpy(), np.asarray(getattr(jaux2, k)),
                                       rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_array_equal(aux2.max_radii.numpy(), np.asarray(jaux2.max_radii))


def test_trace_reg_prints_cpu_table(capsys):
    rec = trace_reg.trace(64, 32, 100, 1, 10, CPU)
    out = capsys.readouterr().out
    assert "== cpu:" in out and rec["top"] and rec["idle_share"] is None
    assert len(out.strip().splitlines()) >= 2
    assert all(r["ms_per_step"] >= 0 for r in rec["top"])


def test_union_of_intervals():
    assert trace_reg.union_ms([(0, 1000), (500, 1500), (3000, 4000)]) == 2.5
    assert trace_reg.union_ms([]) == 0.0


@pytest.mark.parametrize("mod", [profile_stages, measure_trepl, scaling_model,
                                 multihost_demo, profile_sample, profile_reg, trace_reg],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_entries_need_a_card_or_cpu(mod, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code not in (0, None) and "--device cpu" in str(e.value.code)
    assert not list(tmp_path.iterdir())
