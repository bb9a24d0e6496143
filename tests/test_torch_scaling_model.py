"""The port's scaling model (`gsjax_torch.scaling_model`) against gsjax's
`scripts/scaling_model.py`.

- Rows: with gsjax's `bench_scene_row_hist` monkeypatched to a seeded
  34-row histogram (the script is not edited), a fixed profile JSON, gsjax's
  payloads (its tile buffers, capacity x 59 f32 of gradients, capacity x 24
  of preprocess) and its 90 GB/s, the port's `model_rows` equal the script's
  rows key for key.
- Row histogram: the port's `bench_scene_row_hist` (its preprocess and
  binning) equals gsjax's at 192x128 / 2000 gaussians exactly.
- Payloads: `port_payloads` equals what one 2-rank gloo step of
  `train_step_sharded` on the CPU sends through `parallel/collectives.py`,
  recorded at `torch.distributed` (`tests/torch_ranks.py:rank_payloads`),
  on equal rows with a padded band and on a mirrored dual partition.
- The CLI on the CPU: the n = 1 row is the profile's full step, the link is
  the datasheet's unless measured, t_repl measured, given or read from a
  file with its source named, a measured table lands beside the rows; and
  the link probe runs on 2 gloo ranks.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from gsjax.ops.raster import RasterConfig as JConfig
from gsjax_torch import scaling_model as sm
from gsjax_torch.bench import bench_config
from gsjax_torch.parallel import launch
from gsjax_torch.parallel.shard import equal_band_bounds

import torch_ranks as tr

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROFILE = {"timings_ms": {"preprocess": 8.07, "preprocess VJP": 14.98,
                          "FULL fwd+bwd step": 244.63, "FULL fwd only": 130.0}}
torch.set_num_threads(1)


def _gsjax_script():
    spec = importlib.util.spec_from_file_location("gsjax_scaling_model",
                                                  ROOT / "scripts" / "scaling_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rows_equal_gsjax_script(tmp_path, monkeypatch):
    hist = np.random.default_rng(3).integers(5_000, 60_000, 34)
    cfg = JConfig()
    script = _gsjax_script()
    monkeypatch.setattr(script, "bench_scene_row_hist", lambda: (hist, 60, 34, cfg))
    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps(PROFILE))
    out = tmp_path / "model.json"
    monkeypatch.setattr("sys.argv", ["scaling_model.py", "--profile", str(prof),
                                     "--t_repl_ms", "2.183", "--out", str(out)])
    script.main()
    want = json.loads(out.read_text())["rows"]

    cap = 100_000
    frame = 60 * 34 * cfg.pixels_per_tile * (3 + 3 + 1 + 1) * 4
    gsjax_payloads = [("frame", "all_gather", frame), ("grad", "all_reduce", cap * 59 * 4),
                      ("prep", "all_gather", cap * 24 * 4)]
    t = PROFILE["timings_ms"]
    got = sm.model_rows(hist, 34, t["preprocess"] + t["preprocess VJP"], 2.183,
                        t["FULL fwd+bwd step"], lambda *_: gsjax_payloads, 90.0)
    assert [r["devices"] for r in got] == [1, 2, 4, 8, 16]
    for g, w in zip(got, want, strict=True):
        assert {k: g[k] for k in w} == w


def test_row_hist_equals_gsjax():
    want = _gsjax_script().bench_scene_row_hist(192, 128, 2000)
    got = sm.bench_scene_row_hist(192, 128, 2000, "cpu")
    assert got[1:3] == want[1:3] == (6, 4)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[0].sum() > 0


def test_payloads_equal_recorded_collectives(tmp_path):
    # the step gathers the 8 image planes with or without the median depth
    cases = [{"width": 96, "height": 96, "require_depth": False},
             {"width": 96, "height": 96, "require_depth": False,
              "bounds": [0, 1, 2, 2, 3]}]
    rec = launch.launch(tr.rank_payloads, 2, args=(cases,),
                        init_method=f"file://{tmp_path / 'store'}", timeout=120)
    assert rec[0] == rec[1]
    cfg = tr.config()
    cols = sm.step_columns(cfg)
    for case, seen in zip(cases, rec[0], strict=True):
        bounds = case.get("bounds", equal_band_bounds(3, 2))
        want = sm.port_payloads(2, bounds, None, 100, 96, 96, cfg, cols)
        assert sorted(seen) == sorted((op, b) for _, op, b in want), case
    assert cols == {"prep_float": 17, "prep_int": 7, "grad": 32}


def test_cli_on_cpu(tmp_path):
    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps(PROFILE))
    out = tmp_path / "m.json"
    base = ["--profile", str(prof), "--width", "96", "--height", "64", "--n", "300",
            "--capacity", "1000", "--out", str(out), "--device", "cpu"]
    rec = sm.main(base + ["--t_repl_ms", "2.0"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    rows = rec["rows"]
    assert rows[0]["pred_step_ms"] == round(PROFILE["timings_ms"]["FULL fwd+bwd step"], 2)
    assert rec["inputs"]["ici_gbps"] == sm.NVLINK_GBPS
    assert rec["inputs"]["link_gbps_source"] == "datasheet, unmeasured"
    assert rec["inputs"]["t_repl_source"] == "given on the command line"
    for r in rows[1:]:
        loads = [(k, op, r["payload_bytes"][k]) for k, op, _ in
                 sm.port_payloads(r["devices"], equal_band_bounds(2, r["devices"]), None,
                                  1000, 96, 64, bench_config(), rec["inputs"]["step_columns"])]
        assert r["collective_ms"] == round(sm.collective_ms(loads, r["devices"], 450.0), 3)
    assert rec["falsify"]["measured"] is None

    line = tmp_path / "trepl.txt"
    line.write_text('noise\n{"metric": "t_repl_ms", "value": 1.25, "capacity": 1000}\n')
    table = tmp_path / "SCALING_torch.json"
    table.write_text(json.dumps({"mode": "train", "rows": [
        {"devices": 1, "iter_s": 0.1, "efficiency": 1.0},
        {"devices": 2, "iter_s": 0.06, "efficiency": 0.83}]}))
    rec = sm.main(base + ["--t_repl_file", str(line), "--measured", str(table),
                          "--ici_gbps", "300"])
    assert rec["inputs"]["t_repl_ms"] == 1.25 and str(line) in rec["inputs"]["t_repl_source"]
    assert rec["inputs"]["ici_gbps"] == 300
    assert rec["inputs"]["link_gbps_source"] == "given on the command line"
    m = rec["falsify"]["measured"]
    assert [x["devices"] for x in m] == [1, 2]
    assert m[1]["measured_speedup"] == pytest.approx(0.1 / 0.06)
    assert m[1]["pred_speedup"] == pytest.approx(rec["rows"][0]["pred_step_ms"]
                                                 / rec["rows"][1]["pred_step_ms"])
    rec = sm.main(base)
    assert rec["inputs"]["t_repl_source"].startswith("measured in this run")
    assert rec["inputs"]["t_repl_ms"] > 0


def test_link_probe_on_gloo():
    r = sm.measure_link_gbps(2, 1 << 16, iters=2, timeout=120, device="cpu")
    assert r["backend"] == "gloo" and r["value"] > 0 and r["ranks"] == 2
