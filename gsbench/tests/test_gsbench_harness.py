"""The harness finds cells, configurations, traffic, limits and readers by
name, a kind of traffic by its module alone, and `BENCHMARK.json` keeps to
its contract's shape."""

import json
import os
import re
import sys
import time
import types

import pytest

from gsbench import drivers, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        e = harness.cell(bench, w["name"])
        assert callable(harness.driver(e["traffic"]["kind"]).run)
        assert e["config"]["name"] == w["config"]
        assert set(e["limits"]) and all("limit" in v for v in e["limits"].values())
        assert harness.end_to_end(bench, w["name"])
        for m in harness.per_layer(bench, w["name"]):
            assert callable(harness.reader(m["name"]))
        names = {m["name"] for m in harness.end_to_end(bench, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert harness.per_layer(bench, w["name"])


def test_benchmark_shape():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert NAME.match(c["name"]) and os.path.exists(os.path.join(harness.ROOT, c["file"]))
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        for w in m["workloads"]:
            moved = [x for x in bench["end_to_end"] if x["name"] == m["moves"]][0]
            assert w in moved.get("workloads", [w])
    assert len(json.dumps(bench)) < 64 * 1024


def test_drivers_found_by_kind():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        kind = harness.cell(bench, w["name"])["traffic"]["kind"]
        mod = harness.driver(kind)
        for fn in ("run", "readings", "reference", "compare", "control"):
            assert callable(getattr(mod, fn)), (kind, fn)
        assert mod.FAULTS and mod.KERNELS
        assert isinstance(mod.APPLIED, dict) and mod.APPLIED, kind
    assert all("workloads" in m for m in bench["per_layer"])


def test_configuration_options_applied_or_refused():
    """Each configuration against the `APPLIED` table of every kind of
    traffic that a cell runs it under."""
    bench = harness.benchmark()
    files = {c["name"]: c["file"] for c in bench["configs"]}
    pairs = {(w["config"], harness.cell(bench, w["name"])["traffic"]["kind"])
             for w in bench["workloads"]}
    for conf, kind in sorted(pairs):
        applied = harness.driver(kind).APPLIED
        cfg = harness.load_json(os.path.join(harness.ROOT, files[conf]))
        drivers.options(cfg, applied)
        with pytest.raises(ValueError, match="no option"):
            drivers.options(dict(cfg, unknown_switch=1), applied)
        for key, allowed in applied.items():
            if allowed is not None:
                with pytest.raises(ValueError, match="reference follows only"):
                    drivers.options(dict(cfg, **{key: "a value no reference follows"}),
                                    applied)
        with pytest.raises(ValueError, match="precision"):
            drivers.options(dict(cfg, precision="bfloat16"), applied)


STUB_KIND = "stub_kind_of_a_test"


def _stub_tree(root):
    """A benchmark tree with one cell of a kind that no file names: its
    configuration, traffic mix and limits, and `BENCHMARK.json`."""
    here = root / "gsbench"
    for d in ("configs", "traffic", "limits"):
        (here / d).mkdir(parents=True)
    (here / "configs" / "stub.json").write_text(json.dumps({"name": "stub_conf"}))
    (here / "traffic" / "stub_mix.json").write_text(json.dumps({"kind": STUB_KIND}))
    (here / "limits" / "stub.cell.json").write_text(json.dumps({"stub_gap": {"limit": 0.1}}))
    bench = {"configs": [{"name": "stub_conf", "file": "gsbench/configs/stub.json"}],
             "workloads": [{"name": "stub.cell", "config": "stub_conf", "traffic": "stub_mix",
                            "chips": 4}],
             "end_to_end": [{"name": "stub_ms", "unit": "ms", "workloads": ["stub.cell"]},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": []}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return here


def test_a_new_kind_needs_no_edit(tmp_path, monkeypatch):
    """A kind module registered in `sys.modules` (as a new file under
    `traffic/` would be imported) resolves through `harness.cell` and
    `harness.driver` and runs through `harness.run_cell`, its ranks'
    forbidden modules handed back to `run.py`."""
    here = _stub_tree(tmp_path)
    stub = types.ModuleType(f"gsbench.traffic.{STUB_KIND}")

    def run(cfg, traffic, seed, seconds, trace, device, t_start, scale=1.0):
        # as if gathered from ranks: the fullest device's peak, and a rank
        # that loaded JAX
        return drivers.Run(1.5, {"stub_ms": 2.0, "setup_s": 1.5}, 3, 0, 9,
                           {"stub_gap": 0.05}, {"cfg": cfg["name"]}, rank_modules=["jax"])

    stub.run = run
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    monkeypatch.setattr(harness, "HERE", str(here))
    e = harness.cell(harness.benchmark(), "stub.cell")
    assert harness.driver(e["traffic"]["kind"]) is stub
    assert e["limits"] == {"stub_gap": {"limit": 0.1}}
    out, err, in_ranks = harness.run_cell("stub.cell", 5, 0.1, False, "cpu", time.time())
    assert out["correct"] is True and out["notes"] == {"cfg": "stub_conf"}
    assert out["metrics"] == {"stub_ms": {"value": 2.0, "unit": "ms"},
                              "setup_s": {"value": 1.5, "unit": "s"}}
    assert out["device"]["count"] == 4 and out["device"]["memory_peak_bytes"] == 9
    assert in_ranks == ["jax"] and err[0] == "check stub_gap: 0.05 (limit 0.1)"

