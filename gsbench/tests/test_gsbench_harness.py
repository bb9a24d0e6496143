"""The harness finds cells, configurations, traffic, limits and readers by
name, and `BENCHMARK.json` keeps to its contract's shape."""

import json
import os
import re

from gsbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        e = harness.cell(bench, w["name"])
        assert e["traffic"]["kind"] in ("train", "render")
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
    assert all("workloads" in m for m in bench["per_layer"])


def test_configuration_options_applied_or_refused():
    import pytest

    from gsbench import drivers
    from gsbench.traffic import render, train

    for conf in harness.benchmark()["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, conf["file"]))
        drivers.options(cfg, train.APPLIED)
        drivers.options(cfg, render.APPLIED)
        with pytest.raises(ValueError, match="no option"):
            drivers.options(dict(cfg, unknown_switch=1), train.APPLIED)
        with pytest.raises(ValueError, match="reference follows only"):
            drivers.options(dict(cfg, use_decoupled_appearance=3), train.APPLIED)
        with pytest.raises(ValueError, match="precision"):
            drivers.options(dict(cfg, precision="bfloat16"), train.APPLIED)
