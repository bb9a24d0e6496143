"""The reference's frozen copies agree with the port's plain twins, and
import nothing of the port."""

import ast
import dataclasses
import os
import random

import pytest
import torch

from gsbench import harness, scenes
from gsbench.traffic import render as render_driver
from gsbench.traffic import train as train_driver
from gsbench.tests.conftest import SCALE

REF = os.path.join(harness.HERE, "reference")


def test_reference_imports_nothing_of_the_port():
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in ("gsjax_torch", "gsjax", "jax", "jaxlib",
                                               "flax"), (name, m)


def test_reference_render_equals_the_port_twin():
    from gsjax_torch.ops.raster import RasterConfig, render

    from gsbench.reference import loop

    cfg = harness.load_json(os.path.join(harness.HERE, "configs", "m360_bicycle.json"))
    scene = scenes.make_scene(cfg, 11, "cpu", SCALE, targets=False)
    params, aux, cams = loop.model(scene, "cpu")
    ref = loop.render_frame(params, aux, cams[3], cfg, 4096)
    model, pcams = render_driver.render_model(scenes.make_scene(cfg, 11, "cpu", SCALE, targets=False),
                                        cfg, "cpu")
    rcfg = RasterConfig(sh_degree=cfg["sh_degree"], sg_degree=cfg["sg_degree"],
                        require_depth=True, max_per_tile=4096, backend="torch")
    out = render(camera=pcams[3], cfg=rcfg, bg=torch.zeros(3), **model)
    for k in ("render", "alpha", "normal", "median_depth"):
        torch.testing.assert_close(out[k], ref[k], rtol=1e-5, atol=1e-5)


def test_reference_steps_equal_the_port_twins():
    """Three training steps of the port on its twins (CPU) and the
    reference's: the first step's numbers equal; later steps start from
    parameters that Adam moved by a whole learning rate wherever rounding
    flipped a near-zero gradient's sign, so their discrete NCC mask flips a
    few pixels: losses within 5e-3, the parameters' change within 1e-2 by
    the worst leaf."""
    from gsbench import check
    from gsbench.reference import loop

    bench = harness.benchmark()
    entry = harness.cell(bench, "tnt.train_mv")
    cfg, traffic = entry["config"], entry["traffic"]
    seed = 2**32 + 3
    scene = scenes.make_scene(cfg, seed, "cpu", SCALE)
    p0 = {k: v.clone() for k, v in scene.params.items()}
    trainer = train_driver.build_trainer(scene, cfg, traffic, torch.device("cpu"), "unused", seed)
    random.seed(seed)
    prog = [trainer.step() for _ in range(3)]
    ref_change, ref_grad = {}, {}

    def on_step(i, p, a, m):
        if i == 0:
            ref_grad.update(check.leaf_norms({k: v / 0.1 for k, v in a.mu.items()}))
        ref_change.update(check.leaf_norms({k: getattr(p, k).detach() - p0[k] for k in p0}))

    ref = loop.train_steps(scenes.make_scene(cfg, seed, "cpu", SCALE), cfg, traffic, seed, 3,
                           "cpu", on_step=on_step)
    for i, (p, r) in enumerate(zip(prog, ref)):
        assert (p["view"], p["near"], p["mv_queries"]) == (r["view"], r["near"], r["mv_queries"])
        for k in ("loss", "ncc_loss", "geo_loss"):
            assert p[k] == pytest.approx(r[k], rel=1e-6 if i == 0 else 5e-3), (i, k)
    prog_change = check.leaf_norms({k: getattr(trainer.params, k).detach() - p0[k] for k in p0})
    assert check.leaf_gap(prog_change, ref_change, ref_grad) < 1e-2


def test_control_rounds_between_stages():
    from gsbench.reference import config, precision

    x = torch.tensor([1.0 + 2**-10], requires_grad=True)
    cfg = dataclasses.replace(config.RasterConfig(), round_to="bfloat16")
    y = precision.stage(x, cfg)
    assert float(y) == 1.0
    y.backward(torch.tensor([1.0 + 2**-10]))
    assert float(x.grad) == 1.0
    assert precision.stage(x, config.RasterConfig()) is x
