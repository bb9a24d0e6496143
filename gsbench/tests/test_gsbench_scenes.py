"""The generator: deterministic per seed, the configuration's sizes."""

import numpy as np
import pytest
import torch

from gsbench import harness, scenes
from gsbench.tests.conftest import SCALE


@pytest.mark.parametrize("config", ["tnt_truck", "m360_bicycle"])
def test_generator_is_deterministic_and_sized(config):
    bench = harness.benchmark()
    cfg = harness.load_json(
        {c["name"]: c for c in bench["configs"]}[config]["file"])
    a = scenes.make_scene(cfg, 2**33 + 5, "cpu", SCALE)
    b = scenes.make_scene(cfg, 2**33 + 5, "cpu", SCALE)
    c = scenes.make_scene(cfg, 7, "cpu", SCALE)
    for k in scenes.PARAM_FIELDS:
        assert torch.equal(a.params[k], b.params[k])
    assert not torch.equal(a.params["xyz"], c.params["xyz"])
    np.testing.assert_array_equal(a.images, b.images)
    n = scenes.gaussian_count(cfg, SCALE)
    assert a.n == n and int(a.alive.sum()) == n and a.capacity >= n / 0.9
    assert len(a.views) == cfg["train_views"]
    w, h = scenes.frame_size(cfg, SCALE)
    assert a.images.shape == (cfg["train_views"], h, w, 3)
    m = (cfg["sh_degree"] + 1) ** 2
    assert a.params["features_rest"].shape == (a.capacity, m - 1, 3)
    assert a.params["sg_axis"].shape[1] == max(cfg["sg_degree"], 1)
    # full size: the published widths, the count and the views
    w, h = scenes.frame_size(cfg)
    assert [w, h] == cfg["resolution"] and scenes.gaussian_count(cfg) == cfg["gaussians"]
    # flat gaussians: the thin axis, along the surface normal, mostly the smallest
    rot = a.params["rotation"][:n]
    assert torch.allclose(torch.linalg.norm(rot, dim=1), torch.ones(n), atol=1e-5)
    s = torch.exp(a.params["scaling"][:n])
    assert float((s[:, 2] < s[:, 0]).float().mean()) > 0.5


def test_every_view_has_neighbours():
    from gsbench.reference import views

    bench = harness.benchmark()
    for conf in bench["configs"]:
        cfg = harness.load_json(conf["file"])
        vs = scenes.orbit_views(cfg, SCALE)
        nb = views.nearest_view_graph(np.stack([v.center for v in vs]),
                                      np.stack([v.R for v in vs]))
        assert all(len(x) == cfg["multi_view_num"] for x in nb)
