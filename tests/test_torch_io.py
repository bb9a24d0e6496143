"""PLY and scene IO between gsjax and gsjax_torch, both directions."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.data.readers import load_scene as jload_scene
from gsjax.model.gaussians import GaussianAux as JAux
from gsjax.model.gaussians import GaussianParams as JParams
from gsjax.model.io import load_ply as jload_ply
from gsjax.model.io import save_ply as jsave_ply
from gsjax_torch.data.readers import load_scene as tload_scene
from gsjax_torch.model.gaussians import (AUX_FIELDS, PARAM_FIELDS, params_from_numpy,
                                         params_to_numpy)
from gsjax_torch.model.io import load_ply as tload_ply
from gsjax_torch.model.io import save_ply as tsave_ply
from tests.test_data import write_synthetic_colmap

torch.set_num_threads(1)


def _leaves(n=37, cap=64, g=2, m=15, seed=0):
    """gsjax-layout numpy leaves with SG lobes, filter_3D and dead slots."""
    rng = np.random.default_rng(seed)
    shapes = dict(xyz=(3,), features_dc=(1, 3), features_rest=(m, 3), opacity=(1,),
                  scaling=(3,), rotation=(4,), sg_axis=(g, 3), sg_sharpness=(g,),
                  sg_color=(g, 3))
    params = {k: rng.normal(0, 1, (cap,) + s).astype(np.float32) for k, s in shapes.items()}
    alive = np.zeros(cap, bool)
    alive[rng.choice(cap, n, replace=False)] = True
    aux = dict(alive=alive, filter_3d=rng.uniform(0, 0.1, cap).astype(np.float32),
               grad_accum=rng.uniform(0, 1, cap).astype(np.float32),
               grad_accum_abs=rng.uniform(0, 1, cap).astype(np.float32),
               denom=rng.uniform(0, 5, cap).astype(np.float32),
               max_radii=rng.integers(0, 30, cap).astype(np.int32))
    return params, aux


def _alive_rows(leaves, alive):
    return {k: v[alive] for k, v in leaves.items()}


def test_params_carrier_roundtrip():
    params, aux = _leaves()
    p, a = params_from_numpy(params, aux, "cpu")
    assert p.xyz.shape == (64, 3) and isinstance(p.xyz, torch.nn.Parameter)
    p2, a2 = params_to_numpy(p, a)
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(p2[k], params[k], err_msg=k)
    for k in AUX_FIELDS:
        np.testing.assert_array_equal(a2[k], aux[k], err_msg=k)


def test_ply_gsjax_to_port(tmp_path):
    params, aux = _leaves()
    path = str(tmp_path / "j.ply")
    jsave_ply(path, JParams(**params), JAux(**aux))
    p, a = tload_ply(path, device="cpu")
    jp, ja = jload_ply(path)
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(p, k).detach().numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
        np.testing.assert_array_equal(getattr(p, k).detach().numpy()[:37],
                                      params[k][aux["alive"]], err_msg=k)
    np.testing.assert_array_equal(a.alive.numpy(), np.asarray(ja.alive))
    np.testing.assert_array_equal(a.filter_3d.numpy(), np.asarray(ja.filter_3d))


def test_ply_port_to_gsjax(tmp_path):
    params, aux = _leaves(seed=1, g=1, m=3)
    path = str(tmp_path / "t.ply")
    tsave_ply(path, *params_from_numpy(params, aux, "cpu"))
    jp, ja = jload_ply(path)
    n = int(aux["alive"].sum())
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jp, k))[:n],
                                      params[k][aux["alive"]], err_msg=k)
    np.testing.assert_array_equal(np.asarray(ja.filter_3d)[:n], aux["filter_3d"][aux["alive"]])
    np.testing.assert_array_equal(np.asarray(jp.rotation)[n:, 0], 1.0)


def test_load_scene_matches_gsjax(tmp_path):
    root = str(tmp_path / "scene")
    write_synthetic_colmap(root, n_images=5, width=40, height=30)
    js = jload_scene(root, "images", None, True, -1, False)
    ts = tload_scene(root, "images", None, True, -1, False, device="cpu")
    assert len(ts.train_views) == len(js.train_views) == 4
    assert len(ts.test_views) == len(js.test_views) == 1
    assert ts.radius == pytest.approx(js.radius)
    np.testing.assert_array_equal(ts.points, js.points)
    for tv, jv in zip(ts.train_views + ts.test_views, js.train_views + js.test_views):
        assert tv.image_name == jv.image_name
        np.testing.assert_array_equal(tv.image, jv.image)
        tc, jc = tv.camera, jv.camera
        for name in ("world_view", "full_proj", "campos"):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)), atol=1e-6)
        assert (tc.fx, tc.fy, tc.width, tc.height) == (
            float(jc.fx), float(jc.fy), jc.width, jc.height)
