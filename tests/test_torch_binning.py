"""gsjax_torch `bin_gaussians` against gsjax's, on the same `Preprocessed`.

Each tile's list of gaussian ids must equal gsjax's in order (gsjax's
128-aligned padding slots dropped), and `tile_count` / `max_tile_count`
must be equal — including a tile that overflows `max_per_tile`, whose list
both clamp at the cap — with the blend's cull box and with the point
queries' (`continuous_coords`, whose box runs to the tile's far edge).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster.binning import bin_gaussians as jbin
from gsjax.ops.raster.preprocess import preprocess as jpreprocess
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster.binning import bin_gaussians as tbin
from gsjax_torch.ops.raster.preprocess import Preprocessed as TPrep
from tests.test_overflow import overflow_scene
from tests.util import look_at_camera, random_gaussians

torch.set_num_threads(1)


def _scene(name):
    if name == "overflow":
        means, scales, q, op, shs, cam, cfg = overflow_scene()
        return (means, scales, q, op, shs), cam, dict(
            tile=cfg.tile, max_per_tile=cfg.max_per_tile, sh_degree=cfg.sh_degree)
    if name == "wide":
        g = random_gaussians(400, seed=21, spread=1.5)
        return g, look_at_camera(256, 160, fovx=1.2, fovy=0.8), dict(
            max_per_tile=4096, sh_degree=3)
    g = random_gaussians(150, seed=3)
    return g, look_at_camera(96, 64), dict(max_per_tile=256, sh_degree=3)


@pytest.fixture(scope="module", params=[("small", False), ("wide", False),
                                        ("overflow", False), ("small", True),
                                        ("wide", True)],
                ids=["small", "wide", "overflow", "small_continuous", "wide_continuous"])
def binned(request):
    name, continuous = request.param
    g, cam, kw = _scene(name)
    jcfg = JConfig(pair_capacity=1 << 14, **kw)
    prep = jpreprocess(*map(jnp.asarray, g), None, None, None, cam, jcfg, None)
    tprep = TPrep(**{f.name: torch.as_tensor(np.array(getattr(prep, f.name)))
                     for f in dataclasses.fields(TPrep)})
    jb = jbin(prep, jcfg, cam.width, cam.height, continuous_coords=continuous)
    tb = tbin(tprep, TConfig(**kw), cam.width, cam.height, continuous_coords=continuous)
    return name, jcfg, jb, tb


def test_tile_lists_match(binned):
    name, cfg, jb, tb = binned
    j_idx = np.asarray(jb.gauss_idx)
    j_start = np.asarray(jb.tile_start)
    counts = np.asarray(jb.tile_count)
    t_idx = tb.gauss_idx.numpy()
    t_start = tb.tile_start.numpy()
    np.testing.assert_array_equal(tb.tile_count.numpy(), counts)
    assert tb.max_tile_count == int(jb.max_tile_count)
    assert tb.num_live == int(jb.num_live)
    assert tb.num_pairs == int(jb.num_pairs)
    assert counts.sum() > 100, "scene must bin a real number of pairs"
    for t in range(counts.shape[0]):
        k = min(int(counts[t]), cfg.max_per_tile)
        np.testing.assert_array_equal(t_idx[t_start[t]:t_start[t] + k],
                                      j_idx[j_start[t]:j_start[t] + k],
                                      err_msg=f"{name}: tile {t}")
    if name == "overflow":
        assert tb.max_tile_count > cfg.max_per_tile
