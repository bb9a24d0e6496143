"""The port's serving slice end to end on the CPU: a seeded COLMAP scene and
PLY through `gsjax_torch.render.main`, held against gsjax `render()` on the
same views (8-bit PNGs within 1 LSB on >= 99.9% of pixels)."""

import os
from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gsjax.data.readers import load_scene as jload_scene
from gsjax.model import gaussians as jgm
from gsjax.model.io import load_ply as jload_ply
from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster import render as jrender
from gsjax_torch import render as render_cli
from gsjax_torch.config import dump_cfg_args
from gsjax_torch.data.synth import make_gaussians, write_rendered_colmap
from gsjax_torch.model.gaussians import params_from_numpy
from gsjax_torch.model.io import save_ply

torch.set_num_threads(1)
N_VIEWS, W, H = 3, 96, 64


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    scene, model_dir = str(root / "scene"), str(root / "model")
    means, scales, quats, opac, shs = make_gaussians(250, seed=4)
    rng = np.random.default_rng(5)
    shs[:, 1:] = rng.normal(0, 0.1, shs[:, 1:].shape)
    write_rendered_colmap(scene, n_images=N_VIEWS, width=W, height=H,
                          gaussians=(means, scales, quats, opac, shs), device="cpu")
    n = len(means)
    params = dict(xyz=means, features_dc=shs[:, :1], features_rest=shs[:, 1:],
                  opacity=np.log(opac / (1 - opac)), scaling=np.log(scales),
                  rotation=quats, sg_axis=np.zeros((n, 1, 3), np.float32),
                  sg_sharpness=np.zeros((n, 1), np.float32),
                  sg_color=np.zeros((n, 1, 3), np.float32))
    aux = dict(alive=np.ones(n, bool), filter_3d=np.full(n, 0.01, np.float32),
               grad_accum=np.zeros(n), grad_accum_abs=np.zeros(n),
               denom=np.zeros(n), max_radii=np.zeros(n, np.int32))
    save_ply(os.path.join(model_dir, "point_cloud", "iteration_7", "point_cloud.ply"),
             *params_from_numpy(params, aux, "cpu"))
    dump_cfg_args(model_dir, Namespace(
        sh_degree=3, sg_degree=0, source_path=scene, model_path=model_dir,
        images="images", masks="", resolution=-1, white_background=False,
        eval=False, kernel_size=0.0))
    seen = []
    render_cli.main(["-m", model_dir, "--save_depth", "--device", "cpu"],
                    on_view=lambda i, v, out: seen.append(out))
    return scene, model_dir, seen


def test_png_tree(model):
    _, model_dir, seen = model
    base = os.path.join(model_dir, "train", "ours_7")
    want = [f"{i:05d}.png" for i in range(N_VIEWS)]
    for d in ("renders", "gt", "depth"):
        assert sorted(os.listdir(os.path.join(base, d))) == want, d
    assert len(seen) == N_VIEWS
    for out in seen:
        assert out["render"].shape == (H, W, 3)
        assert torch.isfinite(out["median_depth"]).all()
        assert (out["alpha"] > 0.5).float().mean() > 0.05


def test_renders_match_gsjax(model):
    scene, model_dir, _ = model
    params, aux = jload_ply(os.path.join(model_dir, "point_cloud", "iteration_7",
                                         "point_cloud.ply"))
    views = jload_scene(scene, "images", None, False, -1, False).train_views
    cfg = JConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12,
                  chunk=512, tile_batch=8, pair_capacity=1 << 14, backend="ref")
    scales, opac = jgm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    for i, view in enumerate(views):
        out = jrender(params.xyz, scales, params.rotation, opac, jgm.get_features(params),
                      view.camera, cfg, jnp.zeros(3), sg_axis=jgm.get_sg_axis(params),
                      sg_sharpness=jgm.get_sg_sharpness(params),
                      sg_color=params.sg_color, alive=aux.alive)
        want = (np.clip(np.asarray(out["render"]), 0, 1) * 255).astype(np.uint8)
        got = np.asarray(Image.open(os.path.join(
            model_dir, "train", "ours_7", "renders", f"{i:05d}.png")))
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 255 and (diff <= 1).mean() >= 0.999, f"view {i}"
        assert want.mean() > 5, "views must see the scene"
