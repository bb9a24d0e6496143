"""The port's multi-device layer (`gsjax_torch.parallel`) on the CPU.

- banded binning: each rank's band (single, and the two bands of a dual
  partition) equals the full binning on its tiles entry for entry, and
  gsjax's banded binning, with count 0 elsewhere;
- the twins of B1 and B2 on a tile-row list equal the full-frame twins on
  those tiles bit for bit (a frame whose last tile row is partial: the rows
  past its height read 0);
- the band choosers equal gsjax's on seeded histograms exactly; the one
  change, `paired_balance_bounds`'s seed where gsjax's 2n-split cannot
  cover the rows (gsjax raises on 9 rows, n = 4, rows_per_max = 3), is
  held on its own, beside gsjax's raise;
- `render_sharded` (equal, custom and dual partitions) and
  `render_views_sharded` (3 views on 2 ranks) against the port's `render()`
  within tests/test_sharding.py's bounds (atol 1e-5 colour and alpha, 1e-4
  depth; read: equal bit for bit);
- `patchmatch_terms` on a band of rows at `row_offset` against gsjax's
  (dense, its XLA point path) within rtol 1e-5;
- the launcher: a rank that raises ends the run at once with its traceback
  while its peer waits in a collective, and the clock limit kills a rank
  that never returns;
- `--n_devices N <= 0` means every device (gsjax's loop.py:713 reads 0 as 1:
  pinned beside it);
- a TensorBoard import that raises TypeError leaves training on without
  scalars (gsjax catches Exception, loop.py:737-743).

Multi-rank tests start their ranks with `parallel.launch` over `gloo` on
the CPU, one torch thread each, a `file://` store under tmp_path (parallel
test workers never share a port) and a launcher timeout of at most 120 s.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster.binning import bin_gaussians as jbin
from gsjax.ops.raster.camera import Camera as JCamera
from gsjax.ops.raster.preprocess import preprocess as jpreprocess
from gsjax.parallel import shard as jshard
from gsjax_torch.model import gaussians as gm
from gsjax_torch.ops.raster import render_ref
from gsjax_torch.ops.raster.binning import bin_gaussians
from gsjax_torch.ops.raster.preprocess import preprocess
from gsjax_torch.parallel import launch, multihost, shard
from tests import torch_ranks as tr

torch.set_num_threads(1)
TIMEOUT = 120


def _store(tmp_path, name="store"):
    return f"file://{tmp_path / name}"


# --- banded binning and the twins on a tile-row list -----------------------

@pytest.fixture(scope="module")
def frame():
    """A 64x150 frame (5 tile rows, the last partial) of 80 gaussians: the
    port's and gsjax's preprocess, the full binning, the twin's planes and a
    seeded cotangent's pair gradients."""
    cam = tr.camera(64, 150)
    cfg = tr.config(True)
    params, aux = gm.params_from_numpy(*tr.model_arrays(n=80, capacity=100, seed=4), "cpu")
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    with torch.no_grad():
        prep = preprocess(params.xyz, scales, params.rotation, opac, gm.get_features(params),
                          None, None, None, cam, cfg, aux.alive)
    full = bin_gaussians(prep, cfg, cam.width, cam.height)
    bg = torch.tensor([0.1, 0.2, 0.3])
    feats = render_ref.prepare_pairs(prep, full)
    tail = (cam.width, cam.height, cam.fx, cam.fy, bg, cfg)
    planes = render_ref.blend_planes(feats, full.tile_start, full.tile_count, *tail)
    grad = torch.randn(planes.shape, generator=torch.Generator().manual_seed(0))
    d_full = render_ref.blend_bwd_planes(feats, full.tile_start, full.tile_count, planes,
                                         grad, *tail)
    jcfg = JConfig(pair_capacity=1 << 14, max_per_tile=256, sh_degree=1)
    jcam = JCamera.create(*tr.camera_rt(), 0.9, 0.7, 64, 150)
    jprep = jpreprocess(*[jnp.asarray(x.detach().numpy()) for x in (
        params.xyz, scales, params.rotation, opac, gm.get_features(params))],
        None, None, None, jcam, jcfg, jnp.asarray(aux.alive.numpy()))
    return dict(cam=cam, cfg=cfg, prep=prep, full=full, feats=feats, tail=tail,
                planes=planes, grad=grad, d_full=d_full, jcfg=jcfg, jprep=jprep)


def _lists(b, tiles):
    return [b.gauss_idx[int(b.tile_start[t]):int(b.tile_start[t]) + int(b.tile_count[t])]
            for t in tiles]


def _band_rows_of(planes, rows, height, t):
    out = []
    for r in rows:
        blk = planes[:, r * t:min((r + 1) * t, height)]
        out.append(torch.cat([blk, blk.new_zeros(blk.shape[0], t - blk.shape[1],
                                                 blk.shape[2])], 1))
    return torch.cat(out, 1)


BANDS = [(0, 2, None, None), (2, 5, None, None), (1, 2, 3, 5), (0, 1, 4, 5), (3, 3, None, None)]


@pytest.mark.parametrize("band", BANDS, ids=["top", "bottom", "dual", "dual_edges", "empty"])
def test_banded_binning_equals_full_on_band_tiles(frame, band):
    lo, hi, lo2, hi2 = band
    cfg, cam, full = frame["cfg"], frame["cam"], frame["full"]
    tx, ty = cfg.grid(cam.width, cam.height)
    b = bin_gaussians(frame["prep"], cfg, cam.width, cam.height, row_lo=lo, row_hi=hi,
                      row_lo2=lo2, row_hi2=hi2)
    rows = list(range(lo, hi)) + (list(range(lo2, hi2)) if lo2 is not None else [])
    tiles = [r * tx + c for r in rows for c in range(tx)]
    others = [t for t in range(tx * ty) if t not in tiles]
    for got, want in zip(_lists(b, tiles), _lists(full, tiles)):
        assert torch.equal(got, want)
    assert int(b.tile_count[others].abs().sum()) == 0
    assert b.num_live == sum(int(full.tile_count[t]) for t in tiles)
    # gsjax's banded binning of the same preprocess: the same lists
    jb = jbin(frame["jprep"], frame["jcfg"], cam.width, cam.height, row_lo=lo, row_hi=hi,
              row_lo2=lo2, row_hi2=hi2, pair_capacity=1 << 12)
    np.testing.assert_array_equal(np.asarray(jb.tile_count), b.tile_count.numpy())
    j_idx, j_start = np.asarray(jb.gauss_idx), np.asarray(jb.tile_start)
    for t, got in zip(tiles, _lists(b, tiles)):
        n = int(b.tile_count[t])
        np.testing.assert_array_equal(got.numpy(), j_idx[j_start[t]:j_start[t] + n])


def test_banded_binning_rejects_overlapping_bands(frame):
    with pytest.raises(ValueError, match="second band"):
        bin_gaussians(frame["prep"], frame["cfg"], 64, 150, row_lo=0, row_hi=3,
                      row_lo2=2, row_hi2=4)


@pytest.mark.parametrize("band", BANDS, ids=["top", "bottom", "dual", "dual_edges", "empty"])
def test_twins_on_a_tile_row_list_equal_the_full_frame(frame, band):
    """B1's twin on the band's rows gives the full frame's planes there (0 past
    the frame's height), and B2's twin the full frame's pair gradients."""
    lo, hi, lo2, hi2 = band
    cfg, cam, full = frame["cfg"], frame["cam"], frame["full"]
    tx, _ = cfg.grid(cam.width, cam.height)
    rows = list(range(lo, hi)) + (list(range(lo2, hi2)) if lo2 is not None else [])
    b = bin_gaussians(frame["prep"], cfg, cam.width, cam.height, row_lo=lo, row_hi=hi,
                      row_lo2=lo2, row_hi2=hi2)
    f = render_ref.prepare_pairs(frame["prep"], b)
    pb = render_ref.blend_planes(f, b.tile_start, b.tile_count, *frame["tail"], tile_rows=rows)
    assert pb.shape == (16, len(rows) * cfg.tile, cam.width)
    if rows:
        assert torch.equal(pb, _band_rows_of(frame["planes"], rows, cam.height, cfg.tile))
        gb = _band_rows_of(frame["grad"], rows, cam.height, cfg.tile)
    else:
        gb = torch.zeros_like(pb)
    db = render_ref.blend_bwd_planes(f, b.tile_start, b.tile_count, pb, gb, *frame["tail"],
                                     tile_rows=rows)
    for t in [r * tx + c for r in rows for c in range(tx)]:
        n = int(b.tile_count[t])
        s_b, s_f = int(b.tile_start[t]), int(full.tile_start[t])
        assert torch.equal(db[s_b:s_b + n], frame["d_full"][s_f:s_f + n])


# --- band choosers ------------------------------------------------------------

def _hists():
    rng = np.random.default_rng(7)
    out = []
    for tiles_y in (9, 17, 34, 64):
        out.append(rng.integers(0, 1000, tiles_y).astype(np.float64))
        out.append(1000.0 * np.exp(-0.5 * ((np.arange(tiles_y) - tiles_y / 2) / 4.0) ** 2))
    return out


@pytest.mark.parametrize("n", [2, 4, 8])
def test_band_choosers_equal_gsjax(n):
    for hist in _hists():
        tiles_y = len(hist)
        rpm = min(tiles_y, 2 * -(-tiles_y // n))
        np.testing.assert_array_equal(shard.equal_band_bounds(tiles_y, n),
                                      jshard.equal_band_bounds(tiles_y, n))
        np.testing.assert_array_equal(shard.balance_band_bounds(hist, n, rpm),
                                      jshard.balance_band_bounds(hist, n, rpm))
        if tiles_y >= 2 * n:
            cap = max(rpm // 2, 1)
            if 2 * n * cap >= tiles_y:
                np.testing.assert_array_equal(shard.dual_balance_bounds(hist, n, cap),
                                              jshard.dual_balance_bounds(hist, n, cap))
                b, p = shard.paired_balance_bounds(hist, n, rpm)
                jb, jp = jshard.paired_balance_bounds(hist, n, rpm)
                np.testing.assert_array_equal(b, jb)
                np.testing.assert_array_equal(p, jp)
        shares = np.random.default_rng(n).uniform(0, 1, 2 * n)
        rows = np.random.default_rng(n + 1).integers(0, 3, 2 * n)
        np.testing.assert_array_equal(shard.pair_bands(shares, rows, 4),
                                      jshard.pair_bands(shares, rows, 4))


def test_paired_balance_bounds_feasible_seed():
    """gsjax's seed (2n bands of rows_per_max // 2) cannot cover 9 rows with
    n = 4, rows_per_max = 3 and raises; the port's seeds from the n-band
    partition there and returns a valid matching within the cap."""
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 1000, 9).astype(np.float64)
    with pytest.raises(ValueError):
        jshard.paired_balance_bounds(hist, 4, 3)
    for h in (hist, np.ones(9), np.exp(-0.5 * ((np.arange(9) - 4) / 1.5) ** 2)):
        b, pr = shard.paired_balance_bounds(h, 4, 3)
        assert b[0] == 0 and b[-1] == 9 and np.all(np.diff(b) >= 0)
        assert sorted(pr.reshape(-1).tolist()) == list(range(8))
        rows = b[1:] - b[:-1]
        assert np.all(rows[pr[:, 0]] + rows[pr[:, 1]] <= 3)
        shard.check_partition(b, pr, 9, 4)
    # every feasible (rows, n, cap) returns a valid partition
    for tiles_y in range(1, 14):
        for n in (1, 2, 3, 4):
            for cap in range(max(1, -(-tiles_y // n)), tiles_y + 1):
                b, pr = shard.paired_balance_bounds(rng.uniform(0, 10, tiles_y), n, cap)
                rows = b[1:] - b[:-1]
                assert np.all(rows[pr[:, 0]] + rows[pr[:, 1]] <= cap), (tiles_y, n, cap)


def test_partition_rows_and_checks():
    """A mirrored dual partition: rank d owns bands d and 7 - d (band A's
    rows first); a free matching; malformed bounds and matchings raise."""
    b, p = shard.check_partition([0, 1, 1, 2, 4, 4, 5, 7, 8], None, 8, 4)
    assert [shard.band_rows(b, p, r).tolist() for r in range(4)] == [
        [0, 7], [5, 6], [1, 4], [2, 3]]
    b, p = shard.check_partition([0, 1, 1, 2, 4, 4, 5, 7, 8], [[0, 5], [1, 2], [3, 6], [4, 7]],
                                 8, 4)
    assert [shard.band_rows(b, p, r).tolist() for r in range(4)] == [
        [0, 4], [1], [2, 3, 5, 6], [7]]
    assert shard.band_intervals(b, p, 2) == (2, 4, 5, 7)
    for bad in ([0, 2, 1, 8, 8], [0, 2, 3, 4], [1, 2, 3, 4, 8]):
        with pytest.raises(ValueError):
            shard.check_partition(bad, None, 8, 4)
    with pytest.raises(ValueError, match="matching"):
        shard.check_partition([0, 1, 2, 3, 4, 5, 6, 7, 8], [[0, 1], [1, 2], [4, 5], [6, 7]],
                              8, 4)


# --- serving ------------------------------------------------------------------

RENDER_CASES = {
    2: [dict(name="equal_2", width=96, height=64, angles=(0.0, 0.25, -0.4)),
        dict(name="dual_2", width=64, height=150, bounds=[0, 1, 2, 4, 5],
             pair=[[0, 2], [1, 3]])],
    4: [dict(name="custom_4", width=64, height=150, bounds=[0, 3, 3, 4, 5])],
}


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """Each group's render cases on 2 and on 4 ranks: {name: [per rank]}."""
    out = {}
    for n, cases in RENDER_CASES.items():
        store = tmp_path_factory.mktemp(f"render{n}") / "store"
        res = launch.launch(tr.rank_renders, n, args=(cases,), init_method=f"file://{store}",
                            timeout=TIMEOUT)
        for i, case in enumerate(cases):
            out[case["name"]] = [r[i] for r in res]
    return out


@pytest.mark.parametrize("case", [c for cs in RENDER_CASES.values() for c in cs],
                         ids=[c["name"] for cs in RENDER_CASES.values() for c in cs])
def test_render_sharded_matches_single(rendered, case):
    res = rendered[case["name"]]
    single = tr.single_render(case)
    for one, views in res:
        np.testing.assert_allclose(one["color"], single[0]["render"], atol=1e-5)
        np.testing.assert_allclose(one["alpha"], single[0]["alpha"], atol=1e-5)
        np.testing.assert_allclose(one["median_depth"], single[0]["median_depth"], atol=1e-4)
        np.testing.assert_allclose(one["normal"], single[0]["normal"], atol=1e-5)
        if case.get("angles"):
            assert views["render"].shape[0] == len(case["angles"])
            for i, s in enumerate(single[1:]):
                np.testing.assert_allclose(views["render"][i], s["render"], atol=1e-5)
                np.testing.assert_allclose(views["alpha"][i], s["alpha"], atol=1e-5)
                np.testing.assert_allclose(views["median_depth"][i], s["median_depth"],
                                           atol=1e-4)
    for one, _ in res[1:]:
        assert all(np.array_equal(one[k], res[0][0][k]) for k in one)


# --- multi-view terms on a band -----------------------------------------------

def test_patchmatch_terms_row_offset_matches_gsjax():
    """The terms of rows 8..24 of tests/test_torch_multiview.py's 64x32
    reference view (its arc scene, real reprojection errors) at row_offset 8
    against gsjax's dense `patchmatch_terms` (XLA point path, `_bilinear`
    NCC), within rtol 1e-5; and the four 8-row bands of the frame sum to the
    whole frame's terms."""
    from gsjax.train.multiview import patchmatch_terms as jterms
    from gsjax_torch.ops.raster import RasterConfig as TConfig
    from gsjax_torch.ops.raster.camera import Camera as TCamera
    from gsjax_torch.train.multiview import patchmatch_terms as tterms
    from tests.test_torch_multiview import NEAR, REF, _cams, _inputs

    g, md, nrm, gr, gn = _inputs()
    tcams, jcams = _cams(TCamera, device="cpu"), _cams(JCamera)
    tcfg = TConfig(max_per_tile=256, chunk=128, require_depth=True)
    jcfg = JConfig(pair_capacity=1 << 14, max_per_tile=256, chunk=128, sh_degree=0,
                   require_depth=True, backend="ref")
    tg = [torch.as_tensor(x) for x in g]
    alive = torch.ones(g[0].shape[0], dtype=torch.bool)

    def port(r0, r1):
        with torch.no_grad():
            return tterms(torch.as_tensor(md[r0:r1]), torch.as_tensor(nrm[r0:r1]), *tg, alive,
                          tcams[REF], tcams[NEAR], torch.as_tensor(gr), torch.as_tensor(gn),
                          tcfg, row_offset=r0)

    j = jterms(jnp.asarray(md[8:24]), jnp.asarray(nrm[8:24]), *map(jnp.asarray, g),
               jnp.asarray(alive.numpy()), jcams[REF], jcams[NEAR], jnp.asarray(gr),
               jnp.asarray(gn), jcfg, row_offset=8)
    t = port(8, 24)
    assert int(t[3]) > 0 and float(t[2]) > 1e-3, "the band's geometric terms must be live"
    assert int(t[1]) > 0, "the band's NCC must be live"
    for k, (got, want) in enumerate(zip(t[:4], j[:4])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7,
                                   err_msg=("ncc_sum", "ncc_cnt", "geo_sum", "geo_cnt")[k])
    whole = port(0, 32)
    parts = [port(r, r + 8) for r in range(0, 32, 8)]
    for k in range(4):
        np.testing.assert_allclose(sum(float(p[k]) for p in parts), float(whole[k]),
                                   rtol=1e-5, atol=1e-6)


# --- launcher -----------------------------------------------------------------

def test_launch_returns_in_rank_order(tmp_path):
    assert launch.launch(tr.rank_sum, 3, args=(5,), init_method=_store(tmp_path),
                         timeout=TIMEOUT) == [(0, 18), (1, 18), (2, 18)]


def test_launch_ends_when_a_rank_raises(tmp_path):
    """Rank 1 raises while rank 0 waits in an all-reduce: the launcher kills
    rank 0 and raises with rank 1's traceback, well before its limit."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        launch.launch(tr.rank_fail, 2, args=(1,), init_method=_store(tmp_path),
                      timeout=TIMEOUT)
    assert time.monotonic() - t0 < 60


def test_launch_kills_at_its_time_limit(tmp_path):
    with pytest.raises(RuntimeError, match="still running"):
        launch.launch(tr.rank_sleep, 2, args=(600,), init_method=_store(tmp_path),
                      timeout=5)


# --- start-up -----------------------------------------------------------------

def test_n_devices_zero_means_every_device(monkeypatch, tmp_path):
    """The port: N <= 0 -> every card (min(N, cards) on the card), every
    device on the CPU being one. gsjax (not fixed): `--n_devices 0` gives an
    unsharded trainer although the tests' CPU has 8 devices (loop.py:713)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert multihost.resolve_ranks(0, "cuda") == 3
    assert multihost.resolve_ranks(-1, None) == 3
    assert multihost.resolve_ranks(2, "cuda") == 2
    assert multihost.resolve_ranks(8, "cuda") == 3
    assert multihost.resolve_ranks(0, "cpu") == 1
    assert multihost.resolve_ranks(4, "cpu") == 4

    import jax
    from argparse import Namespace

    from gsjax.config import ModelParams, OptimizationParams
    from gsjax.train.loop import run_training
    from tests.test_data import write_synthetic_colmap

    assert len(jax.devices()) == 8
    root = str(tmp_path / "scene")
    os.makedirs(root)
    write_synthetic_colmap(root, n_images=2, width=32, height=32)
    lp = Namespace(**ModelParams._defaults())
    lp.source_path, lp.model_path, lp.sh_degree = root, str(tmp_path / "out"), 0
    op = Namespace(**OptimizationParams._defaults())
    op.iterations = 0
    args = Namespace(test_iterations=[], save_iterations=[], checkpoint_iterations=[],
                     start_checkpoint=None, n_devices=0)
    trainer = run_training(lp, op, None, args)
    assert not trainer.sharded


def test_tensorboard_failure_trains_on(tmp_path, monkeypatch, capsys):
    """`torch.utils.tensorboard` raising TypeError on import (as a protobuf
    mismatch does): the run trains on, without scalars."""
    import builtins
    import sys

    from gsjax_torch.data.synth import write_rendered_colmap
    from gsjax_torch.train import main

    scene = str(tmp_path / "scene")
    write_rendered_colmap(scene, n_images=2, width=32, height=32, device="cpu")
    real_import = builtins.__import__

    def fake_import(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise TypeError("Descriptors cannot be created directly")
        return real_import(name, *a, **kw)

    monkeypatch.delitem(sys.modules, "torch.utils.tensorboard", raising=False)
    monkeypatch.setattr(builtins, "__import__", fake_import)
    out = str(tmp_path / "out")
    trainer = main(["-s", scene, "-m", out, "--iterations", "2", "--ip", "",
                    "--test_iterations", "2", "--save_iterations", "2", "--device", "cpu"])
    assert trainer.iteration == 2
    assert "TensorBoard unavailable (TypeError" in capsys.readouterr().out
    assert not any(f.startswith("events.out") for f in os.listdir(out))
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_2", "point_cloud.ply"))
