"""The backward kernels' sum over pixels and points (B2 `csrc/blend_bwd.cu`
and B5 `csrc/sample_bwd.cu`, both on `csrc/bwd_common.cuh`), modelled in
numpy, and the backward wrappers' `counters` on the CPU.

- `warp_reduce_16`'s lane plan: recursive halving with partners lane ^ 16,
  8, 4, 2 (a lane keeps the upper half of its live columns where that bit
  is set), then lane ^ 1. Every lane ends with one column summed over all 32
  lanes, each lane's term exactly once (32 distinct powers of two sum
  without a carry), and column c lands on lanes 2c and 2c + 1; the kernels
  store it from lane 2c (`put_partial`). On random values the result equals
  the column's sum to float32 rounding.
- B2's ownership of a 32x32 tile: warp w a 16x8 patch, lane l a 2x2 quad
  of it, so the block holds every pixel of its tile exactly once and alone
  writes each pair's row.
- `counters=None` runs the twins on CPU tensors, bit for bit; a counters
  buffer there raises, as the median search's `check_search_args` does.
"""

import numpy as np
import pytest
import torch

from gsjax_torch.ops import sample_cuda, sample_ref
from gsjax_torch.ops.raster import render_cuda, render_ref
from gsjax_torch.ops.raster.binning import bin_gaussians
from gsjax_torch.ops.raster.preprocess import preprocess
from tests.test_torch_blend_bwd import BG, H, W, _scene, _tcam, _tcfg
from tests.test_torch_sample import _tcfg as _sample_cfg
from tests.test_torch_sample import _twin_inputs

LANES, COLS = 32, 16


def warp_reduce_16(v):
    """bwd_common.cuh:warp_reduce_16 over a warp: v [32 lanes, 16 columns]
    -> [32] what each lane returns."""
    v = v.copy()
    lane = np.arange(LANES)
    for h in (16, 8, 4, 2):                     # halve<H>
        m = h // 2
        up = ((lane & h) != 0)[:, None]
        keep = np.where(up, v[:, m:2 * m], v[:, :m])
        send = np.where(up, v[:, :m], v[:, m:2 * m])
        v[:, :m] = keep + send[lane ^ h]          # __shfl_xor_sync(send, H)
    return v[:, 0] + v[lane ^ 1, 0]


@pytest.mark.parametrize("values", ["powers", "random"])
def test_lane_plan_sums_every_lane_once(values):
    lane = np.arange(LANES)
    if values == "powers":
        # lane l's term in column c: 2^l, tagged with the column above bit 40
        v = (np.int64(1) << lane[:, None].astype(np.int64)) \
            + (np.arange(COLS, dtype=np.int64)[None, :] << 40)
        got = warp_reduce_16(v)
        low, col = got & ((np.int64(1) << 40) - 1), got >> 40
        assert (low == (np.int64(1) << 32) - 1).all(), "a lane's term missing or twice"
        assert (col == LANES * (lane >> 1)).all(), "terms of another column mixed in"
    else:
        v = np.random.default_rng(0).normal(0, 1, (LANES, COLS)).astype(np.float32)
        got = warp_reduce_16(v)
        want = v.astype(np.float64).sum(0)
        np.testing.assert_allclose(got, want[lane >> 1], rtol=0, atol=1e-5)
    # the kernels store column c from lane 2c: one store of each column
    writers = lane[(lane & 1) == 0] >> 1
    assert sorted(writers.tolist()) == list(range(COLS))


def test_quads_cover_the_tile_once():
    """blend_bwd.cu: x0 = (warp & 1) 16 + (lane & 7) 2, y0 = (warp >> 1) 8 +
    (lane >> 3) 2, pixel k of the quad at (x0 + (k & 1), y0 + (k >> 1))."""
    owner = -np.ones((32, 32), np.int64)
    for warp in range(8):
        patch = []
        for lane in range(32):
            x0 = (warp & 1) * 16 + (lane & 7) * 2
            y0 = (warp >> 1) * 8 + (lane >> 3) * 2
            for k in range(4):
                x, y = x0 + (k & 1), y0 + (k >> 1)
                assert owner[y, x] < 0, "a pixel owned twice"
                owner[y, x] = warp * 32 + lane
                patch.append((x, y))
        xs, ys = zip(*patch)
        assert (max(xs) - min(xs) + 1, max(ys) - min(ys) + 1) == (16, 8)
    assert (owner >= 0).all()


def _blend_inputs():
    cfg = _tcfg(True)
    cam = _tcam()
    prep = preprocess(*map(torch.as_tensor, _scene()), None, None, None, cam, cfg)
    b = bin_gaussians(prep, cfg, W, H)
    feats = render_ref.prepare_pairs(prep, b)
    bg = torch.tensor(BG)
    planes = render_ref.blend_planes(feats, b.tile_start, b.tile_count, W, H, cam.fx,
                                     cam.fy, bg, cfg)
    grad = torch.zeros_like(planes)
    grad[:8] = torch.as_tensor(np.random.default_rng(2).normal(0, 1, (8, H, W)),
                               dtype=torch.float32)
    return (feats, b.tile_start, b.tile_count, planes, grad, W, H, cam.fx, cam.fy, bg,
            cfg)


def test_blend_bwd_counters_on_cpu():
    args = _blend_inputs()
    before = render_cuda.blend_bwd.launches
    got = render_cuda.blend_bwd(*args, counters=None)
    assert torch.equal(got, render_ref.blend_bwd_planes(*args))
    assert got.abs().amax() > 0
    with pytest.raises(ValueError, match="counters"):
        render_cuda.blend_bwd(*args, counters=render_cuda.bwd_counters("cpu"))
    assert render_cuda.blend_bwd.launches == before


def test_sample_bwd_counters_on_cpu():
    feats, ts, tc, xy, blocks = _twin_inputs(torch.float32)
    cfg = _sample_cfg()
    res = sample_ref.sample_fwd_rows(feats, ts, tc, xy, blocks, cfg)
    g = torch.as_tensor(np.random.default_rng(4).normal(0, 1, xy.shape[0]),
                        dtype=torch.float32)
    before = sample_cuda.sample_bwd.launches
    got = sample_cuda.sample_bwd(feats, ts, tc, xy, blocks, res, g, cfg, counters=None)
    want = sample_ref.sample_bwd_rows(feats, ts, tc, xy, blocks, res, g, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].abs().amax() > 0
    with pytest.raises(ValueError, match="counters"):
        sample_cuda.sample_bwd(feats, ts, tc, xy, blocks, res, g, cfg,
                               counters=render_cuda.bwd_counters("cpu"))
    assert sample_cuda.sample_bwd.launches == before


def test_bwd_stats_reads_a_buffer():
    """`bwd_stats` on a hand-filled buffer in bwd_common.cuh:Counter order."""
    c = torch.tensor([200, 50, 400, 900, 10, 20, 30, 60, 80], dtype=torch.int64)
    st = render_cuda.bwd_stats(c)
    assert (st["warp_pairs"], st["warp_pairs_active"], st["applied"]) == (200, 50, 900)
    assert st["active_share"] == 0.25 and st["lanes_per_active"] == 8.0
    assert st["applied_per_active"] == 18.0 and st["warp_cycles"] == 200
    assert st["cycle_shares"] == {"setup": 0.05, "stage": 0.1, "alpha": 0.15,
                                  "apply": 0.3, "reduce": 0.4}
    assert st["cycles_per_warp_pair"] == {"alpha": 0.15, "apply": 1.2, "reduce": 1.6}
