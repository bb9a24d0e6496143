"""Drive gsjax_torch's serving and training paths on one CUDA card and check
its kernels.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):
  device      the card's name and power limit (nvidia-smi);
  build       compile every hand-written kernel from `gsjax_torch/csrc/`
              with nvcc, one process per source, all started together;
  multi_gpu_bands  B1 and B2 on tile-row lists (the multi-device path's
              bands) at 1920x1080 / 100k: equal 2- and 4-band partitions and
              the dual partition of `paired_balance_bounds` on the frame's
              row histogram; each band's binning equals the full binning on
              its tiles, B1's band planes and B2's band pair gradients equal
              the full-frame launch's bit for bit (max abs error 0), with
              each band launch's CUDA-event time beside the full launch's;
  parity      `render()` with backend "cuda" (kernel B1) against backend
              "torch" (its plain-PyTorch twin), and B1's other output rows
              against the twin's on the same pair lists, at 640x360 / 20k
              gaussians and at 1920x1080 / 100k; B1's rows at the default
              median slots and at slots=0 (every search re-walks the list);
  parity_bwd  kernel B2 against its twin `render_ref.blend_bwd_planes` on the
              same B1 planes and seeded cotangent, per pair and per gaussian,
              at both sizes, with and without the median depth, and a second
              B2 launch on the same inputs equal to the first bit for bit;
  slice       the render CLI (`gsjax_torch.render.main`) on a 2-view
              1920x1080 COLMAP scene and a 100k-gaussian PLY made from a
              seed; B1's launches and the preprocess forward's must equal
              the number of views;
  sum_orders  the float32 orders of torch's CUDA sums, norms and scalar
              divisions that `csrc/preprocess_common.cuh` copies, probed
              against each order written out on the host; the line carries
              torch's and CUDA's versions, and another order fails by name;
  parity_preprocess  the preprocess kernel pair (`csrc/preprocess_fwd.cu`,
              `preprocess_bwd.cu`) against its twin `preprocess_ref` (torch
              autograd for the VJP) at both benchmark configurations' shapes
              and options (gsbench/configs: 2^21 rows with SH 3 and no SG,
              2^22 with SH 2 and 7 SG lobes, kernel_size 0, dead rows past
              the alive count; the scene `gsbench/scenes.py` makes from a
              seed, its first two views): the integer fields equal on all
              but PP_INT_ROWS of the rows, the float fields within PP_TOL of
              their largest twin magnitude; the VJP through the autograd
              Function `Preprocess`, as training runs it, on a seeded
              cotangent, on a training loss's through the blend kernels, and
              on a view and an SH-0 neighbour view sharing the leaves as in
              train_step: each leaf's gradient within PP_TOL, the VJP's zeros
              the twin's (the share of each leaf's elements with |g| >
              PP_EPS on one side only at most PP_SUPPORT; with the
              neighbour, no element zero on one side only, and the
              rotation's gradient bit-equal) there and on every case of
              `tests/preprocess_cases.py`; a two-shard split of the rows
              equal to the full launch bit for bit; the kernels' and the
              twin's CUDA-event times beside the byte bound, and the device
              events of each path's forward + VJP;
  parity_sample  kernels B3 / B5 (the point query and its VJP) against their
              twins in `ops/sample_ref.py`, on a reference arc view's
              depth-valid pixels queried in its neighbour, at 640x360 / 20k
              and 1920x1080 / 100k; B3 at the default slots and at slots=0;
  parity_warp kernel B6 (the NCC's neighbour-tap sampler) against its twin
              on the 49 taps of each pixel's homography at 1920x1080;
  parity_ncc_blocks  the block-compacted NCC on the reference view's
              geometric mask (d_mask and weights as the multi-view loss makes
              them): B6 launched as `warp_sample_blocks` on the compacted
              taps [B, 49, 256] against its twin, and `warp_patch_ncc_blocks`
              against the dense `warp_patch_ncc` on the same mask, both on
              the card: the loss sum, the count and the gradients to depth
              and normal; the selected blocks, the frame's and the mask's
              pixel share;
  train       the training CLI (`gsjax_torch.train.main`) for 40 steps on a
              6-view 1920x1080 scene initialised from 100k points, densify
              at 20 and 30, regularisation from 21 with gsjax's default
              multi-view lambdas; B2's launches must equal the steps, B3's,
              B5's and B6's the steps that ran the multi-view losses, the
              preprocess forward's B1's and B3's together, its VJP's B2's
              and B5's;
  train_options  the same CLI run with GSJAX_NCC_COMPACT=1 and GOF's
              appearance model (`--use_decoupled_appearance 2`):
              `warp_sample_blocks` launched once per multi-view step and the
              dense `warp_sample` never, the loss on fixed views (through the
              appearance mapping) falling, and the checkpoint's `x_app/*`
              keys reloading;
  multihost   gsjax's multi-host demo through the port (`python -m
              gsjax_torch.multihost_demo`'s `run`): 4 ranks on 2 simulated
              hosts (LOCAL_RANK / LOCAL_WORLD_SIZE of 2) sharing the card
              over gloo, joined through `maybe_init_distributed`: the
              all-sum of rank + 1 reads 10 on each, two `train_step_sharded`
              steps give bit-equal finite losses, only rank 0 writes; B1 and
              B2 launched on the ranks (on the host clock, beside the golden
              child);
  timing      CUDA-event times of preprocess, binning, B1 and a whole
              `render()` at 1920x1080 / 100k, with B1's bound;
  search      how the median search of B1 (1920x1080 / 100k) and of B3 (the
              multi-view query) went, from the kernels' counters: threads on
              the slot path and on the re-walk, Newton evaluations, varying
              pairs per thread (p50, p99, max, at the 6-sigma fold and at 14.5
              sigma), the folded share of applied pairs, and the kernel's time
              at the default slots beside slots=0; a second B1 line on the
              same scene 60 times as far (z ~ 300, `far_scene`), whose mean
              Newton evaluations must stay within 0.5 of the near scene's;
  bwd_profile where the warp cycles of B2 (1920x1080 / 100k, with and
              without depth) and of B5 (the multi-view query) go, from the
              kernels' profile counters: warp-pairs walked, the share with an
              applying lane, applying lanes and interactions per such
              warp-pair, and the cycle shares of the setup, the staging and
              barriers, the alpha test, the applied math and the reduction;
              the kernel's time with and without the counters;
  timing_train  B2 with and without depth and its bound, bench.py's
              fwd+bwd loss as rays/s, a train step with regularisation on and
              off with its stage split and peak memory, a profiler reading of
              the device's busy share, and a reg-on step with each appearance
              model (gs, pgsr, gof);
  timing_mv   B3, B5, B6 and B6 on compacted blocks against their bounds (B6
              also against `grid_sample`), `sample_depth`, `warp_patch_ncc`
              and `warp_patch_ncc_blocks` forward + backward with their peak
              memory, and a train step with the multi-view losses, dense and
              block-compacted, its peak memory and idle share, at 1920x1080 /
              100k;
  parity_integrate  kernel B4 (the point integrate, `integrate_fwd.cu`)
              against its twin `sample_ref.integrate_rows` on the tetra
              points of a sphere model (`sphere_gaussians`) in a ring view,
              in the integrate's pixel order, at 640x360 / 20k gaussians
              (0.30 M points) and 1920x1080 / 100k (1.5 M points);
  timing_mesh B4 against its bound and its twin at 1920x1080 / 100k, its
              block count and fill, with B3 on the same points beside it;
  integrate_profile  where B4's warp cycles go on that query, from the
              kernel's profile counters: blocks and fill, the warps' pair
              lists, warp-pairs walked and the shares with a lane past the
              cut-off, an applying lane or a near factor, lane-pairs after
              the lane's own stop, applied pairs by band (6 sigmas in front
              of the point, behind it, near, steps) and the cycle split, with
              B4's time and warp-pairs on the points in tile order beside;
  mesh        both meshing CLIs (`gsjax_torch.mesh_extract_tetrahedra`,
              `gsjax_torch.mesh_extract`) on an 8-view 1920x1080 ring scene of
              a 20k-gaussian sphere PLY: B4's launches must equal
              views x (1 + 10 binary-search steps) x chunks, B1's the views of
              the TSDF route, and both `recon_post.ply` lie on the unit
              sphere; the stage split and peak memory of each route, and B4's
              summed device time (CUDA events around each call);
  evaluate    gsjax's evaluation path through the port's CLIs on an 800x800
              NeRF-synthetic scene of the blobs foreground (24 train and 4
              test views, `write_rendered_blender`): the train CLI (`--eval
              -w`, 40 steps from the reader's 100k random points, B2 on every
              step, B3 / B5 / B6 on the multi-view ones, the loss on fixed
              views lower after than before); the render CLI on
              the ground-truth model with an 8-frame flythrough, depth and
              `--video` (or the error naming cv2 where it does not import),
              B1 once per view; the metric CLI (test PSNR, LPIPS null with
              its status) and the port's LPIPS with random weights on the
              card against the CPU; the TSDF mesh CLI (B1 per train view) and
              the mesh's distance to the two spheres; the DTU CLI on
              synthetic calibration, ObsMask, Plane and STL files under a
              known similarity (the scale it recovers, `overall`, the
              downsample's size and seconds); the TnT CLI's F1 on synthetic
              files (without matplotlib it writes results.json and no
              figure); the seconds of each stage on the host clock.
  viewer      the live viewers on the `train` scene (6 views at 1920x1080,
              100k points): the train CLI with `--ip --port` for 5 steps,
              whose Python client requests 5 paused frames of view 0's
              camera before step 1 and one that releases the run (each
              equal bit for bit to `render()` with backend "cuda" of the
              starting model, whose colour holds to the twin's within the
              parity tolerances; the verify string the scene path; B1
              launched once per step render and per frame); `python -m
              gsjax_torch.viewer.client` (sibr_client built with g++) writing
              4 orbit PPMs at 1920x1080, and the web viewer's bridge
              (`SIBRBridge`) getting one frame, each from `serve_viewer` on a
              trainer of the same scene with a step after each frame, as the
              CLI's loop; the web viewer's local mode on a 100k-gaussian PLY:
              10 POSTs at 1920x1088 (B1 once each, the bytes of one equal to
              `render()`'s), latency median / p90 on the host clock beside
              `render()`'s CUDA-event time;
  multi_gpu   two ranks sharing the card over gloo: two processes of
              `chip_smoke.py --train-rank`, each the train CLI's `main` with
              `--dist_coordinator/--dist_num_processes/--dist_process_id`,
              train 5 steps from the `train` phase's step-40 checkpoint (the
              multi-view terms on, one densify at step 44, equal then
              histogram-balanced bands; started after the `train` phase,
              they run beside the `mesh` and `slice` phases, as do two more
              single-process runs), against the single-process CLI
              from the same checkpoint, held to dryrun_multichip's bounds
              after the first step: the loss within 5e-3 relative, the
              densification statistics within 1e-2, |dxyz| q90 < 5e-4 and
              max < 2e-2; after the later steps (two runs of one program
              drift apart through float atomics) to the larger of those
              bounds and 3x the single runs' spread: the loss at every
              step, xyz and the statistics (relative L2) at step 43; the
              alive counts after the densify within 1e-3; the ranks' states
              bit-equal,
              only rank 0's model directory written, B1 / B2 / B3 / B5 / B6
              launched on the ranks; the step time on the host clock beside
              the single process's (a parity run: one card, gloo through the
              host); then in the same group every collective the port uses,
              on CUDA tensors (`probe`), and `render_sharded` (equal and dual
              bands) and `render_views_sharded` (3 views) bit-equal to
              `render()` (`serve`);
  diagnostics the train CLI with GSJAX_NAN_PROBE=1 from a checkpoint of the
              same scene where one gaussian's DC colour is NaN: the probe's
              dump (gsjax's keys) and NAN_PROBE line, then the snapshot and
              the FloatingPointError naming it; `python -m
              gsjax_torch.nan_hunt --no_debug_nans` on the dump (the same
              non-finite fields as the probe), and its anomaly-mode replay
              naming the backward op; the step time with the probe off and
              on in 10 turns (median), and the probe's own work (the state
              copy and the 18 counts) by CUDA events; the CLI from a checkpoint at step 195
              to 200 with `--profile_iter 196` (five step spans, B1 and B2
              kernel events in the trace), `--debug` (regularisation on at
              200: the 2W x 2H mosaic) and TensorBoard (gsjax's scalar tags,
              or no event file where `torch.utils.tensorboard` does not
              import).
  golden      recipe A of gsjax's `scripts/quality_r04.py` through the
              port's golden CLI (`python -m gsjax_torch.golden_quality`):
              the sphere scene, 28 views at 320x240, 2000 gaussians, 3000
              steps with densification to 2250, opacity resets at 900 and
              1800, the SH degree rising at 1000-3000, the multi-view terms
              from 1500, then both meshes; a child process
              (`chip_smoke.py --golden OUT ARGV`) started after
              `multi_gpu` runs it beside the phases from `train_options` to
              `diagnostics` and is joined before `timing`. It must meet
              gsjax's tetra chamfer gate (<= 0.0625) with a finite test PSNR
              and TSDF chamfer; on the scored model the TSDF route (median-
              depth renders, fusion, the chamfer) is run again with B1 on
              the 24 training views (the scored chamfer again) and on every
              second view with B1 and with its plain version (B1's median
              depth within the `parity` bounds, the two chamfers within
              2e-4); B2 launched once a
              step that trained, B6 once a multi-view step and B3 / B5 once
              one with a point query (none right after an opacity reset),
              each counting the device-step timing's own; B4 views x (1 + 8
              binary-search steps) x chunks; `warp_sample_blocks` never. The
              child seeds Python's `random` with 0 and runs the port's
              default NCC. The PSNR gate (>= 34.0 dB) and the TSDF gate
              (<= 0.025) are reported and not held: the port misses the
              first on every draw of A (30.8-31.7 dB; gsjax's TPU record
              36.75) and the second on some (0.0233-0.0241, once 0.03206;
              gsjax 0.0184), misses recorded in ROADMAP queue C. The line gives the
              scores, the launches by stage, the overflow retries, the
              neighbour lists clamped at `max_per_tile`
              (`mv_steps_near_list_clamped`), `loop_mean_ms`,
              `step_ms_device`, the run's own wall clock and the seconds of
              its stages.
  bench       the three benchmark entries as subprocesses, as a user runs
              them, after `timing_train` and beside nothing:
              `python3 bench_torch.py` three times (each value, median and
              spread; the warm-up loss within 1e-5 of `timing_train`'s bench
              step on the same draws, the rays/s within a factor of 2 of
              that step's); `python3 bench_reg_torch.py` three times and once with
              GSJAX_NCC_COMPACT=1 (`mv_queries`, `mv_blocks`, ncc, geo; each
              run's first step equal to the phase's own), with the first
              step held against the same step on the plain versions on the
              card (loss, ncc, geo within 1e-3, `mv_queries` within 1e-4 of
              the frame); `GSJAX_SCALING_DEVICES=2 python3
              bench_scaling_torch.py` in modes `train` and `views` (two ranks
              sharing the card over gloo: efficiency null, the metric
              `*_correctness_2dev`, each row's `iter_s`; the
              SCALING_torch*.json it writes removed). Each entry must end in
              its JSON line with a positive value and no `error`; the
              kernels' launches come from the children's diagnostics lines.
  profile     the profiling and scaling chain in this process, after `bench`
              and beside nothing: `profile_stages --fast` (3 iterations at
              bench.py's workload: each stage alone, gsjax's stats),
              `measure_trepl`, `scaling_model` on that profile and t_repl,
              `profile_sample` and `profile_reg` (2 iterations on the 2.07
              M-point query) and `trace_reg` (2 reg steps under
              torch.profiler: top kernels, idle share); the stats equal to
              the phase's own binning's, the full step's loss to
              `timing_train`'s within 1e-5, the model's n = 1 row to the full
              step, B3 / B5 / B6 among the traced kernels.
Then the `kernels` line (nine entries: B6 appears twice, as `warp_sample`
on the dense NCC and as `warp_sample_blocks` on the compacted one, and the
preprocess pair with its times by configuration; the others each with
its launches by path: render, train, train_compact, mesh, evaluate, viewer,
diagnostics, multi_gpu (summed over the two ranks), golden, bench (summed
over every entry run), profile, multihost (summed over the four ranks); B1
and B2 also carry `band_ms`, their band launches' times by partition), the
nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints no
result. Run from the repository root; scenes are written under
`build/chip_smoke/` and removed at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import shutil
import subprocess
import sys
import time
from argparse import Namespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# fp32 operations the blend of a frame needs, per (pair, pixel) interaction,
# counted from csrc/blend_fwd.cu (every arithmetic op, compare, select and
# transcendental counts one). Work is charged once where the function needs
# it once, whatever the kernel recomputes: alpha in the blend only, the
# ray-depth plane and log1p(-alpha) once per applied pair of a pixel whose
# median is searched, then each evaluation of the median model only its
# per-depth terms. The evaluations charged are those of the TPU kernel's
# search (two bracket ends, 7 Newton steps and the final one,
# render_pallas.py:_median_search), not this kernel's 12 Newton steps.
# Transcendentals are held to the fp32 rate like the rest, not to the
# slower special-function rate, so the bound is low on that count.
OPS_ALPHA = 16        # pair_alpha(): every marched pair
OPS_APPLY = 16        # an applied pair: weight, 3 colour + 3 normal FMAs, T update, stop test
OPS_PAIR_MEDIAN = 6   # t_peak (ray-depth plane) and log1p(-alpha)
OPS_DEPTH = 14        # the model's term at one depth
OPS_DERIV = 8         # its d/dt
MEDIAN_BRACKET = 2
MEDIAN_NEWTON = 8

# kernel vs twin tolerances: the render parity bounds gsjax holds its Pallas
# blend to against its XLA path (tests/test_pallas.py:38-44). The twin sums in
# log space over 64-pair chunks and bisects the median (8-way x 5); the kernel
# multiplies T pair by pair and finds the median by safeguarded Newton
# (blend_fwd.cu); both converge to the same root of T(t) = 0.5. The colour,
# alpha and normal bounds hold on >= 99.99% of pixels, as n_contrib's: where
# float rounding flips a discrete test between the two evaluation orders
# (alpha >= 1/255, or the stop T(1 - alpha) < 1e-4) the pixel differs by that
# one pair's weight; the largest such flip read on the card at 1080p / 100k
# was 6.3e-5, so every pixel is held within 1e-3. The median depth is held
# on >= 99.99% of pixels and every pixel within 5e-3 (largest read 1.1e-3).
# dlogT/dt at the root (row 12, what the backward reads) is evaluated at each
# side's own root, so it differs where the roots do: held within 1% / 1e-3
# on >= 99.9% of the pixels in range on both sides (read: 99.98%).
FLIP_FRAC = 0.9999
TOL_FLIP = 1e-3
TOL_COLOR = 3e-5
TOL_NORMAL = 2e-4
MD_ATOL, MD_RTOL, MD_FRAC, MD_MAX = 2e-3, 1e-3, 0.9999, 5e-3
NCONTRIB_FRAC = 0.9999
DD_RTOL, DD_ATOL, DD_FRAC = 1e-2, 1e-3, 0.999

# B2 against its twin on the same B1 planes and cotangent. Errors are taken
# per payload column, relative to the column's largest |twin| entry (the
# columns differ by orders of magnitude). The kernel sums each pair's
# per-pixel terms in registers, warp shuffles and shared memory in a fixed
# order (the same bits from run to run) and carries T multiplicatively; the
# twin sums in log space and in another order: BWD_TOL / BWD_FRAC bound the
# rounding. A pair whose alpha test or stop flips between the two
# evaluation orders moves its pixel's terms as a whole: BWD_MAX bounds every
# entry, GAUSS_* the per-gaussian sums after the scatter. Read on the card
# (H100, 640x360 / 20k and 1080p / 100k, with and without depth): every
# pair within 5.1e-5 (1.2e-5 with depth) and every gaussian within 2.2e-5,
# the largest a mean2d column without depth, where a pair's blend term
# cancels against T q; no flip seen. Limits: 1e-4 on >= 99.99% of pairs and
# gaussians, every one within 1e-3.
BWD_TOL, BWD_FRAC, BWD_MAX = 1e-4, 0.9999, 1e-3
GAUSS_TOL, GAUSS_FRAC, GAUSS_MAX = 1e-4, 0.9999, 1e-3

# The preprocess kernel pair (csrc/preprocess_fwd.cu, preprocess_bwd.cu)
# against its twin `preprocess_ref` (torch autograd for the VJP) on the card,
# at the benchmark configurations' shapes (gsbench/configs: 2^21 rows with
# SH 3, 2^22 with SH 2 and 7 SG lobes, kernel_size 0, dead rows past the
# alive count). The kernels repeat the twin's float32 ops in PyTorch's CUDA
# order (csrc/preprocess_common.cuh), so the integer fields may differ on
# PP_INT_ROWS of the rows at most (an ulp tie), and the float fields and each
# leaf's gradient sit within PP_TOL of their largest finite twin magnitude
# (the twin's SG lobes and its autograd sums round in other orders). The
# VJP's zeros are the twin's: on every leaf, the share of elements with
# |g| > PP_EPS on exactly one side is at most PP_SUPPORT (Adam's first update
# moves each such element by a whole learning rate).
PP_INT_ROWS = 1e-6
PP_TOL = 1e-5
PP_SUPPORT, PP_EPS = 1e-5, 1e-13
PP_SEED = 20261018

# fp32 operations B2 needs, per (pair, pixel) interaction, counted from
# csrc/blend_bwd.cu as OPS_* above: the alpha test for every pair before
# the pixel's n_contrib; for an applied pair the blend and chain terms (q,
# w, the running sum, dL/dalpha, the chain to power/opacity and the 16
# payload columns) and one add per column for the sum over pixels; for an
# applied pair of an in-range pixel the median term; and a per-pixel setup.
OPS_BWD_APPLY = 65
OPS_BWD_MEDIAN = 38
OPS_BWD_PIXEL = 40

# B3 / B5 against their twins on the same pair lists and points. B3 is held to
# B1's limits (MD_*, NCONTRIB_FRAC, DD_*): it marches and searches the median
# as B1 does, at continuous coordinates. B5 is held per pair and column and
# per gaussian to B2's limits (BWD_*, GAUSS_*), and its per-point d(px), d(py)
# to the same, relative to each column's largest |twin| entry: both read the
# same B3 rows and sum in other orders. Read on the card (H100, 640x360 / 20k
# and 1080p / 100k, 0.20 M and 1.59 M queries): m_t within 1.25e-3 on every
# point in range on both sides, in_range equal on all, n_contrib on
# 99.9996%, dlogT/dt close on 99.97%; B5 every pair within 3.2e-6, every
# gaussian within 1.9e-6 and every point within 1.2e-7 of scale.
PT_TOL, PT_FRAC, PT_MAX = BWD_TOL, BWD_FRAC, BWD_MAX
# B6 against its twin: the same fp32 formula (nvcc may contract a product and a
# sum into one fma), so every sample, d/du and d/dv within 1e-5 absolute
# (read: 1.2e-7, 9.3e-10 and 9.3e-10 on 101.6 M taps at 1080p).
WARP_MAX = 1e-5
# The block-compacted NCC against the dense one on the card, on the same mask
# and with the same kernel: the loss sum within rtol NCC_RTOL, the count
# equal, the gradients to depth and normal within NCC_GRAD of each one's
# largest entry (the CPU twins read them equal, tests/test_torch_ncc_blocks.py).
NCC_RTOL, NCC_GRAD = 1e-5, 1e-4

# fp32 operations, counted from csrc/sample_fwd.cu and sample_bwd.cu as
# OPS_* above: B3 charges OPS_ALPHA per marched (pair, point), OPS_POINT_APPLY
# per applied one (T update, stop test, md_init), and the median search as
# B1's; B5 charges OPS_ALPHA per pair before n_contrib of a point with a
# non-zero cotangent, OPS_SBWD_APPLY per applied one (the median term, the
# chain to 10 columns and one add per column for the sum over points) and
# OPS_SBWD_POINT per point. B6: OPS_WARP per (tap, pixel).
OPS_POINT_APPLY = 8
OPS_SBWD_APPLY = 75
OPS_SBWD_POINT = 10
OPS_WARP = 30
# B4 (csrc/integrate_fwd.cu) is charged what its function needs on these
# inputs (`integrate_needs`): OPS_ALPHA only for the (pair, point) tests
# whose cut-off ellipse reaches the point within its march (its applied
# pairs and the pair that stops it); OPS_REACH per (warp of 32 sorted points,
# pair up to the warp's longest march) for finding those pairs (the exact
# least of the conic over the warp's box, `reaches`); OPS_POINT_APPLY +
# OPS_BAND per applied pair (its ray-depth plane, delta and the band test);
# OPS_DEPTH per applied pair within 6 sigmas of the point, the only ones
# whose factor needs the half-CDF term (farther ones give exactly 1 - alpha
# or 1).
OPS_REACH = 60
OPS_BAND = 6


# B4 against its twin on the same view payload and points. gsjax holds its two
# integrate paths to 5e-4 in alpha (tests/test_sample_ncc.py:157-162); the
# kernel carries T multiplicatively pair by pair, the twin sums log(1 - alpha)
# in 256-pair chunks, and both sum the same half-gaussian-CDF log factors.
# T(point) is held within INT_TOL on >= INT_FRAC of the points and within
# gsjax's 5e-4 on >= FLIP_FRAC. A point whose alpha test (alpha >= 1/255) or
# stop (T(1 - alpha) < 1e-4) flips between the two evaluation orders moves by
# that one pair's factor, at most its alpha (~1/255 at the test's edge):
# every point is held within INT_MAX. Read on the card (H100, 0.29 M points at
# 640x360 / 20k and 1.43 M at 1080p / 100k): every point within 4.5e-4 and
# 3.9e-4, within 1e-4 on 99.9996% and 99.99993%, n_contrib equal on 100% and
# 99.9995%.
INT_TOL, INT_FRAC, INT_GSJAX, INT_MAX = 1e-4, 0.9999, 5e-4, 5e-3
# The meshes of a 20k-gaussian sphere (1-sigma tangent radius 0.023) lie on
# the unit sphere: median | |v| - 1 | of each recon_post.ply below MESH_RADIUS
# (read 0.0058 for the tetra route and 0.0061 for the TSDF route: the tangent
# discs sag outside the sphere away from their centres).
MESH_RADIUS = 0.01
MESH_CHUNK = 1 << 20      # points per integrate call (evaluate_alpha_cull)
MESH_STEPS = 10           # binary-search steps of the tetra route
# The far scene of the second B1 `search` line: bench.py's scene this many
# times as far from the camera (z ~ 300), where a float32 ulp of the ray
# distance exceeds the Newton exit's absolute tolerance (median.cuh).
FAR = 60.0
FAR_ITERS = 0.5           # |mean evaluations far - near| (read 0.38; CPU emulation 0.29)
# The `evaluate` phase: an 800x800 NeRF-synthetic scene (NeRF-synthetic's
# frame size; its 100 train and 200 test views cut to EVAL_TRAIN and
# EVAL_TEST, interleaved) rendered from the foreground of
# blobs_gaussians(EVAL_GAUSSIANS) (45k gaussians with |mean| <= 2.5) on
# gsjax's golden blobs ring, at fovx EVAL_FOVX. The train CLI runs EVAL_STEPS
# steps from the reader's own 100k random points, multi-view from step 21,
# and no densification: with -w gsjax resets every opacity to at most 0.01
# at densify_from_iter, and its prune at 0.05 removes every gaussian at the
# next densification unless ~35 steps lie between (read on the card: a
# 40-step run densifying at 10 and 20 launched B2 on 20 steps and B3 / B5
# never); the `train` phase densifies. The render CLI adds an
# EVAL_TRAJ-frame flythrough. Readings below: H100, 60k blobs gaussians.
EVAL_SIZE = 800
EVAL_TRAIN, EVAL_TEST, EVAL_TRAJ = 24, 4, 8
EVAL_GAUSSIANS = 60_000
EVAL_FOVX = 0.8
EVAL_STEPS = 40
EVAL_INIT_POINTS = 100_000      # the reader's default random initialisation
EVAL_RING = dict(radius=4.2, height_amp=1.1, target=(0.7, 0.1, 0.25))
# The ground-truth model renders its own test views back: the test PSNR is
# above EVAL_PSNR (read 56.26 dB; the 8-bit PNGs and the alpha composite
# bound it).
EVAL_PSNR = 50.0
# The port's LPIPS on one 800x800 pair (two test views) with seeded random
# VGG16 weights, on the card against the CPU, TF32 off: within EVAL_LPIPS_RTOL
# (read: equal).
EVAL_LPIPS_RTOL = 1e-4
# The TSDF mesh of the ground-truth model (voxel EVAL_VOXEL, the two largest
# clusters kept): the median distance of recon_post.ply's vertices to the two
# foreground spheres below EVAL_MESH_DIST (read 0.0047, 0.0047 at voxel
# 0.005: the tangent discs' sag, not the grid, sets it; 0.0091 from 20k
# gaussians).
EVAL_VOXEL = 0.01
EVAL_MESH_DIST = 0.008
# Synthetic DTU files: the blobs surface (EVAL_SAMPLES samples) under a
# similarity of scale EVAL_DTU_SCALE, chosen so the protocol's 0.2 mm
# density keeps ~1e5 points of the mesh (read: 100,493 of 891,245); the
# CLI's alignment recovers the scale within EVAL_SCALE_RTOL (read 2.2e-8).
EVAL_SAMPLES = 200_000
EVAL_DTU_SCALE = 20.0
EVAL_SCALE_RTOL = 1e-4
# Synthetic TnT files of the same samples (tau 0.01, the default of a scene
# not in SCENES_TAU): F1 at tau above EVAL_F1 (percent; read 94.5, precision
# 90.6, recall 98.9).
EVAL_F1 = 85.0

# The viewer phase at 1920x1080 / 100k: the train CLI's SIBR server runs
# VIEWER_STEPS steps (at the reader's 1600x900: resolution -1 scales a wider
# image to 1600, as gsjax's); its Python client requests VIEWER_PAUSED
# paused VIEW_W x VIEW_H frames through train view 0's pose and fov before
# step 1, then one that releases the run.
# The native client writes NATIVE_FRAMES orbit PPMs; the web viewer's local
# mode answers WEB_FRAMES POSTs at WEB_W x WEB_H (gsjax's snap floors to 32
# pixels, so 1080 would give 1056) after two of warm-up.
VIEWER_STEPS = 5
VIEWER_PAUSED = 5
VIEW_W, VIEW_H = 1920, 1080
NATIVE_FRAMES = 4
WEB_FRAMES = 10
WEB_W, WEB_H = 1920, 1088
# The diagnostics phase: the step time with the NaN probe on and off in
# PROBE_TURNS turns each; gsjax's TensorBoard scalar tags (loop.py:781-798).
PROBE_TURNS = 10
TB_TAGS = ("train_loss_patches/total_loss", "train_loss_patches/l1_loss",
           "train_loss_patches/normal_loss", "train_loss_patches/ncc_loss",
           "train_loss_patches/geo_loss", "total_points", "iter_time", "test/psnr")


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the script's wall clock so far."""
    if "phase" in obj:
        obj = dict(obj, wall_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bench_inputs(width, height, n):
    """bench.py's draws (`gsjax_torch.bench.bench_inputs`): means, scales,
    quats, opacity, SH, then the target image."""
    from gsjax_torch import bench

    return bench.bench_inputs(width, height, n)


def bench_params(g, device):
    """bench.py's gaussians as the port's model (raw parameters, all alive)."""
    from gsjax_torch.model.gaussians import params_from_numpy

    means, scales, quats, opac, shs = g
    n = len(means)
    params = dict(xyz=means, features_dc=shs[:, :1], features_rest=shs[:, 1:],
                  opacity=np.log(opac / (1 - opac)), scaling=np.log(scales),
                  rotation=quats, sg_axis=np.zeros((n, 1, 3), np.float32),
                  sg_sharpness=np.zeros((n, 1), np.float32),
                  sg_color=np.zeros((n, 1, 3), np.float32))
    aux = dict(alive=np.ones(n, bool), filter_3d=np.zeros(n, np.float32),
               grad_accum=np.zeros(n), grad_accum_abs=np.zeros(n),
               denom=np.zeros(n), max_radii=np.zeros(n, np.int32))
    return params_from_numpy(params, aux, device)


def bench_camera(width, height, device):
    from gsjax_torch.ops.raster import Camera

    return Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                         1.0, 0.66, width, height, device=device)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def event_ms(fn, reps=10, warm=2):
    """Average CUDA-event time of `fn` over `reps` calls, after `warm`."""
    import torch

    for _ in range(warm):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def stages(scene, cam, cfg, dev):
    """preprocess -> binning -> pair payload, as `render()` runs them."""
    import torch

    from gsjax_torch.ops.raster import render_ref
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.ops.raster.preprocess import preprocess

    args = [torch.as_tensor(a, device=dev) for a in scene]
    prep = preprocess(*args, None, None, None, cam, cfg)
    binning = bin_gaussians(prep, cfg, cam.width, cam.height)
    feats = render_ref.prepare_pairs(prep, binning)
    return args, prep, binning, feats


def compare(ko, to, kp, tp):
    """Kernel vs twin: `render()` dicts ko / to for what a caller sees, blend
    planes kp / tp [16, H, W] for the rows a backward reads -> error summary."""
    import torch

    def err(key):
        d = (ko[key] - to[key]).abs()
        return d.amax(-1) if d.dim() == 3 else d

    def close_frac(key, tol):
        return float((err(key) <= tol).float().mean())

    md_close = torch.isclose(ko["median_depth"], to["median_depth"], atol=MD_ATOL, rtol=MD_RTOL)
    mi_close = torch.isclose(kp[9], tp[9], atol=MD_ATOL, rtol=MD_RTOL)
    both = (kp[11] > 0) & (tp[11] > 0)
    dd_close = torch.isclose(kp[12][both], tp[12][both], rtol=DD_RTOL, atol=DD_ATOL)
    return {
        "color_max_abs_err": float(err("render").max()),
        "color_close_frac": close_frac("render", TOL_COLOR),
        "alpha_max_abs_err": float(err("alpha").max()),
        "alpha_close_frac": close_frac("alpha", TOL_COLOR),
        "normal_max_abs_err": float(err("normal").max()),
        "normal_close_frac": close_frac("normal", TOL_NORMAL),
        "median_depth_close_frac": float(md_close.float().mean()),
        "median_depth_max_abs_err": float(err("median_depth").max()),
        "n_contrib_equal_frac": float((ko["n_contrib"] == to["n_contrib"]).float().mean()),
        "t_final_max_abs_err": float((kp[10] - tp[10]).abs().max()),
        "md_init_close_frac": float(mi_close.float().mean()),
        "in_range_equal_frac": float((kp[11] == tp[11]).float().mean()),
        "in_range_frac": float((kp[11] > 0).float().mean()),
        "dlogT_dt_close_frac": float(dd_close.float().mean()) if both.any() else 1.0,
    }


def plane_images(planes):
    """[16, H, W] blend planes -> the keys of a `render()` dict that
    `compare` reads."""
    from gsjax_torch.ops.raster import render_ref

    img = render_ref.planes_to_images(planes)
    return {"render": img["color"], "alpha": img["alpha"], "normal": img["normal"],
            "median_depth": img["median_depth"], "n_contrib": img["n_contrib"]}


def phase_build():
    from gsjax_torch import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    # per source: each kernel instance's registers, spills and shared memory
    ptxas = {src: [ln.strip()[:120] for ln in log.splitlines()
                   if "entry function" in ln or "registers" in ln or "spill" in ln]
             for src, log in logs.items()}
    emit({"phase": "build", "seconds": secs, "built": sorted(logs), "ptxas": ptxas})


def phase_parity(width, height, n, dev):
    """`render()` with backend "cuda" against backend "torch" on the card,
    and the kernel's wrapper against the twin on the same pair lists for the
    rows `render()` does not return; returns (errors, twin_ms)."""
    import torch

    from gsjax_torch.ops.raster import RasterConfig, render, render_cuda, render_ref

    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cam = bench_camera(width, height, dev)
    args, _, binning, feats = stages(bench_inputs(width, height, n)[:5], cam, cfg, dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    ko, to = (render(*args, cam, dataclasses.replace(cfg, backend=b), bg)
              for b in ("cuda", "torch"))
    blend_args = (feats, binning.tile_start, binning.tile_count, width, height,
                  cam.fx, cam.fy, bg, cfg)
    kp = render_cuda.blend_fwd(*blend_args)
    kp0 = render_cuda.blend_fwd(*blend_args, slots=0)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    tp = render_ref.blend_planes(*blend_args)
    b.record()
    torch.cuda.synchronize()
    twin_ms = a.elapsed_time(b)
    err = compare(ko, to, kp, tp)
    err0 = compare(plane_images(kp0), plane_images(tp), kp0, tp)
    emit({"phase": "parity", "width": width, "height": height, "gaussians": n,
          "pairs": binning.num_live, "max_tile_count": binning.max_tile_count,
          "twin_ms": twin_ms, "slots": render_cuda.SLOTS, **err, "slots0": err0})
    for e, tag, planes in ((err, f"slots={render_cuda.SLOTS}", kp), (err0, "slots=0", kp0)):
        check(torch.isfinite(planes).all(), f"kernel output not finite ({tag})")
        for name in ("color", "alpha", "normal"):
            check(e[f"{name}_close_frac"] >= FLIP_FRAC,
                  f"{name} within tolerance on {e[f'{name}_close_frac']} ({tag})")
            check(e[f"{name}_max_abs_err"] <= TOL_FLIP,
                  f"{name} max error {e[f'{name}_max_abs_err']} ({tag})")
        check(e["median_depth_close_frac"] >= MD_FRAC,
              f"median depth close on {e['median_depth_close_frac']} ({tag})")
        check(e["median_depth_max_abs_err"] <= MD_MAX,
              f"median depth max error {e['median_depth_max_abs_err']} ({tag})")
        check(e["md_init_close_frac"] >= MD_FRAC, f"md_init close on {e['md_init_close_frac']}")
        check(e["in_range_equal_frac"] >= MD_FRAC,
              f"in_range equal on {e['in_range_equal_frac']} ({tag})")
        check(e["n_contrib_equal_frac"] >= NCONTRIB_FRAC,
              f"n_contrib equal on {e['n_contrib_equal_frac']}")
        check(e["dlogT_dt_close_frac"] >= DD_FRAC,
              f"dlogT/dt close on {e['dlogT_dt_close_frac']} ({tag})")
    return err, twin_ms


def bench_cotangent(planes, gt, require_depth):
    """The cotangent of the blend planes under bench.py's loss
    (0.8 L1 + 0.2 (1 - SSIM) + 1e-6 mean median depth, bench.py:82-87)."""
    import torch

    from gsjax_torch.ops.raster import render_ref
    from gsjax_torch.train import losses

    planes = planes.detach().requires_grad_(True)
    img = render_ref.planes_to_images(planes)
    loss = 0.8 * losses.l1_loss(img["color"], gt) + \
        0.2 * (1 - losses.ssim(img["color"], gt))
    if require_depth:
        loss = loss + 1e-6 * img["median_depth"].mean()
    g, = torch.autograd.grad(loss, planes)
    return g.contiguous()


def phase_parity_bwd(width, height, n, dev, require_depth):
    """B2 against its twin on the same B1 planes and a seeded cotangent;
    returns (summary, twin_ms)."""
    import torch

    from gsjax_torch.ops.raster import RasterConfig, render_cuda, render_ref

    cfg = RasterConfig(sh_degree=3, require_depth=require_depth, max_per_tile=1 << 12)
    cam = bench_camera(width, height, dev)
    _, _, binning, feats = stages(bench_inputs(width, height, n)[:5], cam, cfg, dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    lists = (feats, binning.tile_start, binning.tile_count)
    planes = render_cuda.blend_fwd(*lists, width, height, cam.fx, cam.fy, bg, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    grad = torch.zeros_like(planes)
    rows = 8 if require_depth else 7
    grad[:rows] = torch.randn((rows, height, width), generator=gen, device=dev)
    tail = (width, height, cam.fx, cam.fy, bg, cfg)
    d_k = render_cuda.blend_bwd(*lists, planes, grad, *tail)
    repeat_equal = torch.equal(d_k, render_cuda.blend_bwd(*lists, planes, grad, *tail))
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    d_t = render_ref.blend_bwd_planes(*lists, planes, grad, *tail)
    b.record()
    torch.cuda.synchronize()
    twin_ms = a.elapsed_time(b)

    def rel_err(k, t):
        return ((k - t).abs() / t.abs().amax(0).clamp_min(1e-30)).amax(1)

    err = rel_err(d_k, d_t)
    gk = torch.zeros(n, 16, device=dev).index_add_(0, binning.gauss_idx, d_k)
    gt = torch.zeros(n, 16, device=dev).index_add_(0, binning.gauss_idx, d_t)
    gerr = rel_err(gk, gt)
    touched = gt.abs().amax(1) > 0
    col_err = ((d_k - d_t).abs() / d_t.abs().amax(0).clamp_min(1e-30)).amax(0)
    out = {"pairs": binning.num_live, "twin_ms": twin_ms,
           "pair_max_err": float(err.max()),
           "pair_close_frac": float((err <= BWD_TOL).double().mean()),
           "gauss_max_err": float(gerr[touched].max()),
           "gauss_close_frac": float((gerr[touched] <= GAUSS_TOL).double().mean()),
           "col_max_err": [float(x) for x in col_err],
           "finite": bool(torch.isfinite(d_k).all()),
           "repeat_bitwise_equal": repeat_equal,
           "nonzero_cols": int((d_t.abs().amax(0) > 0).sum())}
    emit({"phase": "parity_bwd", "width": width, "height": height, "gaussians": n,
          "require_depth": require_depth, **out})
    check(out["finite"], "B2 output not finite")
    check(repeat_equal, "two B2 launches on the same inputs differ")
    check(out["nonzero_cols"] == (16 if require_depth else 12),
          f"twin gradient has {out['nonzero_cols']} non-zero columns")
    check(out["pair_close_frac"] >= BWD_FRAC, f"B2 pairs close on {out['pair_close_frac']}")
    check(out["pair_max_err"] <= BWD_MAX, f"B2 pair max error {out['pair_max_err']}")
    check(out["gauss_close_frac"] >= GAUSS_FRAC,
          f"B2 gaussians close on {out['gauss_close_frac']}")
    check(out["gauss_max_err"] <= GAUSS_MAX, f"B2 gaussian max error {out['gauss_max_err']}")
    return out, twin_ms


def preprocess_cases():
    """tests/preprocess_cases.py, loaded by its path: an installed package
    named `tests` may shadow the repository's directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "preprocess_cases", os.path.join(ROOT, "tests", "preprocess_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def preprocess_inputs(config, dev):
    """A benchmark configuration's gaussians (gsbench/scenes.py, seeded) as
    the trainer activates them, its first two orbit views and its options ->
    (the eight inputs, camera, the neighbour's camera, RasterConfig, alive)."""
    import torch

    from gsbench import scenes
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.raster import Camera, RasterConfig

    with open(os.path.join(ROOT, "gsbench", "configs", f"{config}.json")) as f:
        spec = json.load(f)
    scene = scenes.make_scene(spec, PP_SEED, dev, targets=False)
    with torch.no_grad():
        params = gm.GaussianParams(**{k: scene.params[k] for k in gm.PARAM_FIELDS})
        scales, opac = gm.scaling_n_opacity_with_3d_filter(
            params, scenes.filter_3d(params.xyz, scene.views))
        inputs = [params.xyz, scales, params.rotation, opac, gm.get_features(params),
                  gm.get_sg_axis(params), gm.get_sg_sharpness(params), params.sg_color]
        inputs = [t.detach().contiguous() for t in inputs]
    cfg = RasterConfig(sh_degree=spec["sh_degree"], sg_degree=spec["sg_degree"],
                       kernel_size=spec["kernel_size"], max_per_tile=1 << 16)
    if cfg.sg_degree == 0:
        inputs[5:] = [None, None, None]
    cam, near = (Camera.create(v.R, v.T, v.fovx, v.fovy, v.width, v.height, device=dev)
                 for v in scene.views[:2])
    return tuple(inputs), cam, near, cfg, scene.alive


def render_cotangent(prep, cam, cfg, seed):
    """The cotangent of the preprocess fields under a training loss (L1 +
    D-SSIM against a seeded frame, the depth-normal term) through binning,
    the pair gather and the blend kernels: exact zeros on rows without a
    pair, as in a step."""
    import torch

    from gsjax_torch.ops.raster import render_cuda, render_ref
    from gsjax_torch.ops.raster import preprocess as pp
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.train import losses

    leaves = {k: getattr(prep, k).detach().requires_grad_(True) for k in pp.GRAD_FIELDS}
    prep_g = dataclasses.replace(prep, **leaves)
    binning = bin_gaussians(prep_g, cfg, cam.width, cam.height)
    feats = render_ref.prepare_pairs(prep_g, binning)
    bg = torch.zeros(3, device=feats.device)
    planes = render_cuda.Blend.apply(feats, binning.tile_start, binning.tile_count, cam.width,
                                     cam.height, cam.fx, cam.fy, bg, cfg, render_cuda.blend_fwd,
                                     render_cuda.blend_bwd)
    img = render_ref.planes_to_images(planes)
    gen = torch.Generator(device=feats.device).manual_seed(seed)
    gt = torch.rand(cam.height, cam.width, 3, generator=gen, device=feats.device)
    dnormal, valid = losses.depth_to_normal(img["median_depth"], cam.fx, cam.fy, cam.cx, cam.cy)
    loss = (0.8 * losses.l1_loss(img["color"], gt) + 0.2 * (1 - losses.ssim(img["color"], gt))
            + 0.05 * losses.depth_normal_loss(img["normal"], dnormal, valid))
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(leaves.values(), got)]


def preprocess_vjp(fn, inputs, views, alive):
    """The gradients of `fn` (`preprocess`, the kernel pair through its
    autograd Function, or the twin `preprocess_ref`) on one set of leaves
    read by each of `views` [(camera, cfg, cotangents, neighbour)] in turn,
    under one `autograd.grad` as in train_step: a neighbour view reads the
    SH-0 colour of `sample.prepare_view` (zeros, no SG), and the engine adds
    its parts before the earlier view's -> a gradient per input."""
    import torch

    from gsjax_torch.ops.raster import preprocess as pp

    leaves = [None if t is None else t.clone().requires_grad_(True) for t in inputs]
    outs, cots = [], []
    for cam, cfg, cot, near in views:
        args = leaves
        if near:
            shs0 = leaves[0].new_zeros(leaves[0].shape[0], 1, 3)
            args = leaves[:4] + [shs0, None, None, None]
        out = fn(*args, cam, cfg, alive)
        outs += [getattr(out, k) for k in pp.GRAD_FIELDS]
        cots += cot
    # the twin's SH-0 colour reads no leaf (its cotangent is zero)
    pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    wrt = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs],
                                   allow_unused=True))
    return [None if t is None else next(got) for t in leaves]


def compare_vjp(kernel, twin, alive):
    """Per leaf: the largest error over the twin's largest |gradient|, the
    share of elements with |g| > PP_EPS on exactly one side, the elements
    exactly zero on one side only and whether all are bit-equal (the twin's
    dead rows zeroed, as the step masks them); the kernel's dead rows must
    be 0."""
    import torch

    from gsjax_torch.ops.raster import preprocess as pp

    out = {}
    for name, k, t in zip(pp.INPUTS, kernel, twin):
        if k is None and t is None:
            continue
        check(k is not None and t is not None, f"{name}: a gradient on one side only")
        m = alive.reshape((-1,) + (1,) * (t.dim() - 1))
        t = torch.where(m, t, torch.zeros_like(t))
        fin = torch.isfinite(t)
        scale = float(t[fin].abs().max()) if fin.any() else 0.0
        out[name] = {
            "rel_err": float((k - t)[fin].abs().max()) / scale if scale else 0.0,
            "support_share": float(((k.abs() > PP_EPS) != (t.abs() > PP_EPS)).float().mean()),
            "zero_elsewhere": int(((k == 0) != (t == 0)).sum()),
            "bit_equal": bool(torch.equal(k, t)),
            "finite": bool(torch.isfinite(k[fin]).all()),
            "dead_rows_zero": bool((k[~alive] == 0).all())}
    return out


def phase_sum_orders(dev):
    """The float32 orders of torch's CUDA ops that the preprocess kernels
    copy (csrc/preprocess_common.cuh: `sum3`, `sum3_mid`, `sum4`, `norm3`,
    `norm4`, `tensor / scalar`, `scalar / tensor`), each probed on seeded
    rows against the order written out on the host. They were read from
    torch 2.11 + CUDA 12.8; a torch or CUDA that adds in another order fails
    here by name, before the parity phases read the differences it makes in
    the bits (and the zeros) of the VJP."""
    import torch

    rng = np.random.default_rng(PP_SEED)

    def rows(*shape):   # contiguous, as the twin's operands; magnitudes 2^-6..2^6
        x = (rng.standard_normal(shape) * np.exp2(rng.integers(-6, 7, shape))).astype(np.float32)
        return x, torch.from_numpy(x).to(dev)

    host = lambda y: y.cpu().numpy()
    x3, t3 = rows(1 << 18, 3)
    x4, t4 = rows(1 << 18, 4)
    xm, tm = rows(1 << 15, 3, 3, 3)
    a, b, c = x3.T
    q0, q1, q2, q3 = x4.T
    s, one = np.float32(1234.5678), np.float32(1)
    got = {
        "sum3": (host(t3.sum(-1)), (a + c) + b),
        "sum3_mid": (host(tm.sum(2)), (xm[:, :, 0] + xm[:, :, 1]) + xm[:, :, 2]),
        "sum4": (host(t4.sum(-1, keepdim=True))[:, 0], (q0 + q2) + (q1 + q3)),
        "norm3": (host(torch.linalg.norm(t3, dim=-1)), np.sqrt((a * a + c * c) + b * b)),
        "norm4": (host(torch.linalg.norm(t4, dim=-1, keepdim=True))[:, 0],
                  np.sqrt((q0 * q0 + q2 * q2) + (q1 * q1 + q3 * q3))),
        "tensor/scalar": (host(t4 / float(s)), x4 * (one / s)),
        "scalar/tensor": (host(float(s) / t4), s * (one / x4)),
    }
    share = {k: float(np.mean(g == w)) for k, (g, w) in got.items()}
    line = {"phase": "sum_orders", "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0), "equal_share": share}
    emit(line)
    off = {k: v for k, v in share.items() if v < 1.0}
    check(not off, f"torch {torch.__version__} + CUDA {torch.version.cuda} rounds {sorted(off)} "
          f"in another order than csrc/preprocess_common.cuh copies (share of rows equal: "
          f"{off}): the preprocess kernels' bits, and the zeros of their VJP, no longer "
          f"follow the twin; write the new orders into the header")
    return line


def phase_parity_preprocess(config, dev):
    """The preprocess kernel pair against its twin at a benchmark
    configuration's shapes: the forward's fields; the VJP through the
    autograd Function `Preprocess`, as training runs it, on a seeded and on a
    training loss's cotangent, on a view and an SH-0 neighbour view that
    share the leaves (as train_step), and on the support cases of
    tests/preprocess_cases.py; a two-shard split of the rows against the full
    launch; the times of both beside their byte bound; returns the line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gsjax_torch.ops.raster import preprocess as pp

    pc = preprocess_cases()
    inputs, cam, near_cam, cfg, alive = preprocess_inputs(config, dev)
    n = inputs[0].shape[0]
    kf = pp.preprocess_fwd(*inputs, cam, cfg, alive)
    tf = pp.preprocess_ref(*inputs, cam, cfg, alive)
    torch.cuda.synchronize()
    fields, int_rows = {}, torch.zeros(n, dtype=torch.bool, device=dev)
    for k in pp.FIELDS:
        a, b = getattr(kf, k), getattr(tf, k)
        if k in pp.INT_FIELDS:
            d = (a != b).reshape(n, -1).any(1)
            int_rows |= d
            fields[k] = {"rows_differ": int(d.sum())}
        else:
            fin = torch.isfinite(b)
            scale = float(b[fin].abs().max())
            fields[k] = {"rel_err": float((a - b)[fin].abs().max()) / scale,
                         "bit_equal_share": float((a == b).float().mean()),
                         "inf_equal": bool(torch.equal(torch.isinf(a), torch.isinf(b)))}
    ties = [{k: getattr(side, k)[i].tolist() for k in ("radius", "rect_min", "rect_wh",
                                                       "mean2d", "conic")}
            for i in torch.nonzero(int_rows).flatten()[:4].tolist() for side in (kf, tf)]

    rng = torch.Generator(device=dev).manual_seed(PP_SEED)
    live = (alive & tf.valid).float()
    live = live * (torch.rand(n, generator=rng, device=dev) > 0.01)
    seeded = []
    for k, w in pp.GRAD_FIELDS.items():
        c = torch.randn(n, w, generator=rng, device=dev) * live[:, None]
        seeded.append(c[:, 0].contiguous() if w == 1 else c)
    del tf
    trained = render_cotangent(kf, cam, cfg, PP_SEED)
    # the neighbour's cotangent as a multi-view query leaves it: no colour
    cfg0 = dataclasses.replace(cfg, sh_degree=0, sg_degree=0)
    near_prep = pp.preprocess_fwd(*inputs[:4], inputs[0].new_zeros(n, 1, 3), None, None,
                                  None, near_cam, cfg0, alive)
    near_cot = render_cotangent(near_prep, near_cam, cfg0, PP_SEED + 1)
    near_cot[list(pp.GRAD_FIELDS).index("color")].zero_()
    del near_prep
    vjp = {}
    for tag, views in (("seeded", [(cam, cfg, seeded, False)]),
                       ("trained", [(cam, cfg, trained, False)]),
                       ("two_views", [(cam, cfg, trained, False),
                                      (near_cam, cfg0, near_cot, True)])):
        k = preprocess_vjp(pp.preprocess, inputs, views, alive)
        t = preprocess_vjp(pp.preprocess_ref, inputs, views, alive)
        vjp[tag] = compare_vjp(k, t, alive)
        del k, t
    case_fail = {}
    for name, case in pc.cases(dev).items():
        c_in, c_cam, c_cfg, c_alive, c_cot = pc.build(case, dev)
        views = [(c_cam, c_cfg, c_cot, False)]
        k = preprocess_vjp(pp.preprocess, c_in, views, c_alive)
        t = preprocess_vjp(pp.preprocess_ref, c_in, views, c_alive)
        c_alive = (torch.ones(len(case.rows), dtype=torch.bool, device=dev)
                   if c_alive is None else c_alive)
        bad = pc.failures(case, k) + [
            f"{leaf}: {v}" for leaf, v in compare_vjp(k, t, c_alive).items()
            if v["zero_elsewhere"] or not v["dead_rows_zero"]]
        if bad:
            case_fail[name] = bad[:4]

    # two shards of the rows against the full launch, bit for bit
    half = n // 2
    parts = [slice(0, half), slice(half, n)]
    part = lambda t, s: None if t is None else t[s]
    shard_equal = True
    full_g = pp.preprocess_bwd(inputs, cam, cfg, alive, trained)
    for s in parts:
        f = pp.preprocess_fwd(*(part(t, s) for t in inputs), cam, cfg, alive[s])
        g = pp.preprocess_bwd([part(t, s) for t in inputs], cam, cfg, alive[s],
                              [c[s] for c in trained])
        shard_equal &= all(torch.equal(getattr(f, k), getattr(kf, k)[s]) for k in pp.FIELDS)
        shard_equal &= all(torch.equal(a, b[s]) for a, b in zip(g, full_g) if a is not None)

    # times at this size, and the launches of each path
    leaves = [None if t is None else t.clone().requires_grad_(True) for t in inputs]
    wrt = [t for t in leaves if t is not None]

    def fwd_bwd(fn):
        out = fn(*leaves, cam, cfg, alive)
        return torch.autograd.grad([getattr(out, k) for k in pp.GRAD_FIELDS], wrt, trained,
                                   allow_unused=True)

    ms = {"kernel_fwd": event_ms(lambda: pp.preprocess_fwd(*inputs, cam, cfg, alive)),
          "kernel_bwd": event_ms(lambda: pp.preprocess_bwd(inputs, cam, cfg, alive, trained)),
          "kernel_fwd_bwd": event_ms(lambda: fwd_bwd(pp.preprocess)),
          "twin_fwd": event_ms(lambda: pp.preprocess_ref(*inputs, cam, cfg, alive), reps=3),
          "twin_fwd_bwd": event_ms(lambda: fwd_bwd(pp.preprocess_ref), reps=3)}
    launches = {}
    for tag, fn in (("kernel", pp.preprocess), ("twin", pp.preprocess_ref)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fwd_bwd(fn)
            torch.cuda.synchronize()
        launches[tag] = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    bands = inputs[4].shape[1]
    lobes = cfg.sg_degree and inputs[5].shape[1]
    in_b = 4 * (3 + 3 + 4 + 1) + 1 + 12 * bands + 28 * lobes
    fwd_b, bwd_b = n * (in_b + 93), n * (in_b + 68 + in_b - 1)
    bound = {"fwd_ms": fwd_b / PEAK_BYTES_S * 1e3, "bwd_ms": bwd_b / PEAK_BYTES_S * 1e3,
             "fwd_bytes": fwd_b, "bwd_bytes": bwd_b}
    line = {"phase": "parity_preprocess", "config": config, "rows": n,
            "alive": int(alive.sum()), "valid": int(kf.valid.sum()),
            "sh_degree": cfg.sh_degree, "sg_degree": cfg.sg_degree, "fields": fields,
            "int_rows_differ": int(int_rows.sum()), "int_ties": ties, "vjp": vjp,
            "support_cases": len(pc.cases(dev)), "support_case_failures": case_fail,
            "shards_bit_equal": bool(shard_equal), "ms": ms, "bound": bound,
            "device_events_fwd_bwd": launches}
    emit(line)
    check(int(int_rows.sum()) <= PP_INT_ROWS * n, f"{config}: integer fields differ on "
          f"{int(int_rows.sum())} rows: {ties}")
    for k, v in fields.items():
        if "rel_err" in v:
            check(v["rel_err"] <= PP_TOL and v["inf_equal"], f"{config}: field {k}: {v}")
    for tag, per in vjp.items():
        for leaf, v in per.items():
            check(v["rel_err"] <= PP_TOL, f"{config} {tag}: gradient of {leaf}: {v}")
            check(v["support_share"] <= PP_SUPPORT, f"{config} {tag}: support of {leaf}: {v}")
            check(v["finite"] and v["dead_rows_zero"], f"{config} {tag}: {leaf}: {v}")
    # as train_step reads the leaves: the twin's zeros on every leaf, and its
    # bits on the rotation, whose gradient along the in-plane turn is round-off
    for leaf, v in vjp["two_views"].items():
        check(v["zero_elsewhere"] == 0, f"{config} two views: zeros of {leaf}: {v}")
    check(vjp["two_views"]["rotations"]["bit_equal"],
          f"{config} two views: the rotation's gradient is not the twin's bits: "
          f"{vjp['two_views']['rotations']}")
    check(not case_fail, f"{config}: support cases: {case_fail}")
    check(shard_equal, f"{config}: two shards differ from the full launch")
    return line


def bench_pose(i, n):
    """arc_pose around bench.py's scene centre (0, 0, 5)."""
    from gsjax_torch.data.synth import arc_pose

    r_w2c, tvec = arc_pose(i, n, radius=5.0)
    return r_w2c, tvec - r_w2c @ np.array([0.0, 0.0, 5.0])


def phase_slice(dev, n_views=2, width=1920, height=1080, n=100_000):
    """The render CLI on a seeded scene; returns {kernel: launches}."""
    import torch

    from gsjax_torch import render as render_cli
    from gsjax_torch.config import dump_cfg_args
    from gsjax_torch.data.synth import write_rendered_colmap
    from gsjax_torch.model.io import save_ply

    shutil.rmtree(WORK, ignore_errors=True)
    scene_dir = os.path.join(WORK, "scene")
    model_dir = os.path.join(WORK, "model")
    g = bench_inputs(width, height, n)[:5]
    t0 = time.perf_counter()
    save_ply(os.path.join(model_dir, "point_cloud", "iteration_30000",
                          "point_cloud.ply"), *bench_params(g, dev))
    write_rendered_colmap(scene_dir, n_images=n_views, width=width, height=height,
                          gaussians=g, pose_fn=bench_pose, max_per_tile=1 << 12,
                          device=dev)
    dump_cfg_args(model_dir, Namespace(
        sh_degree=3, sg_degree=0, source_path=scene_dir, model_path=model_dir,
        images="images", masks="", resolution=1, white_background=False,
        eval=False, kernel_size=0.0))
    setup_s = time.perf_counter() - t0

    stats = []

    def on_view(idx, view, out):
        a = out["alpha"]
        stats.append({
            "view": idx,
            "finite": bool(all(torch.isfinite(out[k]).all() for k in
                               ("render", "alpha", "normal", "median_depth"))),
            "shape": list(out["render"].shape),
            "alpha_mean": float(a.mean()),
            "alpha_gt_half_frac": float((a > 0.5).float().mean()),
            "median_depth_valid_frac": float((out["median_depth"] > 0).float().mean()),
            "pairs": out["num_live_pairs"],
            "max_tile_count": out["max_tile_count"],
        })

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_cli.main(["-m", model_dir, "--save_depth", "--device", str(dev)],
                    on_view=on_view)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = read_launches()
    served = {k: counts.pop(k) for k in ("blend_fwd", "preprocess_fwd")}
    launches = served["blend_fwd"]

    out_dir = os.path.join(model_dir, "train", "ours_30000")
    files = {d: sorted(os.listdir(os.path.join(out_dir, d)))
             for d in ("renders", "gt", "depth")}
    emit({"phase": "slice", "views": n_views, "width": width, "height": height,
          "gaussians": n, "setup_s": setup_s, "cli_s": cli_s,
          "blend_fwd_launches": launches, "preprocess_fwd_launches": served["preprocess_fwd"],
          "files": {k: len(v) for k, v in files.items()},
          "per_view": stats})
    want = [f"{i:05d}.png" for i in range(n_views)]
    check(all(v == want for v in files.values()), f"PNG tree {files}")
    check(len(stats) == n_views, "not every view rendered")
    check(launches == n_views, f"blend_fwd launched {launches} times for {n_views} views")
    check(served["preprocess_fwd"] == n_views,
          f"preprocess_fwd launched {served['preprocess_fwd']} times for {n_views} views")
    check(not any(counts.values()), f"training kernels launched while serving: {counts}")
    for s in stats:
        check(s["finite"], f"view {s['view']} has non-finite output")
        check(s["shape"] == [height, width, 3], f"view {s['view']} shape {s['shape']}")
        check(s["alpha_mean"] > 0.05 and s["alpha_gt_half_frac"] > 0.01,
              f"view {s['view']} alpha coverage {s['alpha_mean']}")
        check(s["median_depth_valid_frac"] > 0.01, f"view {s['view']} has no median depth")
    shutil.rmtree(WORK, ignore_errors=True)
    return served


def reset_launches():
    from gsjax_torch.utils import benchsync

    benchsync.reset_launches()


def read_launches():
    """{kernel wrapper: launches} of this process."""
    from gsjax_torch.utils import benchsync

    return benchsync.launch_counts()


def views_loss(trainer, mapped=False):
    """The photometric loss (0.8 L1 + 0.2 D-SSIM) of the trainer's model,
    averaged over its training views. With `mapped` and GOF's appearance
    model, L1 reads the render through each view's appearance mapping."""
    import torch

    from gsjax_torch.model import appearance as app_lib
    from gsjax_torch.train import losses

    vals = []
    for v in trainer.scene.train_views:
        img = trainer.render_view(v, require_depth=False)["render"]
        gt = trainer.gt_for(v)
        with torch.no_grad():
            if mapped and trainer.app.kind == "gof":
                l1 = app_lib.l1_appearance_gof(img, gt, trainer.app.net,
                                               trainer.app.table[v.uid])
            else:
                l1 = losses.l1_loss(img, gt)
            vals.append(float(0.8 * l1 + 0.2 * (1 - losses.ssim(img, gt))))
    return float(np.mean(vals))


def phase_train(dev, n_views=6, width=1920, height=1080, n=100_000, steps=40,
                options=False, keep=None):
    """The training CLI at full width, with gsjax's default multi-view
    lambdas; returns {kernel: launches}. With `options` (phase
    `train_options`) the CLI runs with GSJAX_NCC_COMPACT=1 and GOF's
    appearance model.

    The per-step loss moves with the view drawn (about 15% between the six
    views), with the depth-normal and multi-view terms that enter at step 21
    and with the prune at each densify, so whether training lowers the loss
    is read on fixed views: the photometric loss over all six training
    views, rendered from the model at initialisation and after the last
    step. With GOF it is read through the appearance mapping of each view
    (the objective trained: its L1 on the mapped centre crop, SSIM on the
    render); the raw render's loss is printed beside it. With `keep` (a
    directory), the scene and the last checkpoint are moved there for the
    `multi_gpu` phase."""
    import torch

    from gsjax_torch import train as train_cli
    from gsjax_torch.data.readers import load_scene
    from gsjax_torch.model import appearance as app_lib
    from gsjax_torch.model.io import load_checkpoint, load_ply
    from gsjax_torch.train.loop import Trainer

    phase = "train_options" if options else "train"
    kind = "gof" if options else "no"

    shutil.rmtree(WORK, ignore_errors=True)
    model_dir = os.path.join(WORK, "train_model")
    t0 = time.perf_counter()
    scene_dir = write_train_scene(dev, n_views, width, height, n)
    # the model the CLI starts from (Trainer.create is deterministic)
    initial = Trainer.create(load_scene(scene_dir, device=dev), None, model_dir, dev,
                             appearance=kind)
    loss_before = views_loss(initial, True)
    raw_before = views_loss(initial, False)
    del initial
    setup_s = time.perf_counter() - t0
    argv = ["-s", scene_dir, "-m", model_dir, "--iterations", str(steps),
            "--densify_from_iter", "10", "--densification_interval", "10",
            "--densify_until_iter", "31", "--regularization_from_iter", "21",
            "--save_iterations", str(steps), "--checkpoint_iterations", str(steps),
            "--test_iterations", str(steps), "--device", str(dev)]
    if options:
        argv += ["--use_decoupled_appearance", "2"]
    log = []
    old_env = os.environ.get("GSJAX_NCC_COMPACT")
    os.environ["GSJAX_NCC_COMPACT"] = "1" if options else "0"
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv, on_step=lambda t, m: log.append(
            {"loss": m["loss"], "dn_loss": m["dn_loss"], "ncc_loss": m["ncc_loss"],
             "geo_loss": m["geo_loss"], "view": m["view"], "near": m["near"],
             "mv_queries": m["mv_queries"], "mv_max_tile_count": m["mv_max_tile_count"],
             "mv_blocks": m["mv_blocks"], "max_per_tile": m["max_per_tile"],
             "attempts": m["attempts"], "pairs": m["num_live_pairs"],
             "max_tile_count": m["max_tile_count"], "alive": int(t.aux.alive.sum()),
             "densify": m.get("densify")}))
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        if old_env is None:
            os.environ.pop("GSJAX_NCC_COMPACT", None)
        else:
            os.environ["GSJAX_NCC_COMPACT"] = old_env
    mv = [r for r in log if r["near"] is not None]
    ply = os.path.join(model_dir, "point_cloud", f"iteration_{steps}", "point_cloud.ply")
    _, aux = load_ply(ply, device=dev)
    step_losses = [r["loss"] for r in log]
    first, last = float(np.mean(step_losses[:10])), float(np.mean(step_losses[-10:]))
    loss_after = views_loss(trainer, True)
    raw_after = views_loss(trainer, False)
    densified = [r["densify"] for r in log if r["densify"]]
    frame_blocks = -(-width // 16) * -(-height // 16)
    extra = {}
    if options:
        *_, extra_arrays = load_checkpoint(
            os.path.join(model_dir, f"chkpnt{steps}.npz"), device=dev)
        want = app_lib.state_to_arrays(trainer.app)
        back = app_lib.state_to_arrays(app_lib.state_from_arrays(
            app_lib.init_appearance(kind, n_views, device=dev), extra_arrays))
        extra = {"appearance": kind, "ckpt_app_keys": len(extra_arrays),
                 "ckpt_app_reloads": sorted(back) == sorted(want) and all(
                     np.array_equal(back[k], want[k]) for k in want),
                 "frame_blocks": frame_blocks,
                 "raw_views_loss_before": raw_before, "raw_views_loss_after": raw_after}
    emit({"phase": phase, "views": n_views, "width": width, "height": height,
          "points": n, "steps": len(log), "setup_s": setup_s, "cli_s": cli_s,
          "launches": launches, "attempts": sum(r["attempts"] for r in log),
          "views_loss_before": loss_before, "views_loss_after": loss_after, **extra,
          "step_loss_first10": first, "step_loss_last10": last,
          "dn_loss_live_steps": sum(r["dn_loss"] > 0 for r in log),
          "mv_steps": len(mv), "neighbours": [len(v.nearest_ids)
                                              for v in trainer.scene.train_views],
          "mv_max_tile_count": max((r["mv_max_tile_count"] for r in mv), default=0),
          # neighbour lists longer than the cap are clamped, as in gsjax, and
          # nothing retries them (gsjax's overflow check reads only the
          # reference view)
          "mv_steps_near_list_clamped": sum(r["mv_max_tile_count"] > r["max_per_tile"]
                                            for r in mv),
          "densify": densified,
          "alive_final": int(trainer.aux.alive.sum()), "ply_alive": int(aux.alive.sum()),
          "max_per_tile": trainer.max_per_tile, "per_step": log})
    check(len(log) == steps, f"{len(log)} steps run")
    check(launches["blend_bwd"] == steps,
          f"blend_bwd launched {launches['blend_bwd']} times for {steps} steps")
    check(launches["blend_fwd"] == sum(r["attempts"] for r in log),
          f"blend_fwd launched {launches['blend_fwd']} times")
    # preprocess runs for each attempt's view and each query's neighbour, and
    # its VJP with B2 (the view) and B5 (the neighbour)
    for side, view, near in (("fwd", "blend_fwd", "sample_fwd"), ("bwd", "blend_bwd",
                                                                  "sample_bwd")):
        check(launches[f"preprocess_{side}"] == launches[view] + launches[near] > 0,
              f"preprocess_{side} launched {launches[f'preprocess_{side}']} times for "
              f"{launches[view]} {view} and {launches[near]} {near}")
    check(all(np.isfinite(x) for x in step_losses), "non-finite loss")
    check(all(v.nearest_ids for v in trainer.scene.train_views), "a view has no neighbour")
    check(len(mv) >= 5, f"only {len(mv)} steps ran the multi-view losses")
    for r in mv:
        check(np.isfinite(r["ncc_loss"]) and np.isfinite(r["geo_loss"])
              and r["ncc_loss"] > 0 and r["geo_loss"] > 0,
              f"multi-view losses {r['ncc_loss']}, {r['geo_loss']} on a multi-view step")
        check((0 < r["mv_blocks"] <= frame_blocks) if options else r["mv_blocks"] == 0,
              f"{r['mv_blocks']} NCC blocks on a multi-view step")
    ncc_kernel, unused = (("warp_sample_blocks", "warp_sample") if options
                          else ("warp_sample", "warp_sample_blocks"))
    for name in ("sample_fwd", "sample_bwd", ncc_kernel):
        check(launches[name] == len(mv),
              f"{name} launched {launches[name]} times for {len(mv)} multi-view steps")
    check(launches[unused] == 0, f"{unused} launched {launches[unused]} times")
    check(loss_after < loss_before, f"loss did not fall: {loss_before} -> {loss_after}")
    check(len(densified) == 2, f"densify ran {len(densified)} times")
    check(int(aux.alive.sum()) == int(trainer.aux.alive.sum()), "PLY does not load back")
    if options:
        check(extra["ckpt_app_keys"] > 0 and extra["ckpt_app_reloads"],
              "the checkpoint's appearance state does not reload")
    if keep is not None:
        shutil.rmtree(keep, ignore_errors=True)
        os.makedirs(keep)
        shutil.move(scene_dir, os.path.join(keep, "scene"))
        shutil.move(os.path.join(model_dir, f"chkpnt{steps}.npz"), keep)
    shutil.rmtree(WORK, ignore_errors=True)
    return launches

def applied_pairs(feats, binning, n_contrib, cfg, width, height):
    """[H, W] pairs each pixel applied: those of its tile's list before its
    n_contrib that pass the alpha test, counted with the twin's own test."""
    import torch

    from gsjax_torch.ops.raster import render_ref

    t = cfg.tile
    tiles_x, tiles_y = cfg.grid(width, height)
    n_tiles = tiles_x * tiles_y
    nc = torch.zeros(tiles_y * t, tiles_x * t, dtype=torch.int64, device=feats.device)
    nc[:height, :width] = n_contrib.to(torch.int64)
    nc = nc.reshape(tiles_y, t, tiles_x, t).permute(0, 2, 1, 3).reshape(n_tiles, t * t)
    feats_pad = torch.cat([feats, feats.new_zeros(1, feats.shape[1])])
    out = torch.zeros_like(nc)
    for i in range(0, n_tiles, cfg.tile_batch):
        ids = torch.arange(i, min(i + cfg.tile_batch, n_tiles), device=feats.device)
        px, py = render_ref._tile_pixels(ids, tiles_x, cfg)
        starts = binning.tile_start[ids].to(torch.int64)
        lim = nc[ids]
        limit = lim.amax(1)
        for base in range(0, int(limit.max()), cfg.chunk):
            f, rel, valid = render_ref._gather_chunk(feats_pad, starts, limit, base, cfg.chunk)
            _, passes, _, _ = render_ref._alpha_terms(f, px, py, cfg, valid)
            out[ids] += (passes & (rel[None, :, None] < lim[:, None, :])).sum(1)
    out = out.reshape(tiles_y, tiles_x, t, t).permute(0, 2, 1, 3)
    return out.reshape(tiles_y * t, tiles_x * t)[:height, :width]


def kernel_bound_ms(planes, feats, binning, cfg, width, height):
    """Least time the card needs for the blend of this frame: the larger of
    bytes moved (pair payload and tile ranges read once, 16 planes written
    once) over HBM bandwidth and fp32 operations (OPS_* above) over the fp32
    peak. Interactions are the ones these inputs need: a pixel marches its
    tile's list up to its last contributor, or the whole (clamped) list
    where T_final >= 1e-2 shows it never reached the stop; it blends its
    applied pairs; where T_final <= min_transmittance it brackets the median
    over them, and where the root is in range it runs the search's
    evaluations over them."""
    import torch

    t = cfg.tile
    tiles_x, tiles_y = cfg.grid(width, height)
    counts = binning.tile_count.clamp_max(cfg.max_per_tile).to(torch.float64)
    per_pix = counts.reshape(tiles_y, tiles_x).repeat_interleave(t, 0) \
        .repeat_interleave(t, 1)[:height, :width]
    n_contrib = planes[8].to(torch.float64)
    t_final = planes[10]
    marched = torch.where(t_final >= 1e-2, per_pix, n_contrib)
    applied = applied_pairs(feats, binning, planes[8], cfg, width, height).to(torch.float64)
    cand = applied * (t_final <= cfg.min_transmittance)
    in_range = applied * (planes[11] > 0)
    ops = float((marched * OPS_ALPHA + applied * OPS_APPLY
                 + cand * (OPS_PAIR_MEDIAN + MEDIAN_BRACKET * OPS_DEPTH)
                 + in_range * MEDIAN_NEWTON * (OPS_DEPTH + OPS_DERIV)).sum())
    nbytes = (binning.num_live * 16 * 4 + counts.numel() * 2 * 4 + 3 * 4
              + 16 * width * height * 4)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_F32_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "interactions_marched": float(marched.sum()),
            "interactions_applied": float(applied.sum()),
            "interactions_median": float(cand.sum()),
            "interactions_newton": float(in_range.sum())}


def phase_search(kernel, launch, dev, **where):
    """How the median search of `kernel` went: `launch(slots, counters)` runs
    it once. Its counters at the default slots (`render_cuda.search_stats`),
    its time there and at slots=0 (every search re-walks the list)."""
    from gsjax_torch.ops.raster import render_cuda

    ctr = render_cuda.search_counters(dev)
    launch(render_cuda.SLOTS, ctr)
    st = render_cuda.search_stats(ctr)
    ms = event_ms(lambda: launch(render_cuda.SLOTS, None))
    ms0 = event_ms(lambda: launch(0, None))
    emit({"phase": "search", "kernel": kernel, **where, "slots": render_cuda.SLOTS,
          "ms": ms, "slots0_ms": ms0, **st})
    check(st["searched"] > 0, f"{kernel}: no median searched")
    check(sum(st["hist"]) == st["searched"] and st["searched"] <= st["candidates"],
          f"{kernel}: search counters do not add up")
    check(1 <= st["iters_max"] <= 12, f"{kernel}: {st['iters_max']} Newton evaluations")
    return st


def far_scene(g, cfg, scale=FAR):
    """bench.py's scene `scale` times as far from its camera (at the origin):
    positions and scales times `scale`, and the near plane and the median's
    search range with them, so the image is the same and every depth `scale`
    times larger."""
    means, scales, quats, opac, shs = g
    return ((means * scale, scales * scale, quats, opac, shs),
            dataclasses.replace(cfg, sample_range=cfg.sample_range * scale,
                                near_plane=cfg.near_plane * scale))


def phase_bwd_profile(kernel, launch, dev, **where):
    """Where the warp cycles of backward kernel `kernel` go:
    `launch(counters)` runs it once. Its profile counters
    (`render_cuda.bwd_stats`), its time without them and with them."""
    from gsjax_torch.ops.raster import render_cuda

    ctr = render_cuda.bwd_counters(dev)
    launch(ctr)
    st = render_cuda.bwd_stats(ctr)
    ms = event_ms(lambda: launch(None))
    profiled_ms = event_ms(lambda: launch(ctr))
    emit({"phase": "bwd_profile", "kernel": kernel, **where, "ms": ms,
          "profiled_ms": profiled_ms, **st})
    check(st["warp_pairs_active"] > 0 and st["applied"] > 0,
          f"{kernel}: no pair applied in the profile")
    check(st["warp_pairs_active"] <= st["warp_pairs"] and st["warp_cycles"] > 0,
          f"{kernel}: profile counters do not add up")
    return st


def phase_timing(dev, twin_ms, width=1920, height=1080, n=100_000):
    import torch

    from gsjax_torch.ops.raster import RasterConfig, render, render_cuda
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.ops.raster.preprocess import preprocess

    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cam = bench_camera(width, height, dev)
    args, prep, binning, feats = stages(bench_inputs(width, height, n)[:5], cam, cfg, dev)
    bg = torch.zeros(3, device=dev)
    pre_ms = event_ms(lambda: preprocess(*args, None, None, None, cam, cfg))
    bin_ms = event_ms(lambda: bin_gaussians(prep, cfg, width, height))
    blend = lambda: render_cuda.blend_fwd(feats, binning.tile_start, binning.tile_count,
                                          width, height, cam.fx, cam.fy, bg, cfg)
    kernel_ms = event_ms(blend)
    cfg_nd = dataclasses.replace(cfg, require_depth=False)
    kernel_nd_ms = event_ms(lambda: render_cuda.blend_fwd(
        feats, binning.tile_start, binning.tile_count, width, height, cam.fx, cam.fy,
        bg, cfg_nd))
    render_ms = event_ms(lambda: render(*args, cam, cfg, bg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render(*args, cam, cfg, bg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bound = kernel_bound_ms(blend(), feats, binning, cfg, width, height)
    near = phase_search("blend_fwd", lambda s, c: render_cuda.blend_fwd(
        feats, binning.tile_start, binning.tile_count, width, height, cam.fx, cam.fy, bg,
        cfg, slots=s, counters=c), dev, width=width, height=height, gaussians=n, scale=1.0)
    g_far, cfg_far = far_scene(bench_inputs(width, height, n)[:5], cfg)
    _, _, b_far, f_far = stages(g_far, cam, cfg_far, dev)
    far = phase_search("blend_fwd", lambda s, c: render_cuda.blend_fwd(
        f_far, b_far.tile_start, b_far.tile_count, width, height, cam.fx, cam.fy, bg,
        cfg_far, slots=s, counters=c), dev, width=width, height=height, gaussians=n,
        scale=FAR, near_iters_mean=near["iters_mean"])
    del f_far, b_far
    check(abs(far["iters_mean"] - near["iters_mean"]) <= FAR_ITERS,
          f"B1 Newton evaluations {far['iters_mean']} at z ~ 300 against "
          f"{near['iters_mean']} near")
    emit({"phase": "timing", "width": width, "height": height, "gaussians": n,
          "pairs": binning.num_live, "enumerated_pairs": binning.num_pairs,
          "max_tile_count": binning.max_tile_count,
          "preprocess_ms": pre_ms, "binning_ms": bin_ms, "blend_kernel_ms": kernel_ms,
          "blend_kernel_no_depth_ms": kernel_nd_ms,
          "render_ms": render_ms, "twin_ms": twin_ms, "peak_mem_bytes": peak, **bound})
    return kernel_ms, bound


def bwd_bound_ms(planes, feats, binning, cfg, width, height):
    """Least time the card needs for B2 on this frame: bytes (payload, tile
    ranges and the 13 plane rows plus 8 cotangent rows B2 reads, once each;
    d_payload written once) over HBM bandwidth against operations (OPS_BWD_*)
    over the fp32 peak, for the interactions these inputs need."""
    import torch

    n_contrib = planes[8].to(torch.float64)
    applied = applied_pairs(feats, binning, planes[8], cfg, width, height).to(torch.float64)
    median = applied * (planes[11] > 0) if cfg.require_depth else torch.zeros_like(applied)
    ops = float((n_contrib * OPS_ALPHA + applied * OPS_BWD_APPLY
                 + median * OPS_BWD_MEDIAN).sum()) + OPS_BWD_PIXEL * width * height
    counts = binning.tile_count.numel()
    nbytes = (2 * binning.num_live * 16 * 4 + counts * 2 * 4 + 3 * 4
              + (13 + 8) * width * height * 4)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_F32_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "interactions_before_n_contrib": float(n_contrib.sum()),
            "interactions_applied": float(applied.sum()),
            "interactions_median": float(median.sum())}


def phase_timing_train(dev, width=1920, height=1080, n=100_000):
    """B2, bench.py's fwd+bwd and train steps at 1080p / 100k; returns
    (B2 ms, B2 bound, {bench.py's loss, its rays/s})."""
    import torch

    from gsjax_torch import bench
    from gsjax_torch.model import appearance as app_lib
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.raster import RasterConfig, render, render_cuda
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.ops.raster.preprocess import preprocess
    from gsjax_torch.ops.raster.render_ref import prepare_pairs
    from gsjax_torch.train import losses
    from gsjax_torch.train.step import LossConfig, train_step

    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cfg_nd = dataclasses.replace(cfg, require_depth=False)
    cam = bench_camera(width, height, dev)
    *g, gt = bench_inputs(width, height, n)
    gt = torch.as_tensor(gt, device=dev)
    args, prep, binning, feats = stages(g, cam, cfg, dev)
    bg = torch.zeros(3, device=dev)
    lists = (feats, binning.tile_start, binning.tile_count)
    tail = (width, height, cam.fx, cam.fy, bg)
    out = {}
    b2 = {}
    for name, c in (("depth", cfg), ("no_depth", cfg_nd)):
        planes = render_cuda.blend_fwd(*lists, *tail, c)
        grad = bench_cotangent(planes, gt, c.require_depth)
        b2[name] = (planes, grad)
        out[f"b1_{name}_ms"] = event_ms(lambda: render_cuda.blend_fwd(*lists, *tail, c))
        out[f"b2_{name}_ms"] = event_ms(
            lambda: render_cuda.blend_bwd(*lists, planes, grad, *tail, c))
        phase_bwd_profile("blend_bwd", lambda ctr: render_cuda.blend_bwd(
            *lists, planes, grad, *tail, c, counters=ctr), dev, width=width,
            height=height, gaussians=n, require_depth=c.require_depth)
    bound = bwd_bound_ms(b2["depth"][0], feats, binning, cfg, width, height)

    # bench.py's step: render + 0.8 L1 + 0.2 (1 - SSIM) + 1e-6 mean depth, fwd+bwd
    # (max_per_tile 1 << 12 here, bench.py's 1 << 11: the largest list, 1100,
    # fits either, so neither clamps)
    leaves = [a.clone().requires_grad_(True) for a in args]
    step_loss = []

    def fwd_bwd():
        loss, grads, _ = bench.loss_and_grads(leaves, gt, cam, cfg, bg)
        step_loss[:] = [loss]
        return grads

    out["fwd_bwd_ms"] = event_ms(fwd_bwd, reps=5)
    out["fwd_bwd_loss"] = float(step_loss[0].detach())
    out["raster_fwd_bwd_rays_per_s_1080p"] = width * height / (out["fwd_bwd_ms"] * 1e-3)

    # stages of one step, timed apart (reg on)
    prep_in = [a.clone().requires_grad_(True) for a in args]
    out["preprocess_fwd_ms"] = event_ms(
        lambda: preprocess(*prep_in, None, None, None, cam, cfg))
    out["binning_ms"] = event_ms(lambda: bin_gaussians(prep, cfg, width, height))
    img = render(*args, cam, cfg, bg)["render"].detach().requires_grad_(True)

    def loss_fwd_bwd():
        loss = 0.8 * losses.l1_loss(img, gt) + 0.2 * (1 - losses.ssim(img, gt))
        return torch.autograd.grad(loss, img)

    out["l1_ssim_fwd_bwd_ms"] = event_ms(loss_fwd_bwd)
    d_feats = render_cuda.blend_bwd(*lists, *b2["depth"], *tail, cfg)

    def prep_bwd():
        p = preprocess(*prep_in, None, None, None, cam, cfg)
        f = prepare_pairs(p, binning)
        return torch.autograd.grad(f, prep_in, d_feats, allow_unused=True)

    out["preprocess_fwd_bwd_ms"] = event_ms(prep_bwd)

    # whole train steps (train_step ends in a host read of the loss)
    params, aux = bench_params(g, dev)
    adam = gm.adam_init(params)
    lrs = dict(xyz=1.6e-4, features_dc=0.0025, features_rest=0.0001, opacity=0.05,
               scaling=0.005, rotation=0.001, sg_axis=0.002, sg_sharpness=0.095,
               sg_color=0.00064)
    grads = {k: torch.zeros_like(getattr(params, k)) for k in gm.PARAM_FIELDS}
    out["adam_ms"] = event_ms(lambda: gm.adam_update(params, grads, adam, lrs))
    for name, reg_on in (("reg_on", True), ("reg_off", False)):
        c = cfg if reg_on else cfg_nd
        step = lambda: train_step(params, aux, adam, cam, gt, bg, lrs, c,
                                  LossConfig(reg_on=reg_on))
        out[f"train_step_{name}_ms"] = event_ms(step, reps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        out[f"train_step_{name}_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.reset_peak_memory_stats()
    train_step(params, aux, adam, cam, gt, bg, lrs, cfg, LossConfig(reg_on=True))
    torch.cuda.synchronize()
    out["train_step_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["profile"] = profile_step(lambda: train_step(params, aux, adam, cam, gt, bg, lrs,
                                                     cfg, LossConfig(reg_on=True)))
    # a reg-on step with each appearance model (the view's row; GOF's CNN)
    for kind in ("gs", "pgsr", "gof"):
        app = app_lib.init_appearance(kind, 1, torch.Generator().manual_seed(0), dev)
        step = lambda: train_step(params, aux, adam, cam, gt, bg, lrs, cfg,
                                  LossConfig(reg_on=True, appearance=kind),
                                  app_embedding=app.table[0], app_net=app.net)
        out[f"train_step_app_{kind}_ms"] = event_ms(step, reps=5)
    emit({"phase": "timing_train", "width": width, "height": height, "gaussians": n,
          "pairs": binning.num_live, **out, "b2_bound": bound})
    return out["b2_depth_ms"], bound, {"loss": out["fwd_bwd_loss"],
                                       "rays_per_s": out["raster_fwd_bwd_rays_per_s_1080p"]}


def mv_scene(width, height, n, dev, ref=2, near=3, n_views=6):
    """bench.py's gaussians seen from two neighbouring arc poses of the train
    scene (fx = 0.9 width, as data/synth.py writes it): the reference view's
    render (median depth, normal), both views' luma, the reference's pixels
    backprojected to world points, those with a depth (the multi-view loss's
    queries in the neighbour), and the loss's geometric mask and weights
    (`d_mask`, `weights`: `multiview._geo_terms` on those queries)."""
    import torch

    from gsjax_torch.core.transforms import focal2fov
    from gsjax_torch.ops.raster import Camera, RasterConfig, render
    from gsjax_torch.train.multiview import _geo_terms, backproject

    means, scales, quats, opac, shs, _ = bench_inputs(width, height, n)
    fov = (focal2fov(0.9 * width, width), focal2fov(0.9 * width, height))
    cams = [Camera.create(bench_pose(i, n_views)[0].T, bench_pose(i, n_views)[1], *fov,
                          width, height, device=dev) for i in (ref, near)]
    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    args = [torch.as_tensor(a, device=dev) for a in (means, scales, quats, opac[:, 0])]
    shs_t = torch.as_tensor(shs, device=dev)
    outs = [render(*args, shs_t, c, cfg, torch.zeros(3, device=dev)) for c in cams]
    gray = [(o["render"] * torch.tensor([0.299, 0.587, 0.114], device=dev)).sum(-1)
            .contiguous() for o in outs]
    md = outs[0]["median_depth"]
    world = backproject(md, cams[0])
    with torch.no_grad():
        _, _, d_mask, weights, _, _ = _geo_terms(
            world, md, *args, torch.ones(n, dtype=torch.bool, device=dev), *cams, cfg, 1.0)
    return {"args": args, "cams": cams, "cfg": cfg, "depth": md,
            "normal": outs[0]["normal"], "gray": gray, "points": world[md > 0],
            "d_mask": d_mask, "weights": weights}


def timed_once(fn):
    """(result, CUDA-event ms) of one call of a plain-PyTorch twin."""
    import torch

    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def col_rel_err(k, t):
    """Per-row largest error relative to each column's largest |t| entry."""
    return ((k - t).abs() / t.abs().amax(0).clamp_min(1e-30)).amax(1)


def phase_parity_sample(width, height, n, dev, scene=None):
    """B3 and B5 against their twins on the same lists, points and rows;
    returns (summary, query, B3 rows, seeded cotangent)."""
    import torch

    from gsjax_torch.ops import sample_cuda, sample_ref
    from gsjax_torch.ops.sample import prepare_query

    sc = scene or mv_scene(width, height, n, dev)
    cfg = sc["cfg"]
    qr = prepare_query(sc["points"], *sc["args"], sc["cams"][1], cfg)
    lists = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts, qr.blocks)
    rk = sample_cuda.sample_fwd(*lists, cfg)
    rk0 = sample_cuda.sample_fwd(*lists, cfg, slots=0)
    rt, fwd_twin_ms = timed_once(lambda: sample_ref.sample_fwd_rows(*lists, cfg))

    def fwd_err(rk):
        both = (rk[1] > 0) & (rt[1] > 0)
        md_close = torch.isclose(rk[0], rt[0], atol=MD_ATOL, rtol=MD_RTOL)
        dd_close = torch.isclose(rk[5][both], rt[5][both], rtol=DD_RTOL, atol=DD_ATOL)
        return {"finite": bool(torch.isfinite(rk).all()),
                "in_range_frac": float((rk[1] > 0).float().mean()),
                "in_range_equal_frac": float((rk[1] == rt[1]).float().mean()),
                "m_t_close_frac": float(md_close.float().mean()),
                "m_t_max_abs_err": float((rk[0] - rt[0])[both].abs().max()),
                "n_contrib_equal_frac": float((rk[2] == rt[2]).float().mean()),
                "md_init_close_frac": float(torch.isclose(rk[3], rt[3], atol=MD_ATOL,
                                                          rtol=MD_RTOL).float().mean()),
                "t_final_max_abs_err": float((rk[4] - rt[4]).abs().max()),
                "dlogT_dt_close_frac": float(dd_close.float().mean())}

    fwd = {"points": int(qr.pts.shape[0]), "blocks": int(qr.blocks.shape[0]),
           "pairs": qr.binning.num_live, "max_tile_count": qr.binning.max_tile_count,
           "twin_fwd_ms": fwd_twin_ms, "slots": sample_cuda.SLOTS, **fwd_err(rk)}
    fwd0 = fwd_err(rk0)

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    g = torch.randn(qr.pts.shape[0], generator=gen, device=dev)
    dk, pk = sample_cuda.sample_bwd(*lists, rk, g, cfg)
    (dt, pt), bwd_twin_ms = timed_once(lambda: sample_ref.sample_bwd_rows(*lists, rk, g, cfg))
    err = col_rel_err(dk, dt)
    n_g = sc["args"][0].shape[0]
    gk = torch.zeros(n_g, 16, device=dev).index_add_(0, qr.binning.gauss_idx, dk)
    gt = torch.zeros(n_g, 16, device=dev).index_add_(0, qr.binning.gauss_idx, dt)
    touched = gt.abs().amax(1) > 0
    gerr = col_rel_err(gk, gt)[touched]
    perr = col_rel_err(pk, pt)
    bwd = {"twin_bwd_ms": bwd_twin_ms,
           "bwd_finite": bool(torch.isfinite(dk).all() and torch.isfinite(pk).all()),
           "pair_max_err": float(err.max()),
           "pair_close_frac": float((err <= BWD_TOL).double().mean()),
           "gauss_max_err": float(gerr.max()),
           "gauss_close_frac": float((gerr <= GAUSS_TOL).double().mean()),
           "point_max_err": float(perr.max()),
           "point_close_frac": float((perr <= PT_TOL).double().mean()),
           "nonzero_cols": [int(c) for c in torch.nonzero(dt.abs().amax(0) > 0)[:, 0]]}
    emit({"phase": "parity_sample", "width": width, "height": height, "gaussians": n,
          **fwd, "slots0": fwd0, **bwd})
    check(bwd["bwd_finite"], "B5 output not finite")
    for f, tag in ((fwd, f"slots={sample_cuda.SLOTS}"), (fwd0, "slots=0")):
        check(f["finite"], f"B3 output not finite ({tag})")
        check(f["m_t_close_frac"] >= MD_FRAC, f"B3 m_t close on {f['m_t_close_frac']} ({tag})")
        check(f["m_t_max_abs_err"] <= MD_MAX, f"B3 m_t max error {f['m_t_max_abs_err']} ({tag})")
        check(f["in_range_equal_frac"] >= MD_FRAC,
              f"B3 in_range equal on {f['in_range_equal_frac']} ({tag})")
        check(f["md_init_close_frac"] >= MD_FRAC, f"B3 md_init close on {f['md_init_close_frac']}")
        check(f["n_contrib_equal_frac"] >= NCONTRIB_FRAC,
              f"B3 n_contrib equal on {f['n_contrib_equal_frac']}")
        check(f["dlogT_dt_close_frac"] >= DD_FRAC,
              f"B3 dlogT/dt close on {f['dlogT_dt_close_frac']} ({tag})")
        check(f["in_range_frac"] > 0.5, f"only {f['in_range_frac']} of the queries in range")
    check(bwd["nonzero_cols"] == [0, 1, 2, 3, 4, 5, 9, 10, 11, 12],
          f"twin gradient columns {bwd['nonzero_cols']}")
    for key, frac, mx in (("pair", BWD_FRAC, BWD_MAX), ("gauss", GAUSS_FRAC, GAUSS_MAX),
                          ("point", PT_FRAC, PT_MAX)):
        check(bwd[f"{key}_close_frac"] >= frac, f"B5 {key}s close on {bwd[f'{key}_close_frac']}")
        check(bwd[f"{key}_max_err"] <= mx, f"B5 {key} max error {bwd[f'{key}_max_err']}")
    return {**fwd, **bwd}, qr, rk, g


def scene_taps(sc):
    """Tap positions [49, H, W] of the reference view's homographies into the
    neighbour (the NCC's, from the rendered depth and normal)."""
    from gsjax_torch.ops.ncc import neighbour_taps

    args = ncc_inputs(sc)
    un, vn = neighbour_taps(args[0].detach(), args[1].detach(), *args[4:])
    return un.contiguous(), vn.contiguous()


def phase_parity_warp(sc):
    """B6 against its twin on the taps of a real homography per pixel."""
    import torch

    from gsjax_torch.ops import warp_sample as ws

    un, vn = scene_taps(sc)
    gray_n = sc["gray"][1]
    pk = ws.warp_sample(gray_n, un, vn)
    pt, plain = timed_once(lambda: ws.bilinear_ref(gray_n, un, vn))
    hn, wn = gray_n.shape
    inside = (un >= 0) & (un <= wn - 1) & (vn >= 0) & (vn <= hn - 1)
    err = [float((pk[i] - pt[i]).abs().max()) for i in range(3)]
    # taps of pixels with a depth (the others have no plane to warp by)
    out = {"taps": int(un.numel()),
           "inside_frac": float(inside[:, sc["depth"] > 0].float().mean()),
           "twin_ms": plain, "value_max_abs_err": err[0], "du_max_abs_err": err[1],
           "dv_max_abs_err": err[2], "finite": bool(torch.isfinite(pk).all())}
    emit({"phase": "parity_warp", "height": int(un.shape[1]), "width": int(un.shape[2]),
          **out})
    check(out["finite"], "B6 output not finite")
    check(max(err) <= WARP_MAX, f"B6 max error {max(err)}")
    check(out["inside_frac"] > 0.5, f"only {out['inside_frac']} of the taps in the image")
    return out


def ncc_inputs(sc):
    """The NCC's arguments on the multi-view cell: depth and unit normal
    (leaves that take gradients), the luma frames, the reference -> neighbour
    motion and both intrinsics."""
    from gsjax_torch.train.multiview import _invert_rigid

    ref, near = sc["cams"]
    nrm = sc["normal"] / sc["normal"].norm(dim=-1, keepdim=True).clamp_min(1e-12)
    rel = near.world_view @ _invert_rigid(ref.world_view)
    return (sc["depth"].clone().requires_grad_(True), nrm.clone().requires_grad_(True),
            sc["gray"][0], sc["gray"][1], rel[:3, :3], rel[:3, 3],
            (ref.fx, ref.fy, ref.cx, ref.cy), (near.fx, near.fy, near.cx, near.cy))


def ncc_dense_masked(args, sc):
    """The dense NCC's loss terms on the mask, as `patchmatch_losses` sums
    them: (ncc_sum, ncc_cnt)."""
    import torch

    from gsjax_torch.ops.ncc import warp_patch_ncc

    cc, valid = warp_patch_ncc(*args)
    ncc = torch.clamp(1.0 - cc, 0.0, 2.0)
    mask = ((ncc < 0.9) & valid & sc["d_mask"]).detach()
    return torch.where(mask, ncc * sc["weights"], 0.0).sum(), mask.sum()


def phase_parity_ncc_blocks(sc):
    """B6 launched on the compacted blocks' taps against its twin, and the
    block-compacted NCC against the dense one on the reference view's
    geometric mask, both on the card."""
    import torch

    from gsjax_torch.ops import warp_sample as ws
    from gsjax_torch.ops.ncc import block_neighbour_taps, warp_patch_ncc_blocks

    args = ncc_inputs(sc)
    gray_n = args[3]
    un, vn = block_neighbour_taps(args[0].detach(), args[1].detach(), sc["d_mask"], *args[4:])
    pk = ws.warp_sample_blocks(gray_n, un, vn)
    pt, plain = timed_once(lambda: ws.bilinear_ref(gray_n, un, vn))
    err = [float((pk[i] - pt[i]).abs().max()) for i in range(3)]
    del pk, pt, un, vn

    s_b, c_b, win_rej, n_blocks = warp_patch_ncc_blocks(*args, sc["d_mask"], sc["weights"])
    g_b = torch.autograd.grad(s_b, args[:2])
    s_d, c_d = ncc_dense_masked(args, sc)
    g_d = torch.autograd.grad(s_d, args[:2])
    h, w = sc["depth"].shape
    frame_blocks = -(-h // 16) * -(-w // 16)
    grad_err = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_b, g_d)]
    out = {"blocks": n_blocks, "frame_blocks": frame_blocks,
           "block_share": n_blocks / frame_blocks,
           "mask_pixels": int(sc["d_mask"].sum()),
           "mask_pixel_share": float(sc["d_mask"].float().mean()),
           "taps": n_blocks * 49 * 256, "twin_ms": plain, "value_max_abs_err": err[0],
           "du_max_abs_err": err[1], "dv_max_abs_err": err[2],
           "ncc_sum_blocks": float(s_b.detach()), "ncc_sum_dense": float(s_d.detach()),
           "ncc_sum_rel_err": abs(float(s_b.detach()) - float(s_d.detach())) / abs(float(s_d.detach())),
           "ncc_cnt_blocks": int(c_b), "ncc_cnt_dense": int(c_d),
           "grad_depth_rel_err": grad_err[0], "grad_normal_rel_err": grad_err[1],
           "grads_finite": all(bool(torch.isfinite(g).all()) for g in g_b),
           "win_rej": win_rej}
    emit({"phase": "parity_ncc_blocks", "height": h, "width": w, **out})
    check(max(err) <= WARP_MAX, f"B6 on compacted taps: max error {max(err)}")
    check(0 < n_blocks <= frame_blocks, f"{n_blocks} blocks selected")
    check(out["ncc_cnt_blocks"] > 0, "no pixel in the NCC loss")
    check(out["ncc_sum_rel_err"] <= NCC_RTOL, f"ncc_sum off by {out['ncc_sum_rel_err']}")
    check(out["ncc_cnt_blocks"] == out["ncc_cnt_dense"],
          f"ncc_cnt {out['ncc_cnt_blocks']} against {out['ncc_cnt_dense']}")
    check(out["grads_finite"] and max(grad_err) <= NCC_GRAD,
          f"block NCC gradients off by {grad_err} of scale")
    return {**out, "max_abs_err": max(err)}


def point_interactions(qr, res, cfg):
    """Per sorted point: the pairs its march tested (its tile's clamped list
    up to n_contrib, or the whole list where T_final >= 1e-2 shows it never
    stopped) and the pairs it applied (before n_contrib, passing the alpha
    test, counted with the twin's own test)."""
    import torch

    from gsjax_torch.ops import sample_ref
    from gsjax_torch.ops.raster import render_ref

    b = qr.binning
    feats_pad = torch.cat([qr.feats, qr.feats.new_zeros(1, 16)])
    n_contrib = res[2].to(torch.int64)
    applied = torch.zeros_like(n_contrib)
    for ids, starts, counts in sample_ref._batches(b.tile_start, b.tile_count, qr.blocks, cfg):
        idx, px, py, valid = sample_ref._block_points(qr.pts, qr.blocks, ids)
        lim = torch.where(valid, n_contrib[idx], 0)
        limit = lim.amax(1)
        acc = torch.zeros_like(lim)
        for base in range(0, int(limit.max()), cfg.chunk):
            f, rel, vld = render_ref._gather_chunk(feats_pad, starts, limit, base, cfg.chunk)
            _, passes, _, _ = render_ref._alpha_terms(f, px, py, cfg, vld)
            acc += (passes & (rel[None, :, None] < lim[:, None, :])).sum(1)
        applied[idx[valid]] = acc[valid]
    tile = torch.repeat_interleave(qr.blocks[:, 0].to(torch.int64),
                                   qr.blocks[:, 2].to(torch.int64))
    count = b.tile_count.to(torch.int64).clamp_max(cfg.max_per_tile)[tile]
    marched = torch.where(res[4] >= 1e-2, count, n_contrib)
    return marched.to(torch.float64), applied.to(torch.float64)


def integrate_needs(qr, res, t_eval, cfg):
    """What B4's function needs on this query (OPS_REACH above), from the
    twin's own alpha test: `reach`, the (pair, point) tests whose cut-off
    ellipse reaches the point within its march (the applied pairs and the
    first passing pair after them, which stops the march); `applied`; `near`,
    the applied pairs within 6 sigmas of the point; `warp_pairs`, summed over
    warps of 32 consecutive points of a block, the pairs up to the warp's
    longest march."""
    import torch

    from gsjax_torch.ops import sample_ref
    from gsjax_torch.ops.raster import render_ref

    b = qr.binning
    feats_pad = torch.cat([qr.feats, qr.feats.new_zeros(1, 16)])
    n_contrib = res[2].to(torch.int64)
    big = torch.iinfo(torch.int64).max
    tot = dict.fromkeys(("reach", "applied", "near", "warp_pairs"), 0)
    for ids, starts, counts in sample_ref._batches(b.tile_start, b.tile_count, qr.blocks, cfg):
        idx, px, py, valid = sample_ref._block_points(qr.pts, qr.blocks, ids)
        lim = torch.where(valid, n_contrib[idx], 0)[:, None, :]
        et = torch.where(valid, t_eval[idx], 0.0)[:, None, :]
        first_after = torch.full_like(idx, big)
        for base in range(0, int(counts.max()), cfg.chunk):
            f, rel, vld = render_ref._gather_chunk(feats_pad, starts, counts, base, cfg.chunk)
            _, passes, dx, dy = render_ref._alpha_terms(f, px, py, cfg, vld)
            passes &= valid[:, None, :]
            r = rel[None, :, None]
            applied = passes & (r < lim)
            t_peak = f[..., 9:10] * dx + f[..., 10:11] * dy + f[..., 11:12]
            rsig = f[..., 12:13]
            near = applied & (rsig > 0) & (((et - t_peak) * rsig).abs() < 6.0)
            tot["applied"] += int(applied.sum())
            tot["near"] += int(near.sum())
            first_after = torch.minimum(
                first_after, torch.where(passes & (r >= lim), r, big).amin(1))
        stopped = first_after < big
        tot["reach"] += int(stopped.sum())
        marched = torch.where(stopped, first_after + 1, counts[:, None])
        marched = torch.where(valid, marched, 0)
        tot["warp_pairs"] += int(marched.view(marched.shape[0], -1, 32).amax(2).sum())
    tot["reach"] += tot["applied"]
    return tot


def roofline(nbytes, ops):
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_F32_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def sample_bounds(qr, res, g, cfg):
    """Least times the card needs for B3 and for B5 on this query: bytes
    (each input read once, each output written once) against operations
    (OPS_* above) for the interactions these inputs need."""
    import torch

    marched, applied = point_interactions(qr, res, cfg)
    cand = (res[4] <= cfg.min_transmittance).to(torch.float64)
    in_range = (res[1] > 0).to(torch.float64)
    ops3 = float((marched * OPS_ALPHA + applied * OPS_POINT_APPLY
                  + cand * applied * (OPS_PAIR_MEDIAN + MEDIAN_BRACKET * OPS_DEPTH)
                  + in_range * applied * MEDIAN_NEWTON * (OPS_DEPTH + OPS_DERIV)).sum())
    k, q = qr.feats.shape[0], qr.pts.shape[0]
    lists = 2 * 4 * qr.binning.tile_count.numel() + 12 * qr.blocks.shape[0]
    b3 = roofline(k * 64 + lists + q * 8 + 6 * q * 4, ops3)
    live = in_range * (g != 0).to(torch.float64) * (res[5].abs() > 1e-20).to(torch.float64)
    n_contrib = res[2].to(torch.float64)
    ops5 = float((live * (n_contrib * OPS_ALPHA + applied * OPS_SBWD_APPLY)).sum()) \
        + OPS_SBWD_POINT * q
    b5 = roofline(2 * k * 64 + lists + q * 8 + 4 * q * 4 + q * 4 + q * 8, ops5)
    inter = {"interactions_marched": float(marched.sum()),
             "interactions_applied": float(applied.sum()),
             "interactions_median": float((cand * applied).sum()),
             "interactions_newton": float((in_range * applied).sum())}
    return {**b3, **inter}, {**b5, "interactions_before_n_contrib": float(
        (live * n_contrib).sum()), "interactions_applied": float((live * applied).sum())}


def phase_timing_mv(dev, sc, qr, res, g, width=1920, height=1080, n=100_000):
    """B3, B5, B6 (on every pixel's taps and on the compacted blocks' taps)
    against their bounds, the multi-view ops forward + backward and a train
    step with the multi-view losses, dense and block-compacted; returns (ms,
    bounds)."""
    import torch
    import torch.nn.functional as F

    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops import sample_cuda
    from gsjax_torch.ops import warp_sample as ws
    from gsjax_torch.ops.ncc import (block_neighbour_taps, warp_patch_ncc,
                                     warp_patch_ncc_blocks)
    from gsjax_torch.ops.sample import sample_depth
    from gsjax_torch.train.step import LossConfig, train_step

    cfg = sc["cfg"]
    ref, near = sc["cams"]
    lists = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts, qr.blocks)
    out = {"points": int(qr.pts.shape[0])}
    out["b3_ms"] = event_ms(lambda: sample_cuda.sample_fwd(*lists, cfg))
    out["b5_ms"] = event_ms(lambda: sample_cuda.sample_bwd(*lists, res, g, cfg))
    per_tile = torch.bincount(qr.blocks[:, 0].long())
    per_tile = per_tile[per_tile > 0]
    phase_bwd_profile("sample_bwd", lambda ctr: sample_cuda.sample_bwd(
        *lists, res, g, cfg, counters=ctr), dev, points=int(qr.pts.shape[0]),
        blocks=int(qr.blocks.shape[0]), tiles=int(per_tile.numel()),
        tiles_multi_block=int((per_tile > 1).sum()),
        blocks_in_multi_block_tiles=int(per_tile[per_tile > 1].sum()),
        max_blocks_per_tile=int(per_tile.max()))
    b3_bound, b5_bound = sample_bounds(qr, res, g, cfg)
    phase_search("sample_fwd", lambda s, c: sample_cuda.sample_fwd(
        *lists, cfg, slots=s, counters=c), dev, points=int(qr.pts.shape[0]))

    un, vn = scene_taps(sc)
    gray_n = sc["gray"][1]
    out["b6_ms"] = event_ms(lambda: ws.warp_sample(gray_n, un, vn))
    hn, wn = gray_n.shape
    grid = torch.stack([un / (wn - 1) * 2 - 1, vn / (hn - 1) * 2 - 1], -1) \
        .reshape(1, -1, un.shape[2], 2)
    out["grid_sample_ms"] = event_ms(lambda: F.grid_sample(
        gray_n[None, None], grid, mode="bilinear", padding_mode="border", align_corners=True))
    del grid
    taps = un.numel()
    b6_bound = roofline(5 * taps * 4 + hn * wn * 4, OPS_WARP * taps)
    # B6 on the compacted blocks' taps [B, 49, 256] (the block NCC's launch)
    args = ncc_inputs(sc)
    unb, vnb = block_neighbour_taps(args[0].detach(), args[1].detach(), sc["d_mask"],
                                    *args[4:])
    out["b6b_ms"] = event_ms(lambda: ws.warp_sample_blocks(gray_n, unb, vnb))
    grid = torch.stack([unb / (wn - 1) * 2 - 1, vnb / (hn - 1) * 2 - 1], -1) \
        .reshape(1, -1, unb.shape[2], 2)
    out["grid_sample_blocks_ms"] = event_ms(lambda: F.grid_sample(
        gray_n[None, None], grid, mode="bilinear", padding_mode="border", align_corners=True))
    del grid
    out["block_taps"] = unb.numel()
    b6b_bound = roofline(5 * unb.numel() * 4 + hn * wn * 4, OPS_WARP * unb.numel())
    del unb, vnb

    # the multi-view ops forward + backward, as the train step runs them
    pts = sc["points"].clone().requires_grad_(True)
    leaves = [a.clone().requires_grad_(True) for a in sc["args"]]
    w = torch.randn(pts.shape[0], device=dev)

    def sample_fwd_bwd():
        r = sample_depth(pts, *leaves, near, cfg)
        loss = torch.where(r["inside"], r["sampled_depth"] * w, 0.0).sum()
        return torch.autograd.grad(loss, [pts, *leaves])

    out["sample_depth_fwd_bwd_ms"] = event_ms(sample_fwd_bwd, reps=5)

    def ncc_fwd_bwd():
        cc, valid = warp_patch_ncc(*args)
        return torch.autograd.grad(torch.where(valid, 1 - cc, 0.0).sum(), args[:2])

    out["warp_patch_ncc_fwd_bwd_ms"] = event_ms(ncc_fwd_bwd, reps=5)
    del un, vn

    def blocks_fwd_bwd():
        s_b, *_ = warp_patch_ncc_blocks(*args, sc["d_mask"], sc["weights"])
        return torch.autograd.grad(s_b, args[:2])

    out["warp_patch_ncc_blocks_fwd_bwd_ms"] = event_ms(blocks_fwd_bwd, reps=5)
    for name, fn in (("warp_patch_ncc", ncc_fwd_bwd), ("warp_patch_ncc_blocks", blocks_fwd_bwd)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_fwd_bwd_peak_mem_bytes"] = torch.cuda.max_memory_allocated() - base

    # train steps with the multi-view losses (the step ends in a host read)
    *gauss, gt = bench_inputs(width, height, n)
    params, aux = bench_params(gauss, dev)
    adam = gm.adam_init(params)
    lrs = dict(xyz=1.6e-4, features_dc=0.0025, features_rest=0.0001, opacity=0.05,
               scaling=0.005, rotation=0.001, sg_axis=0.002, sg_sharpness=0.095,
               sg_color=0.00064)
    gt = torch.as_tensor(gt, device=dev)
    bg = torch.zeros(3, device=dev)
    mv = dict(near_cam=near, gray_r=sc["gray"][0], gray_n=gray_n)
    step = lambda: train_step(params, aux, adam, ref, gt, bg, lrs, cfg,
                              LossConfig(reg_on=True, mv_on=True), **mv)
    metrics = step()[3]
    out["step_mv_queries"] = metrics["mv_queries"]
    out["step_ncc_loss"], out["step_geo_loss"] = metrics["ncc_loss"], metrics["geo_loss"]
    out["train_step_mv_ms"] = event_ms(step, reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    out["train_step_mv_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    out["train_step_mv_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["profile"] = profile_step(step)
    step_c = lambda: train_step(params, aux, adam, ref, gt, bg, lrs, cfg,
                                LossConfig(reg_on=True, mv_on=True, ncc_compact=True), **mv)
    metrics = step_c()[3]
    out["step_compact_blocks"] = metrics["mv_blocks"]
    out["step_compact_ncc_loss"] = metrics["ncc_loss"]
    out["train_step_mv_compact_ms"] = event_ms(step_c, reps=5)
    torch.cuda.reset_peak_memory_stats()
    step_c()
    torch.cuda.synchronize()
    out["train_step_mv_compact_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "timing_mv", "width": width, "height": height, "gaussians": n, **out,
          "b3_bound": b3_bound, "b5_bound": b5_bound, "b6_bound": b6_bound,
          "b6b_bound": b6b_bound})
    return out, {"sample_fwd": b3_bound, "sample_bwd": b5_bound, "warp_sample": b6_bound,
                 "warp_sample_blocks": b6b_bound}


def sphere_query(width, height, n, dev, view=0, n_views=8, pixel_order=False):
    """The tetra points of an n-gaussian sphere model (`sphere_gaussians`,
    the meshing route's input) queried in ring view `view` of `n_views` (fx =
    0.9 width, as data/synth.py writes the scene): the view's prepared pairs
    and points (sorted by tile, or with `pixel_order` as the integrate sorts
    them), the points' ray distances and the config."""
    import torch

    from gsjax_torch.core.transforms import focal2fov
    from gsjax_torch.data.synth import ring_pose, sphere_gaussians
    from gsjax_torch.mesh.extract import get_tetra_points
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.raster import Camera, RasterConfig
    from gsjax_torch.ops.sample import prepare_points, prepare_view

    params, aux = bench_params(sphere_gaussians(n, seed=0), dev)
    pts, _ = get_tetra_points(params, aux)
    r_w2c, tvec = ring_pose(view, n_views)
    cam = Camera.create(r_w2c.T, tvec, focal2fov(0.9 * width, width),
                        focal2fov(0.9 * width, height), width, height, device=dev)
    cfg = RasterConfig(require_depth=True, max_per_tile=1 << 12)
    with torch.no_grad():
        scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
        vp = prepare_view(params.xyz, scales, params.rotation, opac, cam, cfg, aux.alive)
        qr = prepare_points(vp, pts, cam, cfg, pixel_order)
    return qr, qr.t_ray[qr.sorted_q].contiguous(), cfg


def phase_parity_integrate(width, height, n, dev):
    """B4 against its twin on the same view payload and points, in the
    integrate path's pixel order; returns (summary, (query, ray distances,
    config, B4 rows))."""
    import torch

    from gsjax_torch.ops import sample_cuda, sample_ref

    qr, t_eval, cfg = sphere_query(width, height, n, dev, pixel_order=True)
    args = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts, t_eval,
            qr.blocks, cfg)
    rk = sample_cuda.integrate_fwd(*args)
    rt, twin_ms = timed_once(lambda: sample_ref.integrate_rows(*args))
    err = (rk[0] - rt[0]).abs()
    out = {"points": int(qr.pts.shape[0]), "tetra_points": int(qr.px.shape[0]),
           "blocks": int(qr.blocks.shape[0]), "pairs": qr.binning.num_live,
           "max_tile_count": qr.binning.max_tile_count, "twin_ms": twin_ms,
           "finite": bool(torch.isfinite(rk).all()),
           "covered_all": bool((rk[1] == 1).all()),
           "T_max_abs_err": float(err.max()),
           "T_close_frac": float((err <= INT_TOL).double().mean()),
           "T_gsjax_close_frac": float((err <= INT_GSJAX).double().mean()),
           "n_contrib_equal_frac": float((rk[2] == rt[2]).double().mean()),
           "t_final_max_abs_err": float((rk[4] - rt[4]).abs().max()),
           "alpha_gt_half_frac": float((rk[0] < 0.5).double().mean())}
    emit({"phase": "parity_integrate", "width": width, "height": height, "gaussians": n,
          **out})
    check(out["finite"], "B4 output not finite")
    check(out["covered_all"], "B4 left points uncovered")
    check(out["T_close_frac"] >= INT_FRAC, f"B4 T close on {out['T_close_frac']}")
    check(out["T_gsjax_close_frac"] >= FLIP_FRAC,
          f"B4 T within {INT_GSJAX} on {out['T_gsjax_close_frac']}")
    check(out["T_max_abs_err"] <= INT_MAX, f"B4 T max error {out['T_max_abs_err']}")
    check(out["n_contrib_equal_frac"] >= NCONTRIB_FRAC,
          f"B4 n_contrib equal on {out['n_contrib_equal_frac']}")
    check(0.01 < out["alpha_gt_half_frac"] < 0.99,
          f"alpha > 0.5 on {out['alpha_gt_half_frac']} of the points: no surface between")
    return out, (qr, t_eval, cfg, rk)


def phase_timing_mesh(width, height, qr, t_eval, cfg, res, tile_query):
    """B4 against its bound at the parity phase's full size, its block count
    and fill, with B3 on the same points in B3's own order (`tile_query`,
    sorted by tile); returns (B4 ms, bound)."""
    from gsjax_torch.ops import sample_cuda, sample_ref

    lists = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts)
    qt = tile_query[0]
    t_lists = (qt.feats, qt.binning.tile_start, qt.binning.tile_count, qt.pts, qt.blocks)
    nb = int(qr.blocks.shape[0])
    out = {"points": int(qr.pts.shape[0]), "b4_blocks": nb,
           "b4_block_fill": qr.pts.shape[0] / (sample_ref.BLOCK * nb),
           "b4_ms": event_ms(lambda: sample_cuda.integrate_fwd(*lists, t_eval, qr.blocks,
                                                               cfg)),
           "b3_same_points_ms": event_ms(lambda: sample_cuda.sample_fwd(*t_lists, cfg)),
           "b3_same_points_slots0_ms": event_ms(lambda: sample_cuda.sample_fwd(
               *t_lists, cfg, slots=0))}
    need = integrate_needs(qr, res, t_eval, cfg)
    ops = float(need["reach"] * OPS_ALPHA + need["applied"] * (OPS_POINT_APPLY + OPS_BAND)
                + need["near"] * OPS_DEPTH + need["warp_pairs"] * OPS_REACH)
    k, q = qr.feats.shape[0], qr.pts.shape[0]
    lists_bytes = 2 * 4 * qr.binning.tile_count.numel() + 12 * qr.blocks.shape[0]
    bound = {**roofline(k * 64 + lists_bytes + q * 12 + 5 * q * 4, ops),
             **{f"interactions_{key}": v for key, v in need.items()}}
    emit({"phase": "timing_mesh", "width": width, "height": height, **out,
          "b4_bound": bound})
    return out["b4_ms"], bound


def phase_integrate_profile(qr, t_eval, cfg, res, bound, b4_ms, tile_query):
    """Where B4's warp cycles go on the parity phase's full-size query, from
    the kernel's profile counters (`sample_cuda.integrate_stats`): blocks and
    their fill, the warps' lists, warp-pairs walked and the shares with a lane
    past the cut-off, an applying lane and a near factor, lane-pairs after
    the lane's stop, applied pairs by band and the cycle split; the profiled
    instance's time and rows beside the plain one's; and, in `tile_order`,
    B4's time and warp-pairs on the same points sorted by tile only
    (`tile_query`)."""
    import torch

    from gsjax_torch.ops import sample_cuda

    args = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts, t_eval,
            qr.blocks, cfg)
    ctr = sample_cuda.integrate_counters(qr.pts.device)
    rows = sample_cuda.integrate_fwd(*args, counters=ctr)
    st = sample_cuda.integrate_stats(ctr)
    profiled_ms = event_ms(lambda: sample_cuda.integrate_fwd(*args, counters=ctr))
    twin_applied = bound["interactions_applied"]
    qt, t_tile, _ = tile_query
    t_args = (qt.feats, qt.binning.tile_start, qt.binning.tile_count, qt.pts, t_tile,
              qt.blocks, cfg)
    sample_cuda.integrate_fwd(*t_args, counters=ctr)
    st_tile = sample_cuda.integrate_stats(ctr)
    tile_order = {"ms": event_ms(lambda: sample_cuda.integrate_fwd(*t_args)),
                  **{k: st_tile[k] for k in ("pairs_kept", "warp_pairs", "active_share",
                                             "near_share", "lanes_stopped_share")}}
    emit({"phase": "integrate_profile", "ms": b4_ms,
          "profiled_ms": profiled_ms, "applied_twin": twin_applied, **st,
          "tile_order": tile_order})
    check(torch.equal(rows, res), "B4's profiled instance gives other rows")
    check(st["blocks"] == qr.blocks.shape[0] and st["points"] == qr.pts.shape[0],
          f"B4 profile counted {st['blocks']} blocks, {st['points']} points")
    check(0 < st["warp_pairs_active"] <= st["warp_pairs_tested"] <= st["warp_pairs"],
          "B4 profile counters do not add up")
    check(abs(st["applied"] - twin_applied) <= 1e-4 * twin_applied,
          f"B4 applied {st['applied']} pairs, the twin's test {twin_applied}")
    return st


@contextlib.contextmanager
def timed_calls(module, name):
    """Installs, while active, a stand-in for wrapper `module.name` that
    records CUDA events around each call; yields the list of (start, end)
    event pairs. The stand-in's `launches` reads and writes the wrapper's
    own, so every launch is counted on the wrapper, whichever name the
    wrapper reaches itself by."""
    import torch

    fn = getattr(module, name)
    pairs = []

    class Timed:
        __name__ = fn.__name__
        launches = property(lambda self: fn.launches,
                            lambda self, v: setattr(fn, "launches", v))

        def __call__(self, *args, **kwargs):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*args, **kwargs)
            ev[1].record()
            pairs.append(ev)
            return out

    setattr(module, name, Timed())
    try:
        yield pairs
    finally:
        setattr(module, name, fn)


def _read_mesh(path):
    from gsjax_torch.data.ply import read_ply

    v = read_ply(path)
    return np.stack([v["x"], v["y"], v["z"]], 1), v["__faces__"]


def phase_mesh(dev, n_views=8, width=1920, height=1080, n=20_000, voxel=0.01):
    """Both meshing CLIs on a seeded sphere scene; returns {kernel: launches}
    over both routes."""
    import torch

    from gsjax_torch import mesh_extract as tsdf_cli
    from gsjax_torch import mesh_extract_tetrahedra as tetra_cli
    from gsjax_torch.config import dump_cfg_args
    from gsjax_torch.data.synth import ring_pose, sphere_gaussians, write_rendered_colmap
    from gsjax_torch.model.io import save_ply
    from gsjax_torch.ops import sample_cuda

    shutil.rmtree(WORK, ignore_errors=True)
    scene_dir = os.path.join(WORK, "mesh_scene")
    model_dir = os.path.join(WORK, "mesh_model")
    t0 = time.perf_counter()
    g = sphere_gaussians(n, seed=0)
    save_ply(os.path.join(model_dir, "point_cloud", "iteration_30000", "point_cloud.ply"),
             *bench_params(g, dev))
    write_rendered_colmap(scene_dir, n_images=n_views, width=width, height=height,
                          gaussians=g, pose_fn=ring_pose, max_per_tile=1 << 12, device=dev)
    dump_cfg_args(model_dir, Namespace(
        sh_degree=3, sg_degree=0, source_path=scene_dir, model_path=model_dir,
        images="images", masks="", resolution=1, white_background=False,
        eval=False, kernel_size=0.0))
    setup_s = time.perf_counter() - t0

    base = ["-s", scene_dir, "-m", model_dir, "--device", str(dev)]
    routes = {}
    total = {}
    for route, cli, argv in (("tetrahedra", tetra_cli, base),
                             ("tsdf", tsdf_cli, base + ["--voxel_size", str(voxel)])):
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with timed_calls(sample_cuda, "integrate_fwd") as b4_calls:
            meshes = cli.main(argv)
            torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        b4_s = sum(a.elapsed_time(b) for a, b in b4_calls) / 1e3
        launches = read_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        verts, faces = _read_mesh(os.path.join(model_dir, "recon_post.ply"))
        radius = np.abs(np.linalg.norm(verts, axis=1) - 1.0)
        routes[route] = {
            "cli_s": cli_s, "seconds": meshes["seconds"], "launches": launches,
            "b4_calls": len(b4_calls), "b4_device_s": b4_s, "b4_share_of_cli": b4_s / cli_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "post_vertices": int(len(verts)), "post_faces": int(len(faces)),
            "raw_faces": int(len(meshes["raw"][1])),
            "finite": bool(np.isfinite(verts).all()),
            "faces_in_range": bool(len(faces) and faces.min() >= 0
                                   and faces.max() < len(verts)),
            "radius_err_median": float(np.median(radius)) if len(verts) else None,
            "radius_err_p99": float(np.quantile(radius, 0.99)) if len(verts) else None,
            **({"counts": meshes["counts"]} if "counts" in meshes else
               {"grid": list(meshes["grid"]), "grid_voxels": int(np.prod(meshes["grid"])),
                "voxel_size": meshes["voxel_size"]})}
        del meshes
    c = routes["tetrahedra"]["counts"]
    chunks = lambda m: -(-m // MESH_CHUNK)
    want_b4 = n_views * (chunks(c["points"]) + MESH_STEPS * chunks(c["edges"]))
    emit({"phase": "mesh", "views": n_views, "width": width, "height": height,
          "gaussians": n, "setup_s": setup_s, "b4_launches_expected": want_b4, **routes})
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".ply"))
    check(files == ["recon.ply", "recon_init.ply", "recon_post.ply"], f"mesh files {files}")
    tet, tsdf = routes["tetrahedra"]["launches"], routes["tsdf"]["launches"]
    check(tet["integrate_fwd"] == want_b4 == routes["tetrahedra"]["b4_calls"],
          f"integrate_fwd launched {tet['integrate_fwd']} times, want {want_b4}")
    check(tsdf["blend_fwd"] == n_views,
          f"blend_fwd launched {tsdf['blend_fwd']} times for {n_views} views")
    others = {k: v for k, v in total.items()
              if k not in ("integrate_fwd", "blend_fwd", "preprocess_fwd")}
    check(not any(others.values()), f"other kernels launched while meshing: {others}")
    check(tsdf["preprocess_fwd"] == n_views and tet["preprocess_fwd"] >= n_views,
          f"preprocess_fwd launched {tsdf['preprocess_fwd']} (TSDF) and "
          f"{tet['preprocess_fwd']} (tetrahedra) times for {n_views} views")
    check(tet["blend_fwd"] == 0 and tsdf["integrate_fwd"] == 0,
          f"routes crossed: {tet['blend_fwd']} B1 / {tsdf['integrate_fwd']} B4")
    for route, r in routes.items():
        check(r["post_faces"] > 1000 and r["finite"] and r["faces_in_range"],
              f"{route} mesh: {r['post_faces']} faces, finite {r['finite']}")
        check(r["radius_err_median"] < MESH_RADIUS,
              f"{route} mesh off the sphere: median | |v| - 1 | {r['radius_err_median']}")
    shutil.rmtree(WORK, ignore_errors=True)
    return total


def eval_pose(i, n):
    """gsjax's golden blobs ring (scripts/golden_quality.py)."""
    from gsjax_torch.data.synth import ring_pose

    return ring_pose(i, n, **EVAL_RING)


def blobs_foreground(n):
    """The two foreground spheres of blobs_gaussians(n): the gaussians with
    |mean| <= 2.5, so the Blender scene's background is transparent."""
    from gsjax_torch.data.synth import blobs_gaussians

    g = blobs_gaussians(n)
    keep = np.linalg.norm(g[0], axis=1) <= 2.5
    return tuple(a[keep] for a in g)


def write_eval_scene(scene_dir, model_dir, g, dev):
    """The evaluate phase's NeRF-synthetic scene, rendered on the card (B1),
    and the ground-truth model of it as a PLY with its cfg_args."""
    from gsjax_torch.config import dump_cfg_args
    from gsjax_torch.data.synth import write_rendered_blender
    from gsjax_torch.model.io import save_ply

    write_rendered_blender(scene_dir, n_train=EVAL_TRAIN, n_test=EVAL_TEST, width=EVAL_SIZE,
                           height=EVAL_SIZE, fovx=EVAL_FOVX, gaussians=g, pose_fn=eval_pose,
                           max_per_tile=1 << 12, device=dev)
    save_ply(os.path.join(model_dir, "point_cloud", "iteration_30000", "point_cloud.ply"),
             *bench_params(g, dev))
    dump_cfg_args(model_dir, Namespace(
        sh_degree=3, sg_degree=0, source_path=scene_dir, model_path=model_dir,
        images="images", masks="", resolution=-1, white_background=True,
        eval=True, kernel_size=0.0))


def train_c2ws(scene_dir):
    """The Blender scene's training cameras (cam-to-world, Blender axes)."""
    with open(os.path.join(scene_dir, "transforms_train.json")) as f:
        return np.stack([np.asarray(fr["transform_matrix"]) for fr in json.load(f)["frames"]])


def random_lpips_weights(seed=0):
    """Seeded He-scaled VGG16 convs and positive LPIPS heads in the npz
    layout `gsjax_torch.eval.lpips` reads."""
    from gsjax_torch.eval.lpips import _TV_CONV_IDX, _VGG_CFG, convert_state_dicts

    rng = np.random.default_rng(seed)
    widths = [c for c in _VGG_CFG if c != "M"]
    sd = {}
    for idx, cin, cout in zip(_TV_CONV_IDX, [3] + widths[:-1], widths):
        sd[f"features.{idx}.weight"] = (rng.normal(0, 1, (cout, cin, 3, 3))
                                        * np.sqrt(2 / (9 * cin))).astype(np.float32)
        sd[f"features.{idx}.bias"] = rng.normal(0, 0.01, cout).astype(np.float32)
    heads = [widths[i] for i in (1, 3, 6, 9, 12)]
    return convert_state_dicts(sd, [rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32)
                                    for c in heads])


def phase_evaluate(dev):
    """gsjax's evaluation path through the port's CLIs on a Blender scene:
    train, render (with a flythrough), metric, TSDF mesh, the DTU and TnT
    evaluators; returns {kernel: launches} over the path's stages."""
    import torch

    from gsjax_torch import eval_tnt as tnt_cli
    from gsjax_torch import evaluate_dtu_mesh as dtu_cli
    from gsjax_torch import mesh_extract as tsdf_cli
    from gsjax_torch import metric as metric_cli
    from gsjax_torch import render as render_cli
    from gsjax_torch import train as train_cli
    from gsjax_torch.data.readers import load_scene
    from gsjax_torch.data.synth import (blobs_surface_distance, blobs_surface_samples,
                                        write_synthetic_dtu, write_synthetic_tnt,
                                        write_trajectory_log)
    from gsjax_torch.eval import dtu as dtu_lib
    from gsjax_torch.eval import lpips as lpips_lib
    from gsjax_torch.metric import read_dir
    from gsjax_torch.train.loop import Trainer

    shutil.rmtree(WORK, ignore_errors=True)
    scene_dir = os.path.join(WORK, "blender")
    gt_dir = os.path.join(WORK, "gt_model")
    train_dir = os.path.join(WORK, "train_model")
    g = blobs_foreground(EVAL_GAUSSIANS)
    t0 = time.perf_counter()
    write_eval_scene(scene_dir, gt_dir, g, dev)
    seconds = {"setup": time.perf_counter() - t0}
    launches, total = {}, {}
    checks = {}

    @contextlib.contextmanager
    def stage(name):
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        launches[name] = read_launches()
        for k, v in launches[name].items():
            total[k] = total.get(k, 0) + v

    # 1. train from the reader's random points, multi-view from step 21. The
    # step losses move with the view drawn and the terms added at step 21, so
    # learning is read on fixed views, as in the train phase: the photometric
    # loss over the training views at initialisation and after the last step.
    # The first read of the scene writes points3d.ply; the CLI reads it back
    # (8-bit colours, ROADMAP queue C), and so does the model read here.
    load_scene(scene_dir, eval_split=True, white_background=True, device=dev)
    initial = Trainer.create(load_scene(scene_dir, eval_split=True, white_background=True,
                                        device=dev), None, train_dir, dev,
                             white_background=True)
    loss_before = views_loss(initial)
    del initial
    log = []
    with stage("train"):
        trainer = train_cli.main(
            ["-s", scene_dir, "-m", train_dir, "--eval", "-w",
             "--iterations", str(EVAL_STEPS), "--densify_from_iter", "10",
             "--densification_interval", "10", "--densify_until_iter", "10",
             "--regularization_from_iter", "21", "--save_iterations", str(EVAL_STEPS),
             "--device", str(dev)],
            on_step=lambda t, m: log.append((m["loss"], m["near"] is not None,
                                             int(t.aux.alive.sum()))))
    mv_steps = sum(mv for _, mv, _ in log)
    checks["train"] = {
        "steps": len(log), "mv_steps": mv_steps, "init_points": int(len(trainer.scene.points)),
        "views": [len(trainer.scene.train_views), len(trainer.scene.test_views)],
        "loss_first": log[0][0], "loss_last": log[-1][0], "alive_last": log[-1][2],
        "views_loss_before": loss_before, "views_loss_after": views_loss(trainer)}
    del trainer

    # 2. render the ground-truth model: train, test and a flythrough
    try:
        import cv2  # noqa: F401
        video = True
    except ImportError:
        video = False
    argv = ["-m", gt_dir, "--eval", "-w", "--traj_frames", str(EVAL_TRAJ), "--save_depth",
            "--device", str(dev)]
    with stage("render"):
        render_cli.main(argv + (["--video"] if video else []))
    out = os.path.join(gt_dir, "{}", "ours_30000", "{}")
    frames = {s: {k: len(os.listdir(out.format(s, k))) for k in ("renders", "gt", "depth")}
              for s in ("train", "test", "traj")}
    videos = sorted(f for f in os.listdir(gt_dir) if f.endswith(".mp4"))
    if not video:
        try:
            render_cli.main(argv + ["--video", "--skip_train", "--skip_test"])
            raised = None
        except RuntimeError as e:
            raised = str(e)
        videos = raised
    checks["render"] = {"frames": frames, "cv2": video, "videos": videos}

    # 3. metrics of the ground-truth model's test renders; LPIPS on the card
    # against the CPU on two test views with random weights
    with stage("metric"):
        metric = metric_cli.main(["-m", gt_dir, "--device", str(dev)])[gt_dir]["ours_30000"]
    _, gts = read_dir(out.format("test", "gt"))
    weights = random_lpips_weights()
    t = time.perf_counter()
    lp_card = lpips_lib.lpips(torch.as_tensor(gts[0], device=dev),
                              torch.as_tensor(gts[1], device=dev), weights)
    lp_card_s = time.perf_counter() - t
    t = time.perf_counter()
    lp_cpu = lpips_lib.lpips(gts[0], gts[1], weights)
    lp_cpu_s = time.perf_counter() - t
    checks["metric"] = {**metric, "lpips_random_card": lp_card, "lpips_random_cpu": lp_cpu,
                        "lpips_rel_err": abs(lp_card - lp_cpu) / abs(lp_cpu),
                        "lpips_card_s": lp_card_s, "lpips_cpu_s": lp_cpu_s}

    # 4. the TSDF mesh of the ground-truth model
    with stage("mesh"):
        tsdf_cli.main(["-m", gt_dir, "--voxel_size", str(EVAL_VOXEL), "--num_cluster", "2",
                       "--device", str(dev)])
    verts, faces = _read_mesh(os.path.join(gt_dir, "recon_post.ply"))
    dist = blobs_surface_distance(verts)
    checks["mesh"] = {"vertices": int(len(verts)), "faces": int(len(faces)),
                      "dist_median": float(np.median(dist)),
                      "dist_p90": float(np.quantile(dist, 0.9))}

    # 5. DTU: the surface under a known similarity; the CLI aligns the train
    # cameras to the first calibration centres and runs the chamfer protocol
    samples = blobs_surface_samples(EVAL_SAMPLES)
    rng = np.random.default_rng(0)
    rot, _ = np.linalg.qr(rng.normal(0, 1, (3, 3)))
    rot *= np.sign(np.linalg.det(rot))
    c2ws = train_c2ws(scene_dir)
    dtu_dir = os.path.join(WORK, "dtu")
    t = time.perf_counter()
    write_synthetic_dtu(dtu_dir, 24, c2ws[:, :3, 3], samples, EVAL_DTU_SCALE, rot,
                        rng.normal(0, 100, 3))
    seconds["dtu_files"] = time.perf_counter() - t
    with stage("dtu"):
        res = dtu_cli.main(["-s", scene_dir, "-m", gt_dir, "--DTU", dtu_dir, "--scan_id", "24",
                            "--device", str(dev)])
    # the protocol's greedy downsample alone, on the CLI's aligned mesh
    pts = dtu_lib.sample_mesh_points(*_read_mesh(os.path.join(gt_dir, "recon_aligned.ply")))
    t = time.perf_counter()
    kept = len(dtu_lib.radius_downsample(pts))
    down = {"in": len(pts), "out": kept, "seconds": time.perf_counter() - t}
    checks["dtu"] = {**res, "scale_rel_err": abs(res["scale"] / EVAL_DTU_SCALE - 1),
                     "downsample": down}

    # 6. TnT: the same samples, an axis-aligned crop, identity _trans.txt and
    # the train cameras as both trajectories
    tnt_dir = os.path.join(WORK, "tnt", "blobs")
    write_synthetic_tnt(tnt_dir, "blobs", samples, c2ws, lo=(-1.3, -1.3, -1.3),
                        hi=(2.3, 1.3, 1.3))
    traj = os.path.join(WORK, "tnt", "recon.log")
    write_trajectory_log(traj, c2ws)
    tnt_out = os.path.join(WORK, "tnt", "out")
    with stage("tnt"):
        tnt = tnt_cli.main(["--dataset-dir", tnt_dir, "--traj-path", traj, "--ply-path",
                            os.path.join(gt_dir, "recon_post.ply"), "--out-dir", tnt_out])
    with open(os.path.join(tnt_out, "results.json")) as f:
        tnt_json = json.load(f)
    checks["tnt"] = {**tnt, "files": sorted(os.listdir(tnt_out))}

    emit({"phase": "evaluate", "size": EVAL_SIZE, "views": [EVAL_TRAIN, EVAL_TEST],
          "traj_frames": EVAL_TRAJ, "gaussians": int(len(g[0])), "seconds": seconds,
          "launches": launches, **checks})
    n_views = EVAL_TRAIN + EVAL_TEST + EVAL_TRAJ
    tr, rd, ms = launches["train"], launches["render"], launches["mesh"]
    check(len(log) == EVAL_STEPS and all(np.isfinite(x) for x, _, _ in log),
          f"train ran {len(log)} steps with finite losses")
    check(checks["train"]["views_loss_after"] < loss_before,
          f"loss did not fall: {loss_before} -> {checks['train']['views_loss_after']}")
    check(checks["train"]["init_points"] == EVAL_INIT_POINTS and checks["train"]["views"] == [
        EVAL_TRAIN, EVAL_TEST], f"Blender scene read as {checks['train']}")
    check(tr["blend_bwd"] == EVAL_STEPS, f"blend_bwd launched {tr['blend_bwd']} times")
    check(mv_steps >= 5 and tr["sample_fwd"] == tr["sample_bwd"] == tr["warp_sample"]
          == mv_steps, f"multi-view launches {tr} for {mv_steps} steps")
    check(rd["blend_fwd"] == rd["preprocess_fwd"] == n_views and not any(
        v for k, v in rd.items() if k not in ("blend_fwd", "preprocess_fwd")),
          f"render launches {rd} for {n_views} views")
    check(frames == {"train": dict.fromkeys(("renders", "gt", "depth"), EVAL_TRAIN),
                     "test": dict.fromkeys(("renders", "gt", "depth"), EVAL_TEST),
                     "traj": dict.fromkeys(("renders", "gt", "depth"), EVAL_TRAJ)},
          f"frames {frames}")
    check(videos == [f"traj_30000_{k}.mp4" for k in ("depth", "gt", "renders")] if video
          else bool(videos and "cv2" in videos), f"--video: {videos}")
    check(metric["PSNR"] > EVAL_PSNR, f"test PSNR {metric['PSNR']}")
    check(metric["LPIPS"] is None and metric["LPIPS_status"] == "weights unavailable",
          f"LPIPS {metric['LPIPS']} ({metric['LPIPS_status']})")
    check(checks["metric"]["lpips_rel_err"] < EVAL_LPIPS_RTOL,
          f"LPIPS card {lp_card} against CPU {lp_cpu}")
    check(not any(launches["metric"].values()), f"metric launched {launches['metric']}")
    check(ms["blend_fwd"] == EVAL_TRAIN, f"mesh launches {ms}")
    check(checks["mesh"]["dist_median"] < EVAL_MESH_DIST,
          f"mesh off the spheres: median {checks['mesh']['dist_median']}")
    check(checks["dtu"]["scale_rel_err"] < EVAL_SCALE_RTOL and np.isfinite(res["overall"]),
          f"DTU alignment scale {res['scale']}, overall {res['overall']}")
    check(tnt["f1"] > EVAL_F1 and tnt_json == tnt, f"TnT F1 {tnt['f1']} at tau {tnt['tau']}")
    shutil.rmtree(WORK, ignore_errors=True)
    return total


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def write_train_scene(dev, n_views=6, width=1920, height=1080, n=100_000):
    """The `train` phase's scene under WORK: 6 arc views at 1920x1080 of
    bench.py's 100k gaussians, whose centres are the sparse points."""
    from gsjax_torch.data.synth import write_rendered_colmap

    scene_dir = os.path.join(WORK, "train_scene")
    write_rendered_colmap(scene_dir, n_images=n_views, width=width, height=height,
                          gaussians=bench_inputs(width, height, n)[:5], pose_fn=bench_pose,
                          max_per_tile=1 << 12, points_stride=1, device=dev)
    return scene_dir


def initial_trainer(scene_dir, model_dir, dev, eval_split=False):
    """The model the train CLI starts from (Trainer.create is deterministic),
    with gsjax's default optimisation flags."""
    from gsjax_torch.config import OptimizationParams
    from gsjax_torch.data.readers import load_scene
    from gsjax_torch.train.loop import Trainer

    opt = Namespace(**OptimizationParams._defaults())
    return Trainer.create(load_scene(scene_dir, eval_split=eval_split, device=dev), opt,
                          model_dir, dev)


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def sibr_request(conn, msg):
    """One SIBR exchange on a client socket -> (uint8 [h, w, 3], verify, s)."""
    t0 = time.perf_counter()
    payload = json.dumps(msg).encode("utf-8")
    conn.sendall(len(payload).to_bytes(4, "little") + payload)
    w, h = msg["resolution_x"], msg["resolution_y"]

    def exact(n):
        buf = bytearray()
        while len(buf) < n:
            chunk = conn.recv(min(n - len(buf), 1 << 22))
            check(chunk, "the trainer closed the viewer socket")
            buf += chunk
        return bytes(buf)

    rgb = np.frombuffer(exact(w * h * 3), np.uint8).reshape(h, w, 3)
    verify = exact(int.from_bytes(exact(4), "little")).decode()
    return rgb, verify, time.perf_counter() - t0


def phase_viewer(dev, scene_dir, n=100_000, web_size=(WEB_W, WEB_H)):
    """The live viewers at 1920x1080 on the `train` scene (100k gaussians):
    the train CLI's SIBR server with a Python client, the native client and
    the web viewer's bridge on `serve_viewer` over a trainer of the same
    scene, and the web viewer's local mode on a 100k-gaussian PLY; returns
    {kernel: launches}."""
    import socket
    import threading

    import torch

    from gsjax_torch import train as train_cli
    from gsjax_torch.config import dump_cfg_args
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.model.io import save_ply
    from gsjax_torch.ops.raster import render
    from gsjax_torch.ops.raster.camera import Camera
    from gsjax_torch.train.loop import serve_viewer
    from gsjax_torch.viewer import client as native
    from gsjax_torch.viewer.network_gui import NetworkGUI
    from gsjax_torch.viewer.web import LocalModel, SIBRBridge, WebViewer, encode_wire_message

    model_dir = os.path.join(WORK, "viewer_model")
    launches = {}

    # -- the SIBR server of a training run, a Python client ------------------
    initial = initial_trainer(scene_dir, model_dir, dev)
    cam0 = initial.scene.train_views[0].camera
    width, height = VIEW_W, VIEW_H
    fovx, fovy = (2 * float(np.arctan(t)) for t in (cam0.tan_fovx, cam0.tan_fovy))
    wv, fp = cam0.world_view.cpu().numpy(), cam0.full_proj.cpu().numpy()
    paused = encode_wire_message(wv, fp, width, height, fovx, fovy, train=False,
                                 keep_alive=True)
    release = dict(paused, train=True, keep_alive=False)
    port = free_port()
    log, client = [], {}

    def python_client():
        try:
            deadline = time.time() + 300
            while True:
                try:
                    conn = socket.create_connection(("127.0.0.1", port), timeout=1)
                    break
                except OSError:
                    check(time.time() < deadline, "the train CLI's viewer server never listened")
                    time.sleep(0.005)
            conn.settimeout(300)
            with conn:
                frames = [sibr_request(conn, paused) for _ in range(VIEWER_PAUSED)]
                client["steps_before_release"] = len(log)
                frames.append(sibr_request(conn, release))
            client["frames"] = frames
        except Exception as e:          # reported by the check below
            client["error"] = f"{type(e).__name__}: {e}"

    thread = threading.Thread(target=python_client, daemon=True)
    reset_launches()
    thread.start()
    t0 = time.perf_counter()
    train_cli.main(["-s", scene_dir, "-m", model_dir, "--iterations", str(VIEWER_STEPS),
                    "--save_iterations", str(VIEWER_STEPS), "--ip", "127.0.0.1",
                    "--port", str(port), "--device", str(dev)],
                   on_step=lambda t, m: log.append(m["attempts"]))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    thread.join(60)
    counts = read_launches()
    add_counts(launches, counts)
    check(not thread.is_alive() and "frames" in client,
          f"the SIBR client did not finish: {client.get('error')}")
    frames = client["frames"]
    served = len(frames)
    frame_ms = [f[2] * 1e3 for f in frames]

    # the same camera on the same initial model: the kernel's frame and the
    # twin's (outside the counted run)
    cam = Camera.from_matrices(width, height, fovx, fovy, wv, fp, device=dev)
    outs = {}
    for backend in ("cuda", "torch"):
        cfg = dataclasses.replace(initial.raster_cfg(require_depth=False), backend=backend)
        scales, opac = gm.scaling_n_opacity_with_3d_filter(initial.params, initial.aux.filter_3d)
        with torch.no_grad():
            outs[backend] = render(initial.params.xyz, scales, initial.params.rotation, opac,
                                   gm.get_features(initial.params), cam, cfg, initial.bg(),
                                   sg_axis=gm.get_sg_axis(initial.params),
                                   sg_sharpness=gm.get_sg_sharpness(initial.params),
                                   sg_color=initial.params.sg_color, alive=initial.aux.alive)
    want = (torch.clamp(outs["cuda"]["render"], 0, 1) * 255).to(torch.uint8).cpu().numpy()
    diff = (outs["cuda"]["render"] - outs["torch"]["render"]).abs().amax(-1)
    twin_close = float((diff <= TOL_COLOR).float().mean())
    twin_max = float(diff.max())

    # -- the native client (python -m gsjax_torch.viewer.client) -------------
    t0 = time.perf_counter()
    exe = native.client_path()
    build_s = time.perf_counter() - t0
    prefix = os.path.join(WORK, "orbit")
    gui = NetworkGUI("127.0.0.1", free_port())
    proc = subprocess.Popen(
        [sys.executable, "-m", "gsjax_torch.viewer.client", "127.0.0.1",
         str(gui.listener.getsockname()[1]), "--width", str(width), "--height", str(height),
         "--frames", str(NATIVE_FRAMES), "--out_prefix", prefix],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while gui.conn is None and proc.poll() is None and time.time() < deadline:
            gui.try_connect()
            time.sleep(0.005)
        check(gui.conn is not None, "the native client never connected")
        reset_launches()
        native_attempts = 0
        for _ in range(NATIVE_FRAMES):      # the train loop's order: serve, step
            serve_viewer(gui, initial, scene_dir, VIEWER_STEPS + NATIVE_FRAMES)
            native_attempts += initial.step()["attempts"]
        torch.cuda.synchronize()
        native_counts = read_launches()
        add_counts(launches, native_counts)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        gui.close()
    ppms = sorted(p for p in os.listdir(WORK) if p.startswith("orbit_"))
    ppm_ok = []
    for p in ppms:
        with open(os.path.join(WORK, p), "rb") as f:
            head = [f.readline().split() for _ in range(3)]
            body = len(f.read())
        ppm_ok.append(head == [[b"P6"], [str(width).encode(), str(height).encode()], [b"255"]]
                      and body == width * height * 3)

    # -- the web viewer's bridge to a training run's server ------------------
    gui = NetworkGUI("127.0.0.1", free_port())
    bridge = SIBRBridge("127.0.0.1", gui.listener.getsockname()[1])
    web = WebViewer(bridge, "127.0.0.1", 0).start()
    bridge_reply = {}

    def post_bridge():
        bridge_reply["r"] = http_frame(web, dict(
            yaw=0.0, pitch=0.0, radius=5.0, target=[0.0, 0.0, 5.0], fovx=1.0,
            width=width, height=height))

    post = threading.Thread(target=post_bridge, daemon=True)
    try:
        post.start()
        reset_launches()
        serve_viewer(gui, initial, scene_dir, VIEWER_STEPS + NATIVE_FRAMES + 1)
        initial.step()
        torch.cuda.synchronize()
        bridge_counts = read_launches()
        add_counts(launches, bridge_counts)
        post.join(120)
    finally:
        web.stop()
        bridge.close()
        gui.close()
    check("r" in bridge_reply, "the bridge's frame never came")
    b_status, b_w, b_h, b_verify, b_rgb, _ = bridge_reply["r"]
    del initial

    # -- the web viewer's local mode on a 100k-gaussian PLY ------------------
    ply_dir = os.path.join(WORK, "web_model")
    save_ply(os.path.join(ply_dir, "point_cloud", "iteration_30000", "point_cloud.ply"),
             *bench_params(bench_inputs(VIEW_W, VIEW_H, n)[:5], dev))
    dump_cfg_args(ply_dir, Namespace(sh_degree=3, sg_degree=0, kernel_size=0.0,
                                     white_background=False))
    model = LocalModel(ply_dir, device=dev)
    web_w, web_h = web_size
    req = dict(yaw=0.15, pitch=0.1, radius=5.5, target=[0.0, 0.0, 5.0], fovx=1.0,
               width=web_w, height=web_h, scaling_modifier=1.0)
    web = WebViewer(model, "127.0.0.1", 0).start()
    try:
        for _ in range(2):                  # warm-up
            http_frame(web, req)
        torch.cuda.synchronize()
        reset_launches()
        replies = [http_frame(web, req) for _ in range(WEB_FRAMES)]
        torch.cuda.synchronize()
        web_counts = read_launches()
        add_counts(launches, web_counts)
    finally:
        web.stop()
    provider_ms = []                        # LocalModel.frame alone, no HTTP
    for _ in range(WEB_FRAMES):
        t0 = time.perf_counter()
        model.frame(req)
        provider_ms.append((time.perf_counter() - t0) * 1e3)
    wcam, ww, wh = model.camera(req)
    p, aux = model.params, model.aux
    with torch.no_grad():
        scales, opac = gm.scaling_n_opacity_with_3d_filter(p, aux.filter_3d)
        web_render = lambda: render(p.xyz, scales, p.rotation, opac, gm.get_features(p),
                                    wcam, model.cfg, model.bg, sg_axis=gm.get_sg_axis(p),
                                    sg_sharpness=gm.get_sg_sharpness(p),
                                    sg_color=p.sg_color, alive=aux.alive)
        web_want = (torch.clamp(web_render()["render"], 0, 1) * 255 + 0.5).to(
            torch.uint8).cpu().numpy().tobytes()
        render_ms = event_ms(web_render)
    lat = sorted(r[5] * 1e3 for r in replies)

    emit({"phase": "viewer", "width": width, "height": height, "gaussians": n,
          "sibr": {"steps": len(log), "attempts": sum(log), "frames_served": served,
                   "cli_s": cli_s, "steps_before_release": client["steps_before_release"],
                   "frame_ms": frame_ms,
                   "paused_frame_ms_median": float(np.median(frame_ms[1:-1])),
                   "verify": frames[0][1], "launches": counts,
                   "bit_equal_to_render": bool(np.array_equal(frames[0][0], want)),
                   "paused_frames_equal": all(np.array_equal(f[0], frames[0][0])
                                              for f in frames[:-1]),
                   "twin_color_close_frac": twin_close, "twin_color_max_abs_err": twin_max},
          "native": {"build_s": build_s, "rc": proc.returncode, "ppms": len(ppms),
                     "ppm_ok": all(ppm_ok), "stdout_lines": out.count("\n"),
                     "stderr": err[-300:], "launches": native_counts},
          "bridge": {"status": b_status, "size": [b_w, b_h], "verify": b_verify,
                     "bytes": len(b_rgb), "launches": bridge_counts},
          "web_local": {"frames": WEB_FRAMES, "size": [ww, wh], "verify": model.verify,
                        "latency_ms_median": float(np.median(lat)),
                        "latency_ms_p90": float(np.percentile(lat, 90)),
                        "latency_ms": lat, "render_ms": render_ms,
                        "frame_call_ms_median": float(np.median(provider_ms)),
                        "launches": web_counts}})
    check(frames[0][1] == scene_dir, f"verify string {frames[0][1]!r}")
    check(client["steps_before_release"] == 0, "the client connected after step 1")
    check(np.array_equal(frames[0][0], want),
          "the served frame differs from render() of the starting model")
    check(all(np.array_equal(f[0], frames[0][0]) for f in frames[:-1]),
          "paused frames differ")
    check(twin_close >= FLIP_FRAC and twin_max <= TOL_FLIP,
          f"served frame's render against the twin: {twin_close} within {TOL_COLOR}, "
          f"max {twin_max}")
    check(len(log) == VIEWER_STEPS, f"{len(log)} steps run")
    check(counts["blend_fwd"] == sum(log) + served,
          f"blend_fwd launched {counts['blend_fwd']} times for {sum(log)} step renders "
          f"and {served} frames")
    check(counts["blend_bwd"] == VIEWER_STEPS, f"blend_bwd launched {counts['blend_bwd']}")
    check(proc.returncode == 0 and len(ppms) == NATIVE_FRAMES and all(ppm_ok),
          f"native client rc {proc.returncode}, {len(ppms)} PPMs, {ppm_ok}: {err[-300:]}")
    check(out.count(f"(scene: {scene_dir})") == NATIVE_FRAMES, "native client's verify")
    check(native_counts["blend_fwd"] == NATIVE_FRAMES + native_attempts,
          f"blend_fwd launched {native_counts['blend_fwd']} times for {NATIVE_FRAMES} "
          f"native frames and {native_attempts} step renders")
    check(b_status == 200 and (b_w, b_h) == (str(width), str(height))
          and b_verify == scene_dir and len(b_rgb) == width * height * 3,
          f"bridge frame {b_status} {b_w}x{b_h} {b_verify!r} {len(b_rgb)} bytes")
    check(all(r[0] == 200 and (r[1], r[2]) == (str(web_w), str(web_h))
              and r[3] == model.verify and len(r[4]) == web_w * web_h * 3 for r in replies),
          "a local-mode frame has the wrong size or verify string")
    check(web_counts["blend_fwd"] == WEB_FRAMES,
          f"blend_fwd launched {web_counts['blend_fwd']} times for {WEB_FRAMES} web frames")
    check(replies[0][4] == web_want, "a local-mode frame differs from render()")
    return launches


def http_frame(web, req):
    """POST /frame -> (status, X-Width, X-Height, X-Verify, body, seconds)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", web.httpd.server_address[1], timeout=120)
    try:
        conn.request("POST", "/frame", body=json.dumps(req))
        r = conn.getresponse()
        body = r.read()
    finally:
        conn.close()
    return (r.status, r.getheader("X-Width"), r.getheader("X-Height"),
            r.getheader("X-Verify"), body, time.perf_counter() - t0)


def tensorboard_imports():
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
    except ImportError:
        return False
    return True


def phase_diagnostics(dev, scene_dir):
    """The training loop's diagnostics on the `train` scene at 1920x1080 /
    100k: the NaN probe, the blow-up snapshot and their replay, the probe's
    cost per step, and one CLI run of five steps (195 -> 200) with
    --profile_iter, --debug and TensorBoard; returns {kernel: launches}."""
    import io

    import torch

    from gsjax_torch import nan_hunt
    from gsjax_torch import train as train_cli
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.model.io import save_checkpoint
    from gsjax_torch.train.step import nonfinite_count

    launches = {}
    base = initial_trainer(scene_dir, os.path.join(WORK, "diag_base"), dev, eval_split=True)
    p, aux = base.params, base.aux

    # -- the probe and the snapshot: a NaN DC colour on the nearest gaussian
    # in each training view's frame (a deep one is hidden behind others) --
    poisoned = os.path.join(WORK, "poisoned.npz")
    dc = p.features_dc.detach().clone()
    with torch.no_grad():
        for v in base.scene.train_views:
            cam = v.camera
            pc = p.xyz @ cam.world_view[:3, :3].T + cam.world_view[:3, 3]
            z = pc[:, 2]
            u = cam.fx * pc[:, 0] / z + cam.cx
            w = cam.fy * pc[:, 1] / z + cam.cy
            seen = aux.alive & (z > 0.2) & (u >= 0) & (u < v.width) & (w >= 0) & (w < v.height)
            p.features_dc[int(torch.where(seen, z, torch.full_like(z, float("inf"))).argmin())] = \
                float("nan")
    save_checkpoint(poisoned, p, aux, gm.adam_init(p), 0)
    with torch.no_grad():
        p.features_dc.copy_(dc)
    probe_dir = os.path.join(WORK, "probe_model")
    printed = io.StringIO()
    os.environ["GSJAX_NAN_PROBE"] = "1"
    reset_launches()
    try:
        with contextlib.redirect_stdout(printed):
            train_cli.main(["-s", scene_dir, "-m", probe_dir, "--iterations", "3", "--eval",
                            "--start_checkpoint", poisoned, "--ip", "", "--device", str(dev)])
        raised = None
    except FloatingPointError as e:     # the outcome the phase requires
        raised = str(e)
    finally:
        os.environ.pop("GSJAX_NAN_PROBE", None)
    torch.cuda.synchronize()
    add_counts(launches, read_launches())
    text = printed.getvalue()
    print(text, end="", flush=True)
    dump = os.path.join(probe_dir, "nan_probe_it1.npz")
    snap = os.path.join(probe_dir, "snapshot_it1.npz")
    probe_line = next((ln for ln in text.splitlines() if ln.startswith("NAN_PROBE:")), "")
    probe_fields = sorted(json.loads(probe_line.split("(counts ")[1].split(")")[0]
                                     .replace("'", '"')).items()) if probe_line else []
    probe_bad = sorted(k for k, v in probe_fields if v)
    want_keys = sorted([f"{t}.{k}" for t in ("params", "adam_mu", "adam_nu")
                        for k in gm.PARAM_FIELDS] + [f"aux.{k}" for k in gm.AUX_FIELDS]
                       + ["adam.count", "view_uid", "near_uid", "iteration", "active_sh",
                          "active_sg"])
    dump_keys = sorted(np.load(dump).files) if os.path.exists(dump) else []

    # nan_hunt on the card: the counts, then the anomaly-mode replay
    t0 = time.perf_counter()
    hunt = subprocess.run([sys.executable, "-m", "gsjax_torch.nan_hunt", dump, "--scene_dir",
                           scene_dir, "--no_debug_nans", "--device", str(dev)], cwd=ROOT,
                          capture_output=True,
                          text=True, timeout=600)
    hunt_s = time.perf_counter() - t0
    hunt_line = next((ln for ln in hunt.stdout.splitlines()
                      if ln.startswith("replay non-finite counts:")), "")
    hunt_bad = sorted(json.loads(hunt_line.split(":", 1)[1].strip().replace("'", '"'))) \
        if hunt_line else []
    anomaly = ""
    try:
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            nan_hunt.main([dump, "--scene_dir", scene_dir, "--device", str(dev)])
    except RuntimeError as e:           # detect_anomaly names the op: required
        anomaly = str(e)

    # -- the probe's cost per step, on a clean model, in turns ----------------
    for _ in range(2):
        base.step()
    times = {False: [], True: []}
    for _ in range(PROBE_TURNS):
        for on in (False, True):
            base.nan_probe = on
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = base.step()
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t0) * 1e3)
            check(("nonfinite" in m) == on and not any(
                v for d in m.get("nonfinite", {}).values() for v in d.values()),
                "the clean model's step reports non-finite values")
    check(base._nan_dumps == 0, "the clean model was dumped")

    def probe_work():
        """What the probe adds to a step, alone: the copy of the pre-step
        state and the 18 non-finite counts (the step reads them in its one
        host read, so no sync is added here)."""
        base.state_copy()
        tensors = [getattr(base.params, k) for k in gm.PARAM_FIELDS] * 2
        torch.stack([nonfinite_count(t, base.aux.alive).float() for t in tensors])

    probe_work_ms = event_ms(probe_work)

    # -- --profile_iter, --debug, TensorBoard: steps 196-200 -----------------
    c195 = os.path.join(WORK, "c195.npz")
    fresh = initial_trainer(scene_dir, os.path.join(WORK, "diag_base"), dev, eval_split=True)
    save_checkpoint(c195, fresh.params, fresh.aux, fresh.adam, 195)
    del fresh, base
    diag_dir = os.path.join(WORK, "diag_model")
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main(["-s", scene_dir, "-m", diag_dir, "--iterations", "200", "--eval",
                              "--start_checkpoint", c195, "--profile_iter", "196", "--debug",
                              "--regularization_from_iter", "200", "--ip", "",
                              "--device", str(dev)])
    torch.cuda.synchronize()
    diag_s = time.perf_counter() - t0
    diag_counts = read_launches()
    add_counts(launches, diag_counts)
    with open(os.path.join(diag_dir, "profile", "trace_it196.json")) as f:
        events = json.load(f)["traceEvents"]
    # the step's own span: an op-scope profiler range (utils/spans.py)
    spans = sorted(e["name"] for e in events if e.get("cat") == "cpu_op"
                   and e["name"].startswith("train_step"))
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    b1_events = sum("blend_fwd_kernel" in k for k in kernels)
    b2_events = sum("blend_bwd_kernel" in k for k in kernels)
    from PIL import Image

    dbg = os.path.join(diag_dir, "debug")
    mosaics = sorted(os.listdir(dbg)) if os.path.isdir(dbg) else []
    sizes = []
    for name in mosaics:
        with Image.open(os.path.join(dbg, name)) as im:
            sizes.append(list(im.size))
    tb = tensorboard_imports()
    tags = []
    if tb:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(diag_dir)
        acc.Reload()
        tags = sorted(acc.Tags()["scalars"])
    event_files = [f for f in os.listdir(diag_dir) if f.startswith("events.out.tfevents")]
    v0 = trainer.scene.train_views[0]

    emit({"phase": "diagnostics", "width": v0.width, "height": v0.height,
          "gaussians": int(trainer.aux.alive.sum()),
          "probe": {"raised": raised, "probe_line": probe_line[:400], "nonfinite": probe_bad,
                    "dump_keys_match": dump_keys == want_keys, "snapshot": os.path.exists(snap),
                    "launches": {k: v for k, v in launches.items()}},
          "nan_hunt": {"rc": hunt.returncode, "seconds": hunt_s, "counts_line": hunt_line,
                       "nonfinite": hunt_bad, "stderr": hunt.stderr[-300:],
                       "anomaly": anomaly[:300]},
          "probe_cost": {"turns": PROBE_TURNS, "step_ms_off": times[False],
                         "step_ms_on": times[True],
                         "median_ms_off": float(np.median(times[False])),
                         "median_ms_on": float(np.median(times[True])),
                         "probe_work_ms": probe_work_ms},
          "profile": {"spans": spans, "kernel_events": len(kernels),
                      "blend_fwd_kernel_events": b1_events,
                      "blend_bwd_kernel_events": b2_events},
          "debug": {"mosaics": mosaics, "sizes": sizes},
          "tensorboard": {"imports": tb, "scalar_tags": tags, "event_files": len(event_files)},
          "cli_s": diag_s, "launches": diag_counts})
    check(raised is not None and snap in raised and os.path.exists(snap),
          f"the poisoned run did not raise FloatingPointError naming {snap}: {raised}")
    check(probe_line and dump_keys == want_keys, f"probe dump keys {dump_keys}")
    check(hunt.returncode == 0 and hunt_bad and hunt_bad == probe_bad,
          f"nan_hunt counts {hunt_bad} against the probe's {probe_bad}: {hunt.stderr[-300:]}")
    check("returned nan values" in anomaly, f"anomaly mode: {anomaly[:300]}")
    check(spans == [f"train_step {i}" for i in range(196, 201)], f"trace spans {spans}")
    check(b1_events >= 5 and b2_events >= 5,
          f"trace holds {b1_events} B1 and {b2_events} B2 kernel events")
    check(trainer.iteration == 200 and sizes == [[2 * v0.width, 2 * v0.height]],
          f"debug mosaics {mosaics} {sizes}")
    if tb:
        check(tags == sorted(TB_TAGS), f"TensorBoard scalar tags {tags}")
    else:
        check(not event_files, "an event file without tensorboard")
    check(diag_counts["blend_bwd"] == 5, f"blend_bwd launched {diag_counts['blend_bwd']}")
    return launches


def profile_step(step):
    """torch.profiler over one step: the device's busy time (the union of its
    kernels' intervals), the step's span on the host clock, the idle share,
    and the ten kernels with the most device time. Returns "not measured"
    with the reason where the profiler records no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gsjax_torch import trace_reg

    try:
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            return {"status": "not measured", "error": "no kernel in the trace"}
        busy_ms = trace_reg.union_ms((e.time_range.start, e.time_range.end) for e in kernels)
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernels": len(kernels),
                "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
                "top": [{"name": k[:80], "ms": ms} for k, ms in top]}
    except Exception as e:        # a measurement, not a kernel: report, go on
        return {"status": "not measured", "error": f"{type(e).__name__}: {e}"[:300]}


# --- multi_gpu: tile rows over ranks ----------------------------------------

def band_slices(full, rows, height, tile):
    """The band-local rows of full-frame [C, H, W] planes for tile rows
    `rows` (zero past the frame's height), as B1's band launch lays them."""
    import torch

    parts = []
    for r in rows:
        blk = full[:, r * tile:min((r + 1) * tile, height)]
        if blk.shape[1] < tile:
            blk = torch.cat([blk, blk.new_zeros(blk.shape[0], tile - blk.shape[1],
                                                blk.shape[2])], 1)
        parts.append(blk)
    if not parts:
        return full.new_zeros(full.shape[0], 0, full.shape[2])
    return torch.cat(parts, 1).contiguous()


def band_pair_positions(binning, tiles):
    """Positions in a binning's list of the pairs of `tiles`, tile by tile."""
    import torch

    starts = binning.tile_start.long()[tiles]
    counts = binning.tile_count.long()[tiles]
    base = torch.repeat_interleave(starts - (torch.cumsum(counts, 0) - counts), counts)
    return base + torch.arange(int(counts.sum()), device=starts.device)


def phase_multi_gpu_bands(dev, width=1920, height=1080, n=100_000):
    """B1 and B2 on tile-row lists against the full-frame launch at 1920x1080 /
    100k: equal 2- and 4-band partitions and the dual partition of
    `paired_balance_bounds` on the frame's own row histogram. For each band:
    its banded binning equals the full binning on its tiles (lists entry for
    entry, counts zero elsewhere), B1's band planes and B2's band pair
    gradients equal the full launch's bit for bit (max abs error 0), and the
    CUDA-event time of each band launch beside the full launch's."""
    import torch

    from gsjax_torch.ops.raster import RasterConfig, render_cuda, render_ref
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.parallel import shard

    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cam = bench_camera(width, height, dev)
    _, prep, full, feats = stages(bench_inputs(width, height, n)[:5], cam, cfg, dev)
    tiles_x, tiles_y = cfg.grid(width, height)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    tail = (width, height, cam.fx, cam.fy, bg, cfg)
    lists = (feats, full.tile_start, full.tile_count)
    planes = render_cuda.blend_fwd(*lists, *tail)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    grad = torch.zeros_like(planes)
    grad[:8] = torch.randn((8, height, width), generator=gen, device=dev)
    d_full = render_cuda.blend_bwd(*lists, planes, grad, *tail)
    full_fwd_ms = event_ms(lambda: render_cuda.blend_fwd(*lists, *tail), reps=5)
    full_bwd_ms = event_ms(lambda: render_cuda.blend_bwd(*lists, planes, grad, *tail), reps=5)
    row_pairs = full.tile_count.reshape(tiles_y, tiles_x).sum(1).cpu().numpy()
    rpm2 = 2 * -(-tiles_y // 2)
    dual_b, dual_p = shard.paired_balance_bounds(row_pairs, 2, rpm2)
    partitions = [("equal_2", shard.equal_band_bounds(tiles_y, 2), None),
                  ("equal_4", shard.equal_band_bounds(tiles_y, 4), None),
                  ("paired_dual_2", dual_b, dual_p)]
    out = []
    for name, bounds, pair in partitions:
        nr = (len(bounds) - 1) // (2 if pair is not None else 1)
        b, p = shard.check_partition(bounds, pair, tiles_y, nr)
        bands = []
        for r in range(nr):
            rows = shard.band_rows(b, p, r)
            lo, hi, lo2, hi2 = shard.band_intervals(b, p, r)
            bb = bin_gaussians(prep, cfg, width, height, row_lo=lo, row_hi=hi,
                               row_lo2=lo2, row_hi2=hi2)
            tiles = torch.as_tensor((rows[:, None] * tiles_x + np.arange(tiles_x)).reshape(-1),
                                    device=dev)
            outside = torch.ones(tiles_x * tiles_y, dtype=torch.bool, device=dev)
            outside[tiles] = False
            pos_full = band_pair_positions(full, tiles)
            pos_band = band_pair_positions(bb, tiles)
            lists_equal = (torch.equal(bb.tile_count[tiles], full.tile_count[tiles])
                           and int(bb.tile_count[outside].abs().sum()) == 0
                           and torch.equal(bb.gauss_idx[pos_band], full.gauss_idx[pos_full]))
            fb = render_ref.prepare_pairs(prep, bb)
            blists = (fb, bb.tile_start, bb.tile_count)
            pb = render_cuda.blend_fwd(*blists, *tail, tile_rows=rows)
            want = band_slices(planes, rows, height, cfg.tile)
            gb = band_slices(grad, rows, height, cfg.tile)
            db = render_cuda.blend_bwd(*blists, pb, gb, *tail, tile_rows=rows)
            fwd_err = float((pb - want).abs().max()) if pb.numel() else 0.0
            bwd_err = float((db[pos_band] - d_full[pos_full]).abs().max()) \
                if pos_band.numel() else 0.0
            band = {"rows": [int(x) for x in rows], "pairs": bb.num_live,
                    "lists_equal": bool(lists_equal),
                    "b1_bitwise_equal": bool(torch.equal(pb, want)),
                    "b1_max_abs_err": fwd_err,
                    "b2_bitwise_equal": bool(torch.equal(db[pos_band], d_full[pos_full])),
                    "b2_max_abs_err": bwd_err,
                    "b1_ms": event_ms(lambda: render_cuda.blend_fwd(*blists, *tail,
                                                                    tile_rows=rows), reps=5),
                    "b2_ms": event_ms(lambda: render_cuda.blend_bwd(*blists, pb, gb, *tail,
                                                                    tile_rows=rows), reps=5)}
            bands.append(band)
            check(band["lists_equal"], f"{name} band {r}: banded binning differs")
            check(band["b1_bitwise_equal"] and band["b2_bitwise_equal"],
                  f"{name} band {r}: B1 / B2 on the band differ from the full launch "
                  f"({fwd_err}, {bwd_err})")
        check(sum(x["pairs"] for x in bands) == full.num_live,
              f"{name}: the bands' pairs do not add up to the frame's")
        out.append({"partition": name, "bounds": [int(x) for x in bounds],
                    "band_pair": None if pair is None else pair.tolist(),
                    "b1_band_ms_sum": sum(x["b1_ms"] for x in bands),
                    "b2_band_ms_sum": sum(x["b2_ms"] for x in bands), "bands": bands})
    res = {"phase": "multi_gpu_bands", "width": width, "height": height, "gaussians": n,
           "pairs": full.num_live, "row_pairs": [int(x) for x in row_pairs],
           "b1_full_ms": full_fwd_ms, "b2_full_ms": full_bwd_ms,
           "max_abs_err": max(max(b["b1_max_abs_err"], b["b2_max_abs_err"])
                              for p in out for b in p["bands"]),
           "partitions": out}
    emit(res)
    return res


# the collectives of gsjax_torch.parallel, as each rank's probe calls them
PROBE_COLLECTIVES = ("all_reduce_f32", "all_reduce_f64", "all_reduce_i64", "all_reduce_max_i64",
                     "all_gather_f32", "all_gather_i32", "all_gather_i64", "barrier")


def _probe_rank(rank):
    """On a rank of the group (2 ranks sharing the card over gloo; with
    `probe_cards.py` 4, a card each over nccl): each collective of
    PROBE_COLLECTIVES on CUDA tensors -> {name: "ok" or the error}."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    n = dist.get_world_size()
    res = {"backend": dist.get_backend(), "device": str(dev)}

    def attempt(name, fn):
        try:
            fn()
            res[name] = "ok"
        except Exception as e:           # recorded, then checked by the caller
            res[name] = f"{type(e).__name__}: {e}"[:200]

    def reduce(dtype, op=dist.ReduceOp.SUM):
        t = torch.full((1000,), rank + 1, dtype=dtype, device=dev)
        dist.all_reduce(t, op=op)
        want = n if op == dist.ReduceOp.MAX else n * (n + 1) // 2
        assert int(t[0]) == want and t.device == dev, (t[0], want)

    def gather(dtype):
        t = torch.full((1000,), rank, dtype=dtype, device=dev)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
        assert [int(p[0]) for p in parts] == list(range(n))

    attempt("all_reduce_f32", lambda: reduce(torch.float32))
    attempt("all_reduce_f64", lambda: reduce(torch.float64))
    attempt("all_reduce_i64", lambda: reduce(torch.int64))
    attempt("all_reduce_max_i64", lambda: reduce(torch.int64, dist.ReduceOp.MAX))
    attempt("all_gather_f32", lambda: gather(torch.float32))
    attempt("all_gather_i32", lambda: gather(torch.int32))
    attempt("all_gather_i64", lambda: gather(torch.int64))
    attempt("barrier", dist.barrier)
    return res


def _serve_rank(rank, width, height, n, angles):
    """On a rank of the group on the card: `render_sharded` (equal rows, then
    a dual partition: 2 ranks pair bands (0, 3) and (1, 2) of uneven rows,
    more ranks mirror 2n equal bands) and `render_views_sharded` against
    `render()` on this rank -> max abs errors, bit-equality and B1's
    launches."""
    import torch
    import torch.distributed as dist

    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.raster import Camera, RasterConfig, render, render_cuda
    from gsjax_torch.parallel import shard

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    params, aux = bench_params(bench_inputs(width, height, n)[:5], dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    def turn(a):                         # bench_camera turned by `a` about y
        c, s = np.cos(a), np.sin(a)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        return Camera.create(r, np.zeros(3, np.float32), 1.0, 0.66, width, height,
                             device=dev)

    cams = [turn(a) for a in angles]
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)

    def single(cam):
        with torch.no_grad():
            return render(params.xyz, scales, params.rotation, opac, gm.get_features(params),
                          cam, cfg, bg, alive=aux.alive)

    res = {"rank": rank}
    render_cuda.blend_fwd.launches = 0
    _, tiles_y = cfg.grid(width, height)
    ranks = dist.get_world_size()
    dual = ((np.array([0, 8, 15, 22, tiles_y]), np.array([[0, 3], [1, 2]])) if ranks == 2
            else (shard.equal_band_bounds(tiles_y, 2 * ranks), None))
    for name, bounds, pair in (("equal", None, None), ("paired_dual", *dual)):
        one = shard.render_sharded(params, aux, cams[0], cfg, bg, row_bounds=bounds,
                                   band_pair=pair)
        ref = single(cams[0])
        res[f"render_sharded_{name}"] = {
            "color_equal": bool(torch.equal(one["color"], ref["render"])),
            "depth_equal": bool(torch.equal(one["median_depth"], ref["median_depth"])),
            "color_max_abs_err": float((one["color"] - ref["render"]).abs().max()),
            "depth_max_abs_err": float((one["median_depth"] - ref["median_depth"]).abs().max())}
    views = shard.render_views_sharded(params, aux, cams, cfg, bg)
    eq_c = eq_d = True
    err = 0.0
    for i, cam in enumerate(cams):
        ref = single(cam)
        eq_c &= torch.equal(views["render"][i], ref["render"])
        eq_d &= torch.equal(views["median_depth"][i], ref["median_depth"])
        err = max(err, float((views["render"][i] - ref["render"]).abs().max()))
    res["render_views_sharded"] = {"views": len(cams), "color_equal": bool(eq_c),
                                   "depth_equal": bool(eq_d), "color_max_abs_err": err}
    res["b1_launches"] = render_cuda.blend_fwd.launches
    torch.cuda.synchronize()
    return res


MGPU_STEPS = 5           # two-rank steps from the train phase's last checkpoint
MGPU_DENSIFY = 4         # densification interval: one densify within them (step 44)
# dryrun_multichip's bounds (__graft_entry__.py:148-161), held as dryrun
# holds them (its phase 1) after the first step from the shared state: the
# loss, the densification statistics (max over gaussians, relative to the
# largest) and xyz (q90 and max of |dxyz|).
MGPU_LOSS_RTOL = 5e-3
MGPU_STATS_RTOL = 1e-2
MGPU_DXYZ_Q90 = 5e-4
MGPU_DXYZ_MAX = 2e-2
# Later steps drift apart as any two runs of one program do (float atomics
# in the backward; NCC and geometric mask pixels and Adam's sign on
# noise-level gradients flip with the drift), so each is held to the larger
# of dryrun's bound and MGPU_SPREAD times the spread of single runs, which
# the phase measures: the larger of MGPU_AGAIN runs' distances to the single
# run that the ranks are held to. Held: the loss at every step (against the
# single runs' largest loss distance), and at step 43 xyz and the
# statistics. There the statistics are read as a relative L2 distance: their
# max reads the one gaussian whose mask pixels flipped and swings 3e-3 to
# 3e-2 between two single runs. After the densify, slots are not comparable
# (a split that the drift flips moves every later child to another slot):
# the alive counts within 1e-3, and the loss as above.
MGPU_SPREAD = 3.0
MGPU_AGAIN = 2           # single runs beside the ranks; the spread is the larger distance
MGPU_ALIVE_RTOL = 1e-3
MGPU_SNAPSHOTS = (41, 40 + MGPU_DENSIFY - 1)


def state_arrays(trainer):
    """The trainer's model, statistics and Adam state as numpy, in a fixed
    order."""
    from gsjax_torch.model import gaussians as gm

    out = {f"params.{k}": getattr(trainer.params, k).detach().cpu().numpy()
           for k in gm.PARAM_FIELDS}
    out.update({f"aux.{k}": getattr(trainer.aux, k).cpu().numpy() for k in gm.AUX_FIELDS})
    for name, moments in (("mu", trainer.adam.mu), ("nu", trainer.adam.nu)):
        out.update({f"{name}.{k}": moments[k].cpu().numpy() for k in gm.PARAM_FIELDS})
    return out


def state_digest(arrays):
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def timed_cli(argv, snapshot_at=()):
    """The training CLI's `main` on `argv` with a synchronised host clock at
    each step's end -> (trainer, per-step log; `step_s` from the second step
    on: the first's clock would hold the set-up; and {iteration: {xyz,
    grad_accum, denom, alive}} after each iteration of `snapshot_at`)."""
    import torch

    from gsjax_torch import train as train_cli

    log, snap = [], {}

    def on_step(trainer, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if trainer.iteration in snapshot_at:
            snap[trainer.iteration] = dict(
                xyz=trainer.params.xyz.detach().cpu().numpy(),
                grad_accum=trainer.aux.grad_accum.cpu().numpy(),
                denom=trainer.aux.denom.cpu().numpy(), alive=trainer.aux.alive.cpu().numpy())
        log.append({"it": trainer.iteration, "loss": m["loss"], "t": now,
                    "step_s": now - log[-1]["t"] if log else None,
                    "attempts": m["attempts"], "near": m["near"],
                    "partition": m.get("partition"), "densify": m.get("densify"),
                    "alive": int(trainer.aux.alive.sum())})

    return train_cli.main(argv, on_step=on_step), log, snap


def train_rank(out_path, argv):
    """`chip_smoke.py --train-rank OUT ARGV...`: one process of the multi_gpu
    phase. The training CLI's `main` on ARGV; with `--dist_*` flags (a rank
    of the group) then, in the same group, the collectives probe and the
    serving checks. Writes the launches, the per-step log, the state's
    digest and the checks' results to OUT and, on rank 0 or alone, the
    snapshots' arrays to OUT.npz."""
    import torch
    import torch.distributed as dist

    reset_launches()
    trainer, log, snap = timed_cli(argv, snapshot_at=MGPU_SNAPSHOTS)
    launches = read_launches()
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    if rank == 0:
        np.savez(out_path + ".npz", **{f"{it}.{k}": v for it, d in snap.items()
                                       for k, v in d.items()})
    res = {"rank": rank, "launches": launches, "per_step": log,
           "digest": state_digest(state_arrays(trainer)),
           "alive": int(trainer.aux.alive.sum())}
    if grouped:
        res["probe"] = _probe_rank(rank)
        res["serve"] = _serve_rank(rank, 1920, 1080, 100_000, [0.0, 0.05, -0.05])
    with open(out_path, "w") as f:
        json.dump(res, f)
    torch.cuda.synchronize()
    if grouped:
        dist.destroy_process_group()
    return 0


def mgpu_base(keep):
    """The training CLI's flags of the multi_gpu phase: MGPU_STEPS steps from
    the `train` phase's checkpoint in `keep`, one densify among them."""
    last = 40 + MGPU_STEPS
    return ["-s", os.path.join(keep, "scene"),
            "--start_checkpoint", os.path.join(keep, "chkpnt40.npz"),
            "--iterations", str(last), "--regularization_from_iter", "21",
            "--densify_from_iter", "10", "--densification_interval", str(MGPU_DENSIFY),
            "--densify_until_iter", str(last), "--save_iterations", str(last),
            "--checkpoint_iterations", str(last), "--test_iterations", str(last),
            "--ip", "", "--seed", "0"]


def start_multi_gpu(dev, keep, n=2):
    """Start the multi_gpu phase's processes, which run beside the `mesh` and
    `slice` phases (the meshing CLI's Delaunay triangulation holds the host,
    not the card): the `n` ranks (`chip_smoke.py --train-rank` with
    `--dist_*`; two sharing the card over gloo, or with `probe_cards.py` one
    a card over nccl) and MGPU_AGAIN more
    single-process runs from the same checkpoint, the measure of how far two
    runs of one program drift apart. Returns (processes, their OUT paths)."""
    from gsjax_torch.parallel.launch import free_port

    base = mgpu_base(keep)
    coord = f"127.0.0.1:{free_port()}"
    outs = [os.path.join(keep, f"rank{r}.json") for r in range(n)]
    argvs = [base + ["-m", os.path.join(keep, f"model_r{r}"), "--dist_coordinator", coord,
                     "--dist_num_processes", str(n), "--dist_process_id", str(r)]
             for r in range(n)]
    for i in range(MGPU_AGAIN):
        outs.append(os.path.join(keep, f"single_again{i}.json"))
        argvs.append(base + ["-m", os.path.join(keep, f"model_single_again{i}"),
                             "--device", str(dev)])
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                               "--train-rank", out, *argv], cwd=ROOT, env=env)
             for out, argv in zip(outs, argvs)]
    return procs, outs


def stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def phase_multi_gpu(dev, keep, started, n=2, remove=True):
    """Two ranks sharing the card over gloo (`start_multi_gpu`: the training
    CLI's `main` with `--dist_*`, then the collectives probe and the serving
    checks) train MGPU_STEPS steps from the `train` phase's checkpoint (the
    multi-view terms on, one densify among them); the single-process CLI
    runs the same steps from the same checkpoint here, after the ranks have
    ended, so that its step times are its own. Held to dryrun_multichip's
    bounds after the first step and to the spread of two single runs after
    the later ones (MGPU_SPREAD); the ranks' states bit-equal; only rank 0's
    model directory written; B1 / B2 / B3 / B5 / B6 launched on the ranks.
    Returns {kernel: launches} summed over the ranks; `keep` is removed
    unless `remove` is false."""
    procs, outs = started
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        stop(procs)
    check(all(p.returncode == 0 for p in procs),
          f"multi_gpu exit codes (the {n} ranks, the single runs) "
          f"{[p.returncode for p in procs]}")
    ranks = [json.load(open(o)) for o in outs[:n]]
    agains = [json.load(open(o)) for o in outs[n:]]
    base = mgpu_base(keep)
    t0 = time.perf_counter()
    trainer, single_log, ref = timed_cli(
        base + ["-m", os.path.join(keep, "model_single"), "--device", str(dev)],
        snapshot_at=MGPU_SNAPSHOTS)
    single_s = time.perf_counter() - t0

    def snapshots(out):
        npz = np.load(out + ".npz")
        return {it: {k: npz[f"{it}.{k}"] for k in ref[it]} for it in MGPU_SNAPSHOTS}

    r0 = ranks[0]

    def distance(log_a, snap_a):
        rel = [abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-8)
               for a, b in zip(log_a, single_log)]
        out = {"loss_rel": rel, "loss_max_rel": max(rel)}
        for it in MGPU_SNAPSHOTS:
            a, b = snap_a[it], ref[it]
            dxyz = np.abs(a["xyz"] - b["xyz"])[b["alive"]]
            ga = b["grad_accum"]
            out[str(it)] = {
                "grad_accum_max_rel": float(np.abs(a["grad_accum"] - ga).max()
                                            / (np.abs(ga).max() + 1e-12)),
                "grad_accum_l2_rel": float(np.linalg.norm(a["grad_accum"] - ga)
                                           / (np.linalg.norm(ga) + 1e-12)),
                "denom_equal": bool(np.array_equal(a["denom"], b["denom"])),
                "dxyz_q90": float(np.quantile(dxyz, 0.9)), "dxyz_max": float(dxyz.max())}
        return out

    ranks_vs_single = distance(r0["per_step"], snapshots(outs[0]))
    singles = [distance(a["per_step"], snapshots(o)) for a, o in zip(agains, outs[n:])]

    def larger(a, b):
        if isinstance(a, dict):
            return {k: larger(a[k], b[k]) for k in a}
        if isinstance(a, list):
            return [max(x, y) for x, y in zip(a, b)]
        return (a and b) if isinstance(a, bool) else max(a, b)

    single_vs_single = singles[0]
    for other in singles[1:]:
        single_vs_single = larger(single_vs_single, other)
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    mv_steps = sum(x["near"] is not None for x in r0["per_step"])
    d, s = ranks_vs_single, single_vs_single
    later = str(MGPU_SNAPSHOTS[1])
    bounds = {"loss_rel": max(MGPU_SPREAD * s["loss_max_rel"], MGPU_LOSS_RTOL),
              "grad_accum_l2_rel": max(MGPU_SPREAD * s[later]["grad_accum_l2_rel"],
                                       MGPU_STATS_RTOL),
              "dxyz_q90": max(MGPU_SPREAD * s[later]["dxyz_q90"], MGPU_DXYZ_Q90),
              "dxyz_max": max(MGPU_SPREAD * s[later]["dxyz_max"], MGPU_DXYZ_MAX)}
    res = {"phase": "multi_gpu", "ranks": n, "backend": r0["probe"]["backend"],
           "steps": len(r0["per_step"]), "mv_steps": mv_steps, "single_s": single_s,
           "step_s_ranks": [x["step_s"] for x in r0["per_step"][1:]],
           "step_s_single": [x["step_s"] for x in single_log[1:]],
           "step_s_note": ("host clock; two ranks share one card, gloo goes through the "
                           "host; the ranks ran beside the mesh and slice phases" if n == 2
                           else f"host clock; {n} ranks, one a card"),
           "loss_ranks": [x["loss"] for x in r0["per_step"]],
           "loss_single": [x["loss"] for x in single_log],
           "ranks_vs_single": d, "single_vs_single": s, "singles": singles,
           "later_bounds": bounds,
           "alive": [r["alive"] for r in ranks], "alive_single": int(trainer.aux.alive.sum()),
           "densify": [x["densify"] for x in r0["per_step"] if x["densify"]],
           "partitions": [x["partition"] for x in r0["per_step"]],
           "ranks_bit_equal": all(r["digest"] == ranks[0]["digest"] for r in ranks),
           "rank1_wrote": any(os.path.exists(os.path.join(keep, f"model_r{r}"))
                              for r in range(1, n)),
           "launches": launches, "probe": [r["probe"] for r in ranks],
           "serve": [r["serve"] for r in ranks]}
    emit(res)
    for r in ranks:
        for name in PROBE_COLLECTIVES:
            check(r["probe"][name] == "ok", f"gloo {name} on CUDA tensors: {r['probe'][name]}")
        for k in ("render_sharded_equal", "render_sharded_paired_dual", "render_views_sharded"):
            check(r["serve"][k]["color_equal"] and r["serve"][k]["depth_equal"],
                  f"rank {r['rank']} {k} differs from render(): {r['serve'][k]}")
    check(len(r0["per_step"]) == MGPU_STEPS == len(single_log)
          and all(len(a["per_step"]) == MGPU_STEPS for a in agains), "steps run")
    check(mv_steps >= 1 and len(res["densify"]) == 1,
          f"{mv_steps} multi-view steps, {len(res['densify'])} densifications")
    check(res["ranks_bit_equal"], "the ranks' states differ")
    check(not res["rank1_wrote"], "a rank other than 0 wrote its model directory")
    check(os.path.exists(os.path.join(keep, "model_r0", "point_cloud",
                                      f"iteration_{40 + MGPU_STEPS}", "point_cloud.ply")),
          "rank 0 wrote no PLY")
    check(abs(res["alive"][0] - res["alive_single"]) <= MGPU_ALIVE_RTOL * res["alive_single"],
          f"alive {res['alive'][0]} against the single run's {res['alive_single']}")
    first = d[str(MGPU_SNAPSHOTS[0])]
    check(d["loss_rel"][0] < MGPU_LOSS_RTOL, f"loss diverged after one step: {d['loss_rel']}")
    check(first["grad_accum_max_rel"] < MGPU_STATS_RTOL and first["denom_equal"],
          f"densification statistics diverged after one step: {first}")
    check(first["dxyz_q90"] < MGPU_DXYZ_Q90 and first["dxyz_max"] < MGPU_DXYZ_MAX,
          f"xyz diverged after one step: {first}")
    check(max(d["loss_rel"]) <= bounds["loss_rel"],
          f"loss diverged past the single runs' spread: {d['loss_rel']} ({bounds})")
    for k in ("grad_accum_l2_rel", "dxyz_q90", "dxyz_max"):
        check(d[later][k] <= bounds[k],
              f"{k} at step {later} past the single runs' spread: {d[later]} ({bounds})")
    for name in ("blend_fwd", "blend_bwd"):
        check(launches[name] >= n * MGPU_STEPS, f"{name} launched {launches[name]} times")
    for name in ("sample_fwd", "sample_bwd", "warp_sample"):
        check(launches[name] == n * mv_steps, f"{name} launched {launches[name]} times")
    if remove:
        shutil.rmtree(keep, ignore_errors=True)
    return launches


# golden (recipe A of gsjax's scripts/quality_r04.py through the port's CLI):
# the sphere, 3000 steps, 28 images at 320x240, 2000 gaussians, both meshes;
# gsjax's sphere gates (scripts/golden_quality.py:363-371; its record
# QUALITY_r04_main.json: 36.75 dB, 0.0184, 0.0144)
GOLDEN_ARGV = ["--scene", "sphere", "--iterations", "3000", "--reset_interval", "900",
               "--n_gauss", "2000", "--tetra", "--width", "320", "--height", "240",
               "--sh_degree", "3", "--sg_degree", "2", "--densify_grad_threshold", "1e-4",
               "--n_images", "28"]
GOLDEN_GATES = {"test_psnr_db_min": 34.0, "chamfer_max": 0.025, "chamfer_tetra_max": 0.0625}
# the gate the phase holds; the port misses the PSNR gate on every draw of A
# and the TSDF gate on some (ROADMAP queue C): both are reported
GOLDEN_HELD = ("chamfer_tetra_max",)
# the TSDF route on the scored model, B1 against its plain version: the two
# routes' chamfers agree within TSDF_TWIN_TOL; the route run again with B1
# gives the scored chamfer to its JSON's five decimals
TSDF_TWIN_TOL = 2e-4
# the plain version renders every GOLDEN_TWIN_STRIDE-th training view (its
# bisection over ~15k-pair lists takes ~5 s a view on the card)
GOLDEN_TWIN_STRIDE = 2
GOLDEN_BINARY_STEPS = 8     # the golden CLI's tetra route
GOLDEN_TIMEOUT = 900
GOLDEN_DIR = os.path.join(ROOT, "build", "chip_smoke_golden")
# the phases that run while the golden child trains (host-clock phases)
GOLDEN_BESIDE = ("train_options", "multihost", "evaluate", "viewer", "diagnostics")

# The `bench` phase: the three benchmark entries run as a user runs them,
# one after the other and beside nothing (their times are CUDA events).
# bench_torch.py and bench_reg_torch.py run BENCH_RUNS times each (the
# median and spread of their values), bench_reg_torch.py once more with
# GSJAX_NCC_COMPACT=1, bench_scaling_torch.py with SCALING_RANKS ranks
# sharing the card in modes `train` and `views`. bench_torch's warm-up loss
# is timing_train's bench step on the same draws (max_per_tile 1 << 11
# against 1 << 12 there; neither clamps): within BENCH_LOSS_RTOL, and its
# rays/s within a factor BENCH_RAYS_FACTOR of timing_train's (outside it one
# of the two does not time what it says). bench_reg's first step on the
# kernels against the same step on their plain versions on the card: the
# loss, ncc and geo within REG_RTOL (tests/test_torch_train_step.py's bound
# on the multi-view step), mv_queries within REG_QUERIES_FRAC of the
# frame's pixels (pixels whose median depth B1 and its plain version find on
# either side of the range, MD_FRAC); each run's first step equal to it
# (the same kernels, the same inputs) within BENCH_LOSS_RTOL. Read on the
# card (H100): bench_torch's loss equal to timing_train's in every digit;
# the reg step's loss and ncc equal to the plain versions' in every digit,
# geo 1.5e-6 apart, mv_queries equal (48,401).
BENCH_RUNS = 3
BENCH_LOSS_RTOL = 1e-5
BENCH_RAYS_FACTOR = 2.0
REG_RTOL = 1e-3
REG_QUERIES_FRAC = 1 - MD_FRAC
SCALING_RANKS = 2
BENCH_ENTRY_TIMEOUT = 600


def golden_run(out_path, argv):
    """`chip_smoke.py --golden OUT [--twin-stride N] ARGV...`: the golden
    CLI's `main` on ARGV (`gsjax_torch.golden_quality`), with the wrappers'
    launch counts read at each of its stages and B4's calls timed by CUDA
    events, then `golden_tsdf_twin` on the scored model over every N-th
    training view (default GOLDEN_TWIN_STRIDE); writes them, the result and
    the run's statistics to OUT and prints the launches beside the result."""
    stride = GOLDEN_TWIN_STRIDE
    if argv[:1] == ["--twin-stride"]:
        stride, argv = int(argv[1]), argv[2:]
    import torch

    from gsjax_torch import golden_quality
    from gsjax_torch.ops import sample_cuda

    random.seed(0)      # one fixed view order (the CLI leaves `random` unseeded)
    reset_launches()
    by_stage, mark, scored = {}, {}, {}

    def on_stage(name, trainer):
        torch.cuda.synchronize()
        now = read_launches()
        if mark:
            by_stage[mark["name"]] = {k: now[k] - mark["counts"][k] for k in now}
        mark.update(name=name, counts=now)
        scored["trainer"] = trainer

    with timed_calls(sample_cuda, "integrate_fwd") as b4_calls:
        result, stats = golden_quality.main(argv, on_stage=on_stage)
        torch.cuda.synchronize()
    launches = read_launches()
    # after the counts are read: the comparison's launches do not count
    twin = golden_tsdf_twin(scored["trainer"], golden_quality.build_parser().parse_args(argv),
                            stride)
    with open(out_path, "w") as f:
        json.dump({"result": result, "stats": stats, "launches": launches,
                   "launches_by_stage": by_stage, "b4_calls": len(b4_calls),
                   "b4_device_s": sum(a.elapsed_time(b) for a, b in b4_calls) / 1e3,
                   "tsdf_twin": twin}, f)
    print(json.dumps({"launches": launches, "tsdf_twin": twin}), flush=True)
    return 0


def golden_tsdf_twin(trainer, args, stride=GOLDEN_TWIN_STRIDE):
    """The scored model's TSDF route (median-depth renders, fusion at voxel
    0.02, the largest cluster, the chamfer) with B1 on every training view,
    as the golden CLI scored it, and on every `stride`-th view with B1 and
    with its plain version: those views' median depth, colour and alpha
    against each other, both routes' chamfers, and the largest tile list
    against the cap the renders ran with."""
    import torch

    from gsjax_torch import golden_quality
    from gsjax_torch.mesh.extract import extract_mesh_tsdf

    views = trainer.scene.train_views
    sub = list(range(0, len(views), stride))
    n_cluster = args.cluster_to_keep or golden_quality.CLUSTERS[args.scene]
    samples = golden_quality.surface_samples(args.scene)

    def renders(backend, ids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [trainer.render_view(views[i], require_depth=True,
                                    min_opacity=args.mesh_min_opacity) for i in ids]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    def route(outs, ids, render_s):
        cached = iter(outs)
        mesh = extract_mesh_tsdf(lambda v: next(cached), [views[i] for i in ids],
                                 voxel_size=0.02, depth_trunc=6.0,
                                 cluster_to_keep=n_cluster, verbose=False)
        verts = mesh["post"][0] if len(mesh["post"][0]) else mesh["raw"][0]
        ch, d2s, s2d, nv = golden_quality.chamfer_of(verts, args.scene, None, samples)
        return {"views": len(ids), "render_s": render_s, "chamfer": ch, "chamfer_d2s": d2s,
                "chamfer_s2d": s2d, "mesh_vertices": nv, "grid": list(mesh["grid"])}

    ko, kernel_s = renders("cuda", range(len(views)))
    kernel_cfg = trainer.raster_cfg
    trainer.raster_cfg = lambda rd: dataclasses.replace(kernel_cfg(rd), backend="torch")
    try:
        to, twin_s = renders("torch", sub)
    finally:
        del trainer.raster_cfg
    ko_sub = [ko[i] for i in sub]
    md_close = torch.cat([torch.isclose(k["median_depth"], t["median_depth"], atol=MD_ATOL,
                                        rtol=MD_RTOL).reshape(-1) for k, t in zip(ko_sub, to)])

    def max_err(key):
        return max(float((k[key] - t[key]).abs().max()) for k, t in zip(ko_sub, to))

    return {"scored": route(ko, range(len(views)), kernel_s),
            "kernel": route(ko_sub, sub, None), "twin": route(to, sub, twin_s),
            "median_depth_close_frac": float(md_close.float().mean()),
            "median_depth_max_abs_err": max_err("median_depth"),
            "color_max_abs_err": max_err("render"), "alpha_max_abs_err": max_err("alpha"),
            "max_tile_count": max(int(k["max_tile_count"]) for k in ko),
            "max_per_tile": int(trainer.max_per_tile)}


def start_golden():
    """Start the golden child (`chip_smoke.py --golden`), which trains beside
    the host-clock phases; its scene, model and log go under GOLDEN_DIR.
    Returns (process, OUT path, log path, start time)."""
    shutil.rmtree(GOLDEN_DIR, ignore_errors=True)
    os.makedirs(GOLDEN_DIR)
    out = os.path.join(GOLDEN_DIR, "golden.json")
    log = os.path.join(GOLDEN_DIR, "golden.log")
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=GOLDEN_DIR)
    argv = GOLDEN_ARGV + ["--out", os.path.join(GOLDEN_DIR, "quality.json")]
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                                 "--golden", out, *argv], cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, out, log, time.perf_counter()


def phase_golden(started):
    """Join the golden child and hold its run: gsjax's tetra chamfer gate, a
    finite test PSNR and TSDF chamfer (their gates are reported, not held:
    the port misses them, ROADMAP queue C); the TSDF route on the scored
    model with B1 against its plain version (`golden_tsdf_twin`); B2
    launched once a step that trained (an overflowed attempt stops after the
    forward), counting the device-step timing's own steps; B6 once a
    multi-view step and B3 and B5 once a multi-view step with a query,
    counted the same way; B4 views x (1 + 8 binary-search steps) x chunks of
    2^20 points; `warp_sample_blocks` never. Returns {kernel: launches}."""
    proc, out, log, t0 = started
    try:
        rc = proc.wait(timeout=GOLDEN_TIMEOUT)
    finally:
        stop([proc])
    with open(log) as f:
        tail = f.read()[-4000:]
    check(rc == 0, f"golden child exited {proc.returncode}:\n{tail}")
    with open(out) as f:
        run = json.load(f)
    res, st, launches = run["result"], run["stats"], run["launches"]
    steps, dev = st["steps_trained"], st["device_step"]
    mv_want = st["mv_steps"] + (dev["steps"] if dev["mv"] else 0)
    # B3 / B5 launch on a non-empty query set only (none right after an
    # opacity reset, before any pixel has a median depth)
    query_want = st["mv_steps_with_queries"] + dev["steps_with_queries"]
    tet = st["tetra"]
    chunks = lambda m: -(-m // MESH_CHUNK)
    want_b4 = tet["views"] * (chunks(tet["counts"]["points"])
                              + GOLDEN_BINARY_STEPS * chunks(tet["counts"]["edges"]))
    emit({"phase": "golden", "argv": GOLDEN_ARGV, "pass": res["pass"],
          "thresholds": res["thresholds"], "gates_held": list(GOLDEN_HELD),
          "psnr_gate_met": res["test_psnr_db"] >= GOLDEN_GATES["test_psnr_db_min"],
          "tsdf_gate_met": res["chamfer"] <= GOLDEN_GATES["chamfer_max"],
          **{k: res[k] for k in ("test_psnr_db", "chamfer", "chamfer_d2s", "chamfer_s2d",
                                 "chamfer_tetra", "mesh_vertices", "n_gaussians_final",
                                 "n_train_views", "n_test_views", "loop_iters_per_s",
                                 "loop_mean_ms", "step_ms_device")},
          "golden_wall_s": res["wall_s"], "phase_s": time.perf_counter() - t0,
          "beside": GOLDEN_BESIDE, "steps": steps, "mv_steps": st["mv_steps"],
          "mv_steps_with_queries": st["mv_steps_with_queries"],
          "attempts": st["attempts"], "overflow_retries": st["attempts"] - steps,
          "retried_at": st["retried_at"], "mv_max_tile_count": st["mv_max_tile_count"],
          "mv_steps_near_list_clamped": st["mv_steps_near_list_clamped"],
          "near_list_clamped_at": st["near_list_clamped_at"],
          "max_per_tile_growth": st["max_per_tile_growth"],
          "capacity_growth": st["capacity_growth"], "densify_rounds": st["densify_rounds"],
          "opacity_resets": st["opacity_resets"], "device_step": dev,
          "launches": launches, "launches_by_stage": run["launches_by_stage"],
          "b4_launches_expected": want_b4, "b4_calls": run["b4_calls"],
          "b4_device_s": run["b4_device_s"], "seconds": st["seconds"],
          "steps_by_kind": st["steps_by_kind"], "tsdf": st["tsdf"], "tetra": tet,
          "tsdf_twin": run["tsdf_twin"], "device": st["device"]})
    check(res["thresholds"] == GOLDEN_GATES, f"gates {res['thresholds']}")
    check(np.isfinite(res["test_psnr_db"]) and np.isfinite(res["chamfer"])
          and res["chamfer_tetra"] is not None
          and res["chamfer_tetra"] <= GOLDEN_GATES["chamfer_tetra_max"],
          f"recipe A misses gsjax's tetra chamfer gate: PSNR {res['test_psnr_db']}, "
          f"chamfer {res['chamfer']}, tetra {res['chamfer_tetra']}")
    twin = run["tsdf_twin"]
    check(twin["median_depth_close_frac"] >= MD_FRAC
          and twin["median_depth_max_abs_err"] <= MD_MAX,
          f"B1's median depth on the scored model against its plain version: close on "
          f"{twin['median_depth_close_frac']}, largest error {twin['median_depth_max_abs_err']}")
    check(abs(twin["scored"]["chamfer"] - res["chamfer"]) <= 1e-5,
          f"the TSDF route run again reads {twin['scored']['chamfer']}, scored {res['chamfer']}")
    check(abs(twin["kernel"]["chamfer"] - twin["twin"]["chamfer"]) <= TSDF_TWIN_TOL,
          f"TSDF chamfer with B1 {twin['kernel']['chamfer']}, with its plain version "
          f"{twin['twin']['chamfer']}")
    check(steps == 3000 and st["resumed_at"] is None, f"{steps} steps, resumed at "
          f"{st['resumed_at']}")
    check(launches["blend_bwd"] == steps + dev["steps"],
          f"blend_bwd launched {launches['blend_bwd']} times for {steps} steps and "
          f"{dev['steps']} timed ones")
    check(run["launches_by_stage"]["train"]["blend_fwd"] == st["attempts"],
          f"blend_fwd launched {run['launches_by_stage']['train']['blend_fwd']} times "
          f"in training for {st['attempts']} attempts")
    check(launches["warp_sample"] == mv_want,
          f"warp_sample launched {launches['warp_sample']} times for {mv_want} multi-view steps")
    for name in ("sample_fwd", "sample_bwd"):
        check(launches[name] == query_want,
              f"{name} launched {launches[name]} times for {query_want} multi-view steps "
              f"with queries")
    check(launches["integrate_fwd"] == want_b4 == run["b4_calls"],
          f"integrate_fwd launched {launches['integrate_fwd']} times, want {want_b4}")
    check(launches["warp_sample_blocks"] == 0,
          f"warp_sample_blocks launched {launches['warp_sample_blocks']} times")
    shutil.rmtree(GOLDEN_DIR, ignore_errors=True)
    return launches


def run_entry(script, **env):
    """One benchmark entry as a user runs it (`python3 SCRIPT` from the root,
    the default workload plus `env`): its result line, diagnostics, stderr's
    gsjax lines and wall clock. Fails unless it exits 0 with a positive
    finite value and no `error`."""
    from gsjax_torch.utils import benchsync

    full = {k: v for k, v in os.environ.items() if not k.startswith("GSJAX_")} | env
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, script], cwd=ROOT, env=full, capture_output=True,
                       text=True, timeout=BENCH_ENTRY_TIMEOUT)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"{script} {env} exited {r.returncode}:\n{r.stdout[-2000:]}\n"
          f"{r.stderr[-4000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    check("error" not in line and line["value"] is not None and np.isfinite(line["value"])
          and line["value"] > 0, f"{script}: {line}")
    return {"line": line, "diag": benchsync.read_diagnostics(r.stderr), "wall_s": wall,
            "stderr": [ln for ln in r.stderr.splitlines()
                       if ln.startswith(("warmup", "re-warmup", "timed", "mv_blocks", "n="))]}


def spread(values):
    v = np.asarray(values, np.float64)
    return {"values": v.tolist(), "median": float(np.median(v)),
            "spread": float(v.max() - v.min()), "spread_rel": float((v.max() - v.min())
                                                                      / np.median(v))}


def phase_bench(dev, timing_ref, width=1920, height=1080, n=100_000):
    """The three benchmark entries (BENCH_* above); returns their kernel
    launches summed over every run."""
    import torch

    from gsjax_torch import bench_reg

    launches = {}

    def count(run):
        for k, v in run["diag"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        return run

    # bench_torch.py
    runs = [count(run_entry("bench_torch.py")) for _ in range(BENCH_RUNS)]
    rays = [r["line"]["value"] for r in runs]
    for r in runs:
        d = r["diag"]
        check(r["line"]["metric"] == "raster_fwd_bwd_rays_per_s_1080p", r["line"])
        check(abs(d["loss"] - timing_ref["loss"]) <= BENCH_LOSS_RTOL * abs(timing_ref["loss"]),
              f"bench_torch loss {d['loss']} against timing_train's {timing_ref['loss']}")
        check(d["max_tile_count"] <= d["max_per_tile"], f"bench_torch clamped a list: {d}")
        check(1 / BENCH_RAYS_FACTOR <= r["line"]["value"] / timing_ref["rays_per_s"]
              <= BENCH_RAYS_FACTOR, f"bench_torch {r['line']['value']} rays/s against "
              f"timing_train's {timing_ref['rays_per_s']}")
        check(d["launches"]["blend_fwd"] == d["launches"]["blend_bwd"] == 1 + d["iters"],
              f"bench_torch launches {d['launches']}")
    bench_out = {"rays_per_s": spread(rays), "loss": [r["diag"]["loss"] for r in runs],
                 "timing_train": timing_ref, "max_tile_count": runs[0]["diag"]["max_tile_count"],
                 "wall_s": [r["wall_s"] for r in runs], "stderr": runs[0]["stderr"],
                 "nvidia_smi": runs[0]["diag"]["nvidia_smi"]}

    # bench_reg_torch.py's first step on the kernels and on their plain versions
    first = {}
    for name, backend in (("kernels", "auto"), ("plain", "torch")):
        params, aux, adam, step = bench_reg.reg_workload(width, height, n, dev,
                                                         backend=backend)
        t0 = time.perf_counter()
        m = step(params, aux, adam)[3]
        torch.cuda.synchronize()
        first[name] = {k: m[k] for k in ("loss", "ncc_loss", "geo_loss", "dn_loss",
                                         "mv_queries", "num_live_pairs")}
        first[name]["seconds"] = time.perf_counter() - t0
        del params, aux, adam, step, m
    k, p = first["kernels"], first["plain"]
    for key in ("loss", "ncc_loss", "geo_loss"):
        check(abs(k[key] - p[key]) <= REG_RTOL * abs(p[key]),
              f"reg first step {key}: kernels {k[key]}, plain {p[key]}")
    check(abs(k["mv_queries"] - p["mv_queries"]) <= REG_QUERIES_FRAC * width * height,
          f"reg first step mv_queries: kernels {k['mv_queries']}, plain {p['mv_queries']}")

    # bench_reg_torch.py, dense NCC and block-compacted
    reg = [count(run_entry("bench_reg_torch.py")) for _ in range(BENCH_RUNS)]
    reg_c = count(run_entry("bench_reg_torch.py", GSJAX_NCC_COMPACT="1"))
    for r in reg + [reg_c]:
        d, compact = r["diag"], r is reg_c
        check(r["line"]["metric"] == "reg_train_step_ms_1080p", r["line"])
        check(abs(d["first_step"]["loss"] - k["loss"]) <= BENCH_LOSS_RTOL * abs(k["loss"])
              and d["first_step"]["mv_queries"] == k["mv_queries"],
              f"bench_reg first step {d['first_step']} against the phase's {k}")
        steps = d["untimed_steps"] + d["iters"]
        used, unused = (("warp_sample_blocks", "warp_sample") if compact
                        else ("warp_sample", "warp_sample_blocks"))
        check(d["launches"]["blend_fwd"] == d["launches"]["blend_bwd"] == steps
              and d["launches"]["sample_fwd"] > 0 and d["launches"]["sample_bwd"] > 0
              and d["launches"][used] > 0 and d["launches"][unused] == 0,
              f"bench_reg{' compact' if compact else ''} launches {d['launches']}")
    reg_out = {"ms": spread([r["line"]["value"] for r in reg]),
               "compact_ms": reg_c["line"]["value"],
               "first_step": first, "untimed_steps": reg[0]["diag"]["untimed_steps"],
               "mv_queries": reg[0]["diag"]["first_step"]["mv_queries"],
               "mv_blocks": reg_c["diag"]["first_step"]["mv_blocks"],
               "ncc": reg[0]["diag"]["first_step"]["ncc_loss"],
               "geo": reg[0]["diag"]["first_step"]["geo_loss"],
               "wall_s": [r["wall_s"] for r in reg + [reg_c]],
               "stderr": reg[0]["stderr"], "compact_stderr": reg_c["stderr"]}

    # bench_scaling_torch.py, ranks sharing the card over gloo
    scaling = {}
    for mode in ("train", "views"):
        name = "SCALING_torch.json" if mode == "train" else "SCALING_torch_views.json"
        path = os.path.join(ROOT, name)
        try:
            r = count(run_entry("bench_scaling_torch.py", GSJAX_SCALING_MODE=mode,
                                GSJAX_SCALING_DEVICES=str(SCALING_RANKS)))
            with open(path) as f:
                table = json.load(f)
        finally:
            if os.path.exists(path):
                os.remove(path)
        rows = table["rows"]
        check(r["line"]["metric"] == f"{mode}_scaling_correctness_{SCALING_RANKS}dev"
              and [row["devices"] for row in rows] == [1, SCALING_RANKS]
              and all(row["efficiency"] is None for row in rows),
              f"bench_scaling {mode}: {r['line']} {rows}")
        scaling[mode] = {"line": r["line"], "iter_s": [row["iter_s"] for row in rows],
                         "rank_iter_s": [row["rank_iter_s"] for row in rows],
                         "backend": [row["backend"] for row in rows],
                         "launches": r["diag"]["launches"], "wall_s": r["wall_s"]}
    for name in ("blend_fwd", "blend_bwd", "sample_fwd", "sample_bwd", "warp_sample",
                 "warp_sample_blocks", "preprocess_fwd", "preprocess_bwd"):
        check(launches.get(name, 0) > 0, f"{name} never launched by the benchmark entries")
    emit({"phase": "bench", "bench": bench_out, "reg": reg_out, "scaling": scaling,
          "launches": launches})
    return launches


# The `profile` phase: the profiling and scaling chain in this process (no
# child start-ups), after `bench` and beside nothing (its times are CUDA
# events): `profile_stages --fast` for PROFILE_ITERS iterations at bench.py's
# workload, `measure_trepl`, `scaling_model` on that profile and t_repl (the
# datasheet's link), `profile_sample` and `profile_reg` for
# PROFILE_SAMPLE_ITERS iterations on the 2.07 M-point query, `trace_reg` for
# TRACE_STEPS steps. Their own output goes to PROFILE_DIR/profile.log. Held:
# the stats equal `stage_stats` on the phase's own binning and B1 planes of
# bench.py's scene (binning and B1 are deterministic); the full step's loss
# within BENCH_LOSS_RTOL of timing_train's bench step on the same draws; the
# model's n = 1 row equal to the profile's full step; B3, B5 and B6 named
# among the traced reg step's kernels (TRACE_KERNELS). The multi-host demo
# (`multihost_demo`: 4 gloo ranks on 2 simulated hosts sharing the card)
# runs beside the golden child with the other host-clock phases, within
# MULTIHOST_TIMEOUT, and must report `ok`.
PROFILE_ITERS = 3
PROFILE_SAMPLE_ITERS = 2
TRACE_STEPS = 2
TRACE_TOP = 15
TRACE_KERNELS = ("sample_fwd_kernel", "sample_bwd_kernel", "warp_sample_kernel")
PROFILE_DIR = os.path.join(ROOT, "build", "chip_smoke_profile")
MULTIHOST_TIMEOUT = 300


def phase_profile(dev, timing_ref):
    """The profiling and scaling chain (PROFILE_* above); returns its kernel
    launches."""
    import torch

    from gsjax_torch import (measure_trepl, profile_reg, profile_sample, profile_stages,
                             scaling_model, trace_reg)
    from gsjax_torch.ops.raster import render_cuda

    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    os.makedirs(PROFILE_DIR)
    path = lambda name: os.path.join(PROFILE_DIR, name)
    reset_launches()
    t0 = time.perf_counter()
    secs, out = {}, {}
    with open(path("profile.log"), "w") as log, contextlib.redirect_stdout(log):
        for name, run in (
                ("profile_stages", lambda: profile_stages.main(
                    ["--fast", "--iters", str(PROFILE_ITERS), "--out", path("PROFILE.json")])),
                ("measure_trepl", lambda: measure_trepl.main([])),
                ("scaling_model", lambda: scaling_model.main(
                    ["--profile", path("PROFILE.json"), "--t_repl_ms",
                     str(out["measure_trepl"]["value"]), "--out", path("SCALING_MODEL.json")])),
                ("profile_sample", lambda: profile_sample.main(
                    ["--iters", str(PROFILE_SAMPLE_ITERS), "--out", path("SAMPLE.json")])),
                ("profile_reg", lambda: profile_reg.main(
                    ["--iters", str(PROFILE_SAMPLE_ITERS), "--out", path("REG.json")])),
                ("trace_reg", lambda: trace_reg.main(
                    ["--iters", str(TRACE_STEPS), "--top", str(TRACE_TOP)]))):
            t1 = time.perf_counter()
            out[name] = run()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t1
    launches = read_launches()
    seconds = time.perf_counter() - t0

    prof, model, trace = out["profile_stages"], out["scaling_model"], out["trace_reg"]
    # the stats against the phase's own binning and B1 planes
    cfg = profile_stages.stage_config()
    cam = bench_camera(1920, 1080, dev)
    gauss, _, _ = profile_stages.stage_inputs(1920, 1080, 100_000)
    _, prep, binning, feats = stages(gauss, cam, cfg, dev)
    planes = render_cuda.blend_fwd(feats, binning.tile_start, binning.tile_count, 1920, 1080,
                                   cam.fx, cam.fy, torch.zeros(3, device=dev), cfg)
    own = profile_stages.stage_stats(prep, binning, planes[8], cfg, 1920, 1080)
    check(own == prof["stats"], f"profile stats {prof['stats']} against the phase's {own}")
    loss = prof["full_step_loss"]
    check(abs(loss - timing_ref["loss"]) <= BENCH_LOSS_RTOL * abs(timing_ref["loss"]),
          f"profile_stages' full step loss {loss} against timing_train's {timing_ref['loss']}")
    full = prof["timings_ms"]["FULL fwd+bwd step"]
    check(model["rows"][0]["devices"] == 1 and model["rows"][0]["pred_step_ms"] == round(full, 2),
          f"scaling_model's n = 1 row {model['rows'][0]} against the full step {full}")
    missing = [k for k in TRACE_KERNELS if not any(k in nm for nm in trace["names"])]
    check(not missing, f"trace_reg's kernels lack {missing}")
    for name in ("blend_fwd", "blend_bwd", "sample_fwd", "sample_bwd", "warp_sample",
                 "preprocess_fwd", "preprocess_bwd"):
        check(launches[name] > 0, f"{name} never launched by the profile phase")
    keep = ("devices", "pred_step_ms", "pred_efficiency", "collective_ms", "share_max_balanced",
            "partition")
    emit({"phase": "profile", "seconds": seconds, "seconds_by_tool": secs,
          "timings_ms": prof["timings_ms"], "stats": prof["stats"],
          "full_step_loss": loss, "t_repl_ms": out["measure_trepl"]["value"],
          "model": {"inputs": {k: model["inputs"][k] for k in
                               ("t_prep_ms", "t_repl_ms", "t_band_ms", "ici_gbps",
                                "link_gbps_source", "grad_psum_bytes")},
                    "rows": [{k: r[k] for k in keep} for r in model["rows"]]},
          "sample": {k: v for k, v in out["profile_sample"].items() if k != "notes"},
          "reg": out["profile_reg"],
          "trace": {k: trace[k] for k in ("window_ms", "busy_ms", "idle_share", "kernels",
                                          "total_ms", "top")},
          "launches": launches})
    return launches


def phase_multihost(dev):
    """gsjax's multi-host demo through the port (`multihost_demo.run`): 4
    ranks on 2 simulated hosts, sharing the card over gloo; returns the
    ranks' kernel launches summed."""
    from gsjax_torch import multihost_demo

    t0 = time.perf_counter()
    res = multihost_demo.run(2, 2, dev, timeout=MULTIHOST_TIMEOUT)
    check(res["ok"], f"multihost demo: {json.dumps(res)[:3000]}")
    launches = {}
    for r in res["ranks"]:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    check(launches["blend_fwd"] > 0 and launches["blend_bwd"] > 0,
          f"multihost demo launches {launches}")
    emit({"phase": "multihost", "seconds": time.perf_counter() - t0, "backend": res["backend"],
          "psum": [r["psum"] for r in res["ranks"]], "losses": res["ranks"][0]["losses"],
          "devices": [r["device"] for r in res["ranks"]], "launches": launches,
          "primary_artifact_written": res["primary_artifact_written"]})
    return launches


def main():
    if sys.argv[1:2] == ["--train-rank"]:
        return train_rank(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--golden"]:
        return golden_run(sys.argv[2], sys.argv[3:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    phase_build()
    bands = phase_multi_gpu_bands(dev)
    phase_parity(640, 360, 20_000, dev)
    full_err, twin_ms = phase_parity(1920, 1080, 100_000, dev)
    bwd_err = {}
    for rd in (True, False):
        phase_parity_bwd(640, 360, 20_000, dev, rd)
        bwd_err[rd], bwd_twin = phase_parity_bwd(1920, 1080, 100_000, dev, rd)
        if rd:
            bwd_twin_ms = bwd_twin
    phase_sum_orders(dev)
    pre = {c: phase_parity_preprocess(c, dev) for c in ("tnt_truck", "m360_bicycle")}
    phase_parity_sample(640, 360, 20_000, dev)
    scene = mv_scene(1920, 1080, 100_000, dev)
    sample_err, qr, rows, cot = phase_parity_sample(1920, 1080, 100_000, dev, scene)
    warp_err = phase_parity_warp(scene)
    blocks_err = phase_parity_ncc_blocks(scene)
    mv_ms, mv_bound = phase_timing_mv(dev, scene, qr, rows, cot)
    del scene, qr, rows, cot
    phase_parity_integrate(640, 360, 20_000, dev)
    int_err, int_query = phase_parity_integrate(1920, 1080, 100_000, dev)
    tile_query = sphere_query(1920, 1080, 100_000, dev)
    b4_ms, b4_bound = phase_timing_mesh(1920, 1080, *int_query, tile_query)
    phase_integrate_profile(*int_query, b4_bound, b4_ms, tile_query)
    del int_query, tile_query
    keep = os.path.join(ROOT, "build", "chip_smoke_multi_gpu")
    train_launches = phase_train(dev, keep=keep)
    started = start_multi_gpu(dev, keep)
    try:
        mesh_launches = phase_mesh(dev)
        serve_launches = phase_slice(dev)
        mgpu_launches = phase_multi_gpu(dev, keep, started)
    finally:
        stop(started[0])
    # the golden child trains beside the host-clock phases (GOLDEN_BESIDE),
    # after the CUDA-event timings and the multi_gpu ranks it could disturb,
    # and is joined before `timing` and `timing_train`
    golden = start_golden()
    try:
        compact_launches = phase_train(dev, options=True)
        mh_launches = phase_multihost(dev)
        eval_launches = phase_evaluate(dev)
        shutil.rmtree(WORK, ignore_errors=True)
        scene_dir = write_train_scene(dev)
        viewer_launches = phase_viewer(dev, scene_dir)
        diag_launches = phase_diagnostics(dev, scene_dir)
        shutil.rmtree(WORK, ignore_errors=True)
        golden_launches = phase_golden(golden)
    finally:
        stop([golden[0]])
    kernel_ms, bound = phase_timing(dev, twin_ms)
    b2_ms, b2_bound, bench_ref = phase_timing_train(dev)
    bench_launches = phase_bench(dev, bench_ref)
    profile_launches = phase_profile(dev, bench_ref)

    def by_path(name):
        return {"render": serve_launches.get(name, 0), "train": train_launches[name],
                "train_compact": compact_launches[name], "mesh": mesh_launches[name],
                "evaluate": eval_launches[name], "viewer": viewer_launches[name],
                "diagnostics": diag_launches[name], "multi_gpu": mgpu_launches[name],
                "golden": golden_launches[name], "bench": bench_launches.get(name, 0),
                "profile": profile_launches[name], "multihost": mh_launches[name]}

    def band_ms(kernel):
        """B1 / B2 on tile-row lists: each partition's band times and sum."""
        return {p["partition"]: {"bands": [b[f"{kernel}_ms"] for b in p["bands"]],
                                 "sum": p[f"{kernel}_band_ms_sum"]}
                for p in bands["partitions"]} | {"full": bands[f"{kernel}_full_ms"],
                                                  "max_abs_err": bands["max_abs_err"]}

    def entry(name, replaces, max_err, ms, plain_ms, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"gsjax_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": train_launches[name],
                "launches_by_path": by_path(name),
                "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": mv_bound[name]["bound_ms"],
                "bound_by": mv_bound[name]["bound_by"], "library_ms": library_ms}

    emit({"kernels": [
        {"name": "blend_fwd", "route": "cuda", "source": "gsjax_torch/csrc/blend_fwd.cu",
         "replaces": "gsjax/ops/raster/render_pallas.py:644",
         "launches": train_launches["blend_fwd"],
         "launches_by_path": by_path("blend_fwd"),
         "max_abs_err": max(full_err["color_max_abs_err"], full_err["alpha_max_abs_err"]),
         "ms": kernel_ms, "plain_ms": twin_ms, "bound_ms": bound["bound_ms"],
         "bound_by": bound["bound_by"], "library_ms": None, "band_ms": band_ms("b1")},
        {"name": "blend_bwd", "route": "cuda", "source": "gsjax_torch/csrc/blend_bwd.cu",
         "replaces": "gsjax/ops/raster/render_pallas.py:806",
         "launches": train_launches["blend_bwd"],
         "launches_by_path": by_path("blend_bwd"),
         "max_abs_err": max(e["pair_max_err"] for e in bwd_err.values()),
         "ms": b2_ms, "plain_ms": bwd_twin_ms, "bound_ms": b2_bound["bound_ms"],
         "bound_by": b2_bound["bound_by"], "library_ms": None, "band_ms": band_ms("b2")},
        entry("sample_fwd", "gsjax/ops/raster/sample_pallas.py:79",
              sample_err["m_t_max_abs_err"], mv_ms["b3_ms"], sample_err["twin_fwd_ms"]),
        {"name": "integrate_fwd", "route": "cuda", "source": "gsjax_torch/csrc/integrate_fwd.cu",
         "replaces": "gsjax/ops/raster/sample_pallas.py:79 (integrate mode, :154-159)",
         "launches": mesh_launches["integrate_fwd"],
         "launches_by_path": by_path("integrate_fwd"),
         "max_abs_err": int_err["T_max_abs_err"], "ms": b4_ms, "plain_ms": int_err["twin_ms"],
         "bound_ms": b4_bound["bound_ms"], "bound_by": b4_bound["bound_by"],
         "library_ms": None},
        entry("sample_bwd", "gsjax/ops/raster/sample_pallas.py:240",
              max(sample_err["pair_max_err"], sample_err["point_max_err"]),
              mv_ms["b5_ms"], sample_err["twin_bwd_ms"]),
        entry("warp_sample", "gsjax/ops/warp_sample.py:60",
              max(warp_err[k] for k in ("value_max_abs_err", "du_max_abs_err",
                                        "dv_max_abs_err")),
              mv_ms["b6_ms"], warp_err["twin_ms"], mv_ms["grid_sample_ms"]),
        # B6's kernel launched by gsjax's second entry point into the same
        # pallas_call, on the block-compacted NCC's path (GSJAX_NCC_COMPACT=1)
        {"name": "warp_sample_blocks", "route": "cuda",
         "source": "gsjax_torch/csrc/warp_sample.cu",
         "replaces": "gsjax/ops/warp_sample.py:230",
         "launches": compact_launches["warp_sample_blocks"],
         "launches_by_path": by_path("warp_sample_blocks"),
         "max_abs_err": blocks_err["max_abs_err"], "ms": mv_ms["b6b_ms"],
         "plain_ms": blocks_err["twin_ms"],
         "bound_ms": mv_bound["warp_sample_blocks"]["bound_ms"],
         "bound_by": mv_bound["warp_sample_blocks"]["bound_by"],
         "library_ms": mv_ms["grid_sample_blocks_ms"]},
        # the preprocess pair, timed by its parity phase at each configuration
        *({"name": f"preprocess_{side}", "route": "cuda",
           "source": f"gsjax_torch/csrc/preprocess_{side}.cu",
           "replaces": "none: gsjax's preprocess is an XLA stage",
           "launches": train_launches[f"preprocess_{side}"],
           "launches_by_path": by_path(f"preprocess_{side}"),
           "ms": {c: p["ms"][f"kernel_{side}"] for c, p in pre.items()},
           "plain_ms": {c: p["ms"]["twin_fwd" if side == "fwd" else "twin_fwd_bwd"]
                        for c, p in pre.items()},
           "bound_ms": {c: p["bound"][f"{side}_ms"] for c, p in pre.items()},
           "bound_by": "bytes", "library_ms": None} for side in ("fwd", "bwd"))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
