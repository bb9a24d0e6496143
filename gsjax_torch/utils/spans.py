"""Named layer spans on torch.profiler's clock.

While a torch profiler records, `span(name)` is a profiler range named
`name` around its body, an op range in the profiler's own trace (a `cpu_op`
event of the chrome trace), on the same clock as the device kernels it
launches; otherwise it is one shared null context, and its whole cost is
one read of the profiler's flag. `spanned(name)` is the same range around
every call of the function it decorates. No option or environment variable
turns spans on: a profiler does.

The range is `torch._C._profiler._RecordFunctionFast`, the op-scope range
torch's own compiled graphs use, and not `torch.profiler.record_function`:
a user-scope range is mirrored on the device as a `gpu_user_annotation`
event that a trace reader would count as a kernel over its whole length.

`SPANS` is the closed list of every span name the package opens; the
training step's root span is `train_step <iteration>`.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch._C._profiler import _RecordFunctionFast

SPANS = (
    "train_step",            # Trainer.step: one user iteration ("train_step <it>")
    "train.frames",          # Trainer._cached: gt / luma lookups, a miss's upload
    "train.overflow_retry",  # each attempt after the first
    "train.filter_refresh",  # Trainer.refresh_filter3d
    "train.densify",         # densify / prune / opacity reset
    "model.activate",        # 3D-filtered scales and opacities, features, SG leaves
    "raster.render",         # api.render: one view's forward
    "raster.preprocess",     # projection, SH + SG colour
    "raster.binning",        # keys, sort, tile lists
    "raster.pairs",          # render_ref.prepare_pairs: the pair gather
    "raster.blend",          # Blend.forward (B1)
    "raster.blend_bwd",      # Blend.backward (B2)
    "loss.image",            # L1 (+ appearance) and SSIM
    "loss.depth_normal",     # the depth-normal term
    "mv.patchmatch",         # multiview.patchmatch_terms
    "mv.geo",                # back-projection, projection, reprojection
    "sample.prepare",        # the neighbour's preprocess and binning, point sort
    "sample.query",          # SampleDepth.forward (B3)
    "sample.query_bwd",      # SampleDepth.backward (B5)
    "mv.ncc",                # homographies and window sums
    "ncc.sample",            # the WarpSample call (B6)
    "step.backward",         # torch.autograd.grad of the step's loss
    "step.update",           # gradient masks, densification statistics, Adam
    "step.readback",         # the step's one host read
)

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a profiler records, else a
    shared null context."""
    if torch.autograd.profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NULL


def spanned(name: str):
    """Decorator: every call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
