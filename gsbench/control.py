"""The control and the planted faults that the limits in `limits/` were set
against (PERF.md gives the readings). The benchmark's own runs use none of it.

- The control is the reference in the program's place, computed with every
  tensor it hands between stages rounded to bfloat16 (the nearest precision
  below the configuration's float32; `reference/precision.py`); each traffic
  driver's `control` computes it.
- The faults break the port's timed path underneath a run, by patching the
  module attribute its call sites look up: `unchanged` (Adam leaves the state
  as it was), `half_batch` (the photometric loss over the first half of the
  frame's rows, its mean over the rest), `altered` (one 32x32 tile of B1's
  colour changed by 0.01 where B1 produces it), `half_tiles` (B1 blends every
  second tile, a frame's other half left out), `b2_scaled` (B2's gradient of
  the pair payload doubled), `grad_sign` (the positions' gradient negated as
  Adam gets it). Each driver's `FAULTS` names those its cells can have.
- A fault reaches ranks that a run spawns (fresh interpreters, which import
  the port anew): while `fault(name)` is entered, `name` stands in the
  environment variable `FAULT_ENV`, which a spawned process inherits, and a
  rank that enters `replant()` first plants the same fault in its own
  modules. Outside `fault`, `replant()` plants nothing.
"""

from __future__ import annotations

import contextlib
import os

CONTROL = "bfloat16"
SIGN_LEAF = "xyz"       # the leaf whose gradient `grad_sign` negates
FAULT_ENV = "GSBENCH_FAULT"     # the fault `fault` has planted, for spawned ranks


def _plant(name: str) -> list:
    """Patch the port's modules in this process with fault `name`; returns
    the (module, attribute, original) triples to restore."""
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.raster import render_cuda
    from gsjax_torch.train import losses

    saved = []

    def patch(mod, attr, fn):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    if name == "unchanged":
        patch(gm, "adam_update", lambda params, grads, state, lrs, **kw: None)
    elif name == "grad_sign":
        adam = gm.adam_update

        def flipped(params, grads, state, lrs, **kw):
            grads = dict(grads)
            grads[SIGN_LEAF] = -grads[SIGN_LEAF]
            return adam(params, grads, state, lrs, **kw)

        patch(gm, "adam_update", flipped)
    elif name == "half_batch":
        l1, ssim = losses.l1_loss, losses.ssim
        half = lambda x: x[: x.shape[0] // 2]
        patch(losses, "l1_loss", lambda a, b: l1(half(a), half(b)))
        patch(losses, "ssim", lambda a, b, *r: ssim(half(a), half(b), *r))
    elif name == "b2_scaled":
        bwd = render_cuda.blend_bwd

        def doubled(*args, **kw):
            return 2.0 * bwd(*args, **kw)

        doubled.launches = 0
        patch(render_cuda, "blend_bwd", doubled)
    elif name in ("altered", "half_tiles"):
        fwd = render_cuda.blend_fwd

        def broken(feats, tile_start, tile_count, *args, **kw):
            if name == "half_tiles":
                tile_count = tile_count.clone()
                tile_count[1::2] = 0
            out = fwd(feats, tile_start, tile_count, *args, **kw)
            if name == "altered":
                out = out.clone()
                out[0:3, :32, :32] += 0.01
            return out

        broken.launches = 0
        patch(render_cuda, "blend_fwd", broken)
    else:
        raise ValueError(f"unknown fault {name!r}")
    return saved


@contextlib.contextmanager
def fault(name: str):
    """Plant fault `name` in the port for the duration, in this process and
    in every rank spawned meanwhile that enters `replant()`."""
    saved = _plant(name)
    before = os.environ.get(FAULT_ENV)
    os.environ[FAULT_ENV] = name
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
        if before is None:
            os.environ.pop(FAULT_ENV, None)
        else:
            os.environ[FAULT_ENV] = before


@contextlib.contextmanager
def replant():
    """Entered first in a spawned rank: plant the fault that the spawning
    process's `fault` had active (its name inherited in `FAULT_ENV`) in this
    rank's own modules for the duration; plant nothing when none was."""
    name = os.environ.get(FAULT_ENV, "")
    if not name:
        yield
        return
    with fault(name):
        yield
