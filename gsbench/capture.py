"""Launch capture for the traced run: while active, each wrapper of the port's
kernels that a cell's step reaches (`render_cuda.blend_fwd`, `blend_bwd`,
`sample_cuda.sample_fwd`, `sample_bwd`, `warp_sample.warp_sample`) is
replaced by a shim that calls it and keeps a reference to its arguments and
result, so that `counts/` can count what each traced launch needed once the
trace has closed. Nothing is copied inside the traced window; the program's
call sites look the wrapper up on its module at every call, so the shims see
every launch. The shims are taken out on exit.
"""

from __future__ import annotations

import contextlib

TARGETS = (("gsjax_torch.ops.raster.render_cuda", "blend_fwd"),
           ("gsjax_torch.ops.raster.render_cuda", "blend_bwd"),
           ("gsjax_torch.ops.sample_cuda", "sample_fwd"),
           ("gsjax_torch.ops.sample_cuda", "sample_bwd"),
           ("gsjax_torch.ops.warp_sample", "warp_sample"))


@contextlib.contextmanager
def launches(record: list, only=None):
    """Append (name, args, kwargs, result) for every call of the targets
    (those named in `only`, when given) to `record`."""
    import importlib

    saved = []
    for mod_name, name in TARGETS:
        if only is not None and name not in only:
            continue
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, name)

        def shim(*args, _orig=orig, _name=name, **kwargs):
            out = _orig(*args, **kwargs)
            record.append((_name, args, kwargs, out))
            return out

        shim.launches = orig.launches
        saved.append((mod, name, orig))
        setattr(mod, name, shim)
    try:
        yield record
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
