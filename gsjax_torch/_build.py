"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled with `nvcc` for Hopper (`sm_90a`) into
a shared library with a plain C interface and loaded with `ctypes`; a kernel
is one C symbol of its source's library (`sample_fwd.cu` exports two). The
build goes into `build/gsjax_torch/` at the repository root at first use;
the library's file name carries a hash of its source, the shared headers
under `csrc/` and the flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing is compiled when this module is imported:
the CPU tests import every module, and the CPU machine has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "gsjax_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# kernel name -> (source under the package, C symbol, argtypes); kernels of
# one source share its library
KERNELS = {
    "blend_fwd": ("csrc/blend_fwd.cu", "gsjax_blend_fwd", [
        _P, _P, _P, _P, _P, _P,        # feats, tile_start, tile_count, bg, out,
                                       # counters
        _I, _I, _I, _I, _I,            # width, height, tiles_x, tiles_y, tile
        _F, _F,                        # fx, fy
        _I, _I, _I,                    # max_per_tile, require_depth, slots
        _F, _F, _F, _F, _F,            # alpha_clamp, alpha_min, t_min,
                                       # sample_range, min_transmittance
        _P,                            # cudaStream_t
    ]),
    "blend_bwd": ("csrc/blend_bwd.cu", "gsjax_blend_bwd", [
        _P, _P, _P, _P, _P, _P, _P,    # feats, tile_start, tile_count, planes,
                                       # grad, bg, d_feats
        _P,                            # counters
        _I, _I, _I, _I, _I,            # width, height, tiles_x, tiles_y, tile
        _F, _F,                        # fx, fy
        _I, _I,                        # max_per_tile, require_depth
        _F, _F,                        # alpha_clamp, alpha_min
        _P,                            # cudaStream_t
    ]),
    "sample_fwd": ("csrc/sample_fwd.cu", "gsjax_sample_fwd", [
        _P, _P, _P, _P, _P, _P, _P,    # feats, tile_start, tile_count, pts,
                                       # blocks, out, counters
        _I, _I, _I, _I,                # n_blocks, q, max_per_tile, slots
        _F, _F, _F, _F, _F,            # alpha_clamp, alpha_min, t_min,
                                       # sample_range, min_transmittance
        _P,                            # cudaStream_t
    ]),
    "integrate_fwd": ("csrc/sample_fwd.cu", "gsjax_integrate_fwd", [
        _P, _P, _P, _P, _P, _P, _P,    # feats, tile_start, tile_count, pts,
                                       # t_eval, blocks, out
        _I, _I, _I,                    # n_blocks, q, max_per_tile
        _F, _F, _F,                    # alpha_clamp, alpha_min, t_min
        _P,                            # cudaStream_t
    ]),
    "sample_bwd": ("csrc/sample_bwd.cu", "gsjax_sample_bwd", [
        _P, _P, _P, _P, _P, _P, _P,    # feats, tile_start, tile_count, pts,
                                       # blocks, res, g
        _P, _P, _P,                    # d_feats, d_pts, counters
        _I, _I, _I,                    # n_blocks, q, max_per_tile
        _F, _F,                        # alpha_clamp, alpha_min
        _P,                            # cudaStream_t
    ]),
    "warp_sample": ("csrc/warp_sample.cu", "gsjax_warp_sample", [
        _P, _I, _I,                    # image, height, width
        _P, _P, _P,                    # u, v, out
        _L,                            # n (taps x pixels)
        _P,                            # cudaStream_t
    ]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """The library of kernel `name`: one per source, named after it."""
    src = _PKG / KERNELS[name][0]
    headers = sorted(src.parent.glob("*.cuh"))    # shared by the sources
    h = hashlib.sha256(b"".join(p.read_bytes() for p in [src, *headers])
                       + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for kernel `name`'s source unless its library exists;
    returns (Popen, tmp path, final path, log path) or None."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log = so.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG / KERNELS[name][0])]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, so, log


def build_all(names=None) -> dict[str, str]:
    """Compile every library of `names` (default: all kernels) that is
    missing, one nvcc per source, all started together. Returns {source
    stem: compiler log} for what was built; raises if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    per_source = {Path(KERNELS[n][0]).stem: n for n in names}
    jobs = {s: j for s, n in per_source.items() if (j := _start(n)) is not None}
    logs, failed = {}, []
    for n, (proc, tmp, so, log) in jobs.items():
        rc = proc.wait()
        logs[n] = log.read_text()
        if rc != 0:
            failed.append(f"{n} (nvcc exit {rc}):\n{logs[n]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)    # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
