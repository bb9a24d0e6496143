"""gsjax_torch — the PyTorch / CUDA port of gsjax for NVIDIA Hopper (H100).

The package mirrors gsjax's module layout (`core`, `data`, `model`,
`ops/raster`, ...) so each module has an obvious counterpart. It imports
`torch` and never `jax` nor anything of `gsjax`: the numpy-only modules it
needs are copied in. Each kernel the JAX package wrote in Pallas for the
TPU becomes a kernel written by hand for Hopper under `csrc/`, built with
`nvcc` at first use (`_build.py`), with a plain-PyTorch twin that runs for
CPU tensors and is the kernel's oracle on the card.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
card present they raise instead of falling back (`resolve_device`).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` by default, the CPU only
    when asked for. Raises when CUDA is requested and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gsjax_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or --device cpu) to run on the CPU")
    return dev
