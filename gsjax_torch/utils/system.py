"""System helpers (a copy of `gsjax/utils/system.py:search_max_iteration`)."""

from __future__ import annotations

import os


def search_max_iteration(folder) -> int:
    """Find max iteration_N subdirectory (utils/system_utils.py:27-29)."""
    iters = [int(d.split("_")[-1]) for d in os.listdir(folder)
             if d.startswith("iteration_")]
    if not iters:
        raise FileNotFoundError(f"no iteration_* under {folder}")
    return max(iters)
