# Frozen copy of gsjax_torch/utils/schedules.py at commit 95f6082.
"""LR schedules (a copy of `gsjax/utils/schedules.py`, numpy only).
Mirrors `utils/general_utils.py:get_expon_lr_func` (:31-64)."""

from __future__ import annotations

import numpy as np


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000):
    """Log-linear interpolated LR with optional cosine delay ramp."""
    step = np.asarray(step, dtype=np.float64)
    if lr_init == lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = np.clip(step / max_steps, 0, 1)
    log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
    out = delay_rate * log_lerp
    return float(out) if np.isscalar(step) or step.ndim == 0 else out
