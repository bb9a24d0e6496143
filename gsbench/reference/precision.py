"""The control's lower precision (benchmark only, not a copy of the port).

`stage(x, cfg)` is the identity when `cfg.round_to` is None. Otherwise it
rounds `x` to that dtype and back to float32 in the forward pass, and the
cotangent likewise in the backward pass: the reference then carries every
tensor it hands from one stage to the next (activated parameters, the pair
payload, the blend planes, the point-query rows, the gradients the optimiser
gets) in bfloat16, with float32 arithmetic inside a stage, as a bfloat16
training or serving path would store them.
"""

from __future__ import annotations

import torch


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def stage(x: torch.Tensor, cfg) -> torch.Tensor:
    name = getattr(cfg, "round_to", None)
    if name is None or not x.is_floating_point():
        return x
    return _Round.apply(x, getattr(torch, name))
