"""B2 (csrc/blend_bwd.cu) in the training steps: its launches' least time (counts/blend.py) over its traced time (%)."""

from gsbench import readers


def read(ctx):
    return readers.roofline(ctx, "train", "blend_bwd", "blend_bwd_kernel")
