"""B1 (csrc/blend_fwd.cu) in the training steps: its launches' least time (counts/blend.py) over its traced time (%)."""

from gsbench import readers


def read(ctx):
    return readers.roofline(ctx, "train", "blend_fwd", "blend_fwd_kernel")
