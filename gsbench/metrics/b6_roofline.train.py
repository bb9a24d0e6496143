"""B6 (csrc/warp_sample.cu) in the training steps: its launches' least time (counts/sample.py) over its traced time (%)."""

from gsbench import readers


def read(ctx):
    return readers.roofline(ctx, "train", "warp_sample", "warp_sample_kernel")
