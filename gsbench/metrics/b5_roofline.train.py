"""B5 (csrc/sample_bwd.cu) in the training steps: its launches' least time (counts/sample.py) over its traced time (%)."""

from gsbench import readers


def read(ctx):
    return readers.roofline(ctx, "train", "sample_bwd", "sample_bwd_kernel")
