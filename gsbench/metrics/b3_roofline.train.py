"""B3 (csrc/sample_fwd.cu) in the training steps: its launches' least time (counts/sample.py) over its traced time (%)."""

from gsbench import readers


def read(ctx):
    return readers.roofline(ctx, "train", "sample_fwd", "sample_fwd_kernel")
