"""The operations the traced training steps need (counts/work.py) over the traced window at 67 TFLOP/s fp32 (%)."""

from gsbench import readers


def read(ctx):
    return readers.mfu(ctx, "train")
