"""Device launches (kernels, not copies) in the trace per training step traced."""

from gsbench import readers


def read(ctx):
    return readers.launches_per_unit(ctx, "train")
