"""Device idle share of the traced training steps: one less the union of the kernels' intervals over the window (%)."""

from gsbench import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
