"""Device idle share of the traced frames: one less the union of the kernels' intervals over the window (%)."""

from gsbench import readers


def read(ctx):
    return readers.idle_share(ctx, "render")
