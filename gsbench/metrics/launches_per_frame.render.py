"""Device launches (kernels, not copies) in the trace per frame traced."""

from gsbench import readers


def read(ctx):
    return readers.launches_per_unit(ctx, "render")
