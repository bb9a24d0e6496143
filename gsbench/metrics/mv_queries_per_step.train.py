"""The step's own mv_queries counter (train/multiview.py), averaged over the traced steps (queries/step)."""

from gsbench import readers


def read(ctx):
    return readers.mean_counter(ctx, "train", "mv_queries")
