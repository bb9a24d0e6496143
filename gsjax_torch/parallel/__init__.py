"""Across devices on `torch.distributed` (port of `gsjax/parallel/`): tile
rows sharded over ranks for training and single-frame serving, whole views
over ranks for batch serving, and the start-up of the ranks.

  - `shard`: the band choosers, `render_sharded`, `render_views_sharded`,
    `train_step_sharded`;
  - `collectives`: the differentiable all-gather and the sums over ranks;
  - `multihost`: joining a group from the CLI flags, a rank's device and
    backend, `is_primary`;
  - `launch`: N local ranks with a hard timeout.
"""
