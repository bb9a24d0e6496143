"""Training: losses, the train step, the loop, and the CLI.

    python -m gsjax_torch.train -s <scene> -m <out> [flags of train.py] [--device cpu]

`main` mirrors the repository's `train.py` (the reference `train.py:382-421`
flag surface) plus `--device`: training runs on cuda unless `--device cpu`
is given. Every flag of gsjax's works as in gsjax: `--use_decoupled_appearance`,
`GSJAX_NCC_COMPACT=1`, `GSJAX_NAN_PROBE=1`, `--profile_iter`, `--debug`, and
`--ip` / `--port` (default 127.0.0.1:6009, as `train.py:15-16`: every run
offers the SIBR viewer server; one that cannot bind prints so and trains
on). `--profile_iter N` writes a chrome trace of steps N to N + 4 under
`<out>/profile/`: each step is the span `train_step <it>` and holds the
layer spans of `gsjax_torch/utils/spans.py` (`spans.SPANS`), on the
profiler's clock with the kernels they launch.

Across devices (`gsjax_torch.parallel`):

    python -m gsjax_torch.train ... --n_devices N [--device cpu]

starts N ranks on this host (`parallel.launch`): min(N, cards) on the card,
one a card over `nccl`, or N on the CPU over `gloo`; N <= 0 means every
card. To join a group of ranks started otherwise, each rank runs

    python -m gsjax_torch.train ... --dist_coordinator HOST:PORT \
        --dist_num_processes P --dist_process_id R

(or `--dist_auto` under `torchrun`); ranks on one host may then share a
card, over `gloo`. Every rank trains the same model; rank 0 writes.
"""

from __future__ import annotations


def _rank_main(rank, argv):
    """One rank of `--n_devices N` (its group is up): the CLI on `argv`."""
    main(argv)


def main(argv=None, on_step=None):
    """Run the training CLI on `argv` (default sys.argv[1:]); `on_step(trainer,
    metrics)` is called after every step. Returns the Trainer (None when it
    starts ranks for `--n_devices N`, N > 1: they run in processes of their
    own)."""
    import random
    import sys
    from argparse import ArgumentParser

    import numpy as np
    import torch
    import torch.distributed as dist

    from gsjax_torch.config import (ModelParams, OptimizationParams,
                                    PipelineParams, dump_cfg_args)
    from gsjax_torch.train.loop import run_training

    parser = ArgumentParser(description="gsjax_torch training")
    lp = ModelParams(parser)
    op = OptimizationParams(parser)
    pp = PipelineParams(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7000, 30000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7000, 30000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[15000])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_iter", type=int, default=0)
    parser.add_argument("--pair_capacity_init", type=int, default=0,
                        help="kept for flag parity with gsjax; the port sizes "
                             "its pair buffers from the real pair count")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="train on N ranks started here, tile rows sharded "
                             "over them: min(N, cards) on the card (one a card, "
                             "nccl), N with --device cpu (gloo); <= 0: every card")
    parser.add_argument("--dist_coordinator", type=str, default="",
                        help="host:port of rank 0: join a group of "
                             "--dist_num_processes ranks as --dist_process_id; "
                             "ranks on one host may share one card (gloo)")
    parser.add_argument("--dist_num_processes", type=int, default=1)
    parser.add_argument("--dist_process_id", type=int, default=0)
    parser.add_argument("--dist_auto", action="store_true", default=False,
                        help="join the group torchrun sets up (env://)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' for the "
                             "plain-PyTorch path)")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)
    args.test_iterations.append(args.iterations)

    from gsjax_torch.parallel import launch, multihost

    joins = bool(args.dist_coordinator or args.dist_auto)
    n = multihost.resolve_ranks(args.n_devices, args.device)
    if n > 1 and not joins and not dist.is_initialized():
        print(f"Starting {n} ranks", flush=True)
        launch.launch(_rank_main, n, args=(argv,), device=args.device or "cuda",
                      timeout=None, threads=None)
        print("\nTraining complete.")
        return None
    args.n_devices = n
    multihost.maybe_init_distributed(args, args.device)
    lpe, ope, ppe = lp.extract(args), op.extract(args), pp.extract(args)
    if multihost.is_primary():
        print("Optimizing " + lpe.model_path)
        dump_cfg_args(lpe.model_path, args)
    # every rank draws the same views and randoms (parallel/multihost.py)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    trainer = run_training(lpe, ope, ppe, args, device=args.device, on_step=on_step)
    if multihost.is_primary():
        print("\nTraining complete.")
    return trainer
