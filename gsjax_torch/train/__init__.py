"""Training: losses, the train step, the loop, and the CLI.

    python -m gsjax_torch.train -s <scene> -m <out> [flags of train.py] [--device cpu]

`main` mirrors the repository's `train.py` (the reference `train.py:382-421`
flag surface) plus `--device`: training runs on cuda unless `--device cpu`
is given. Every flag of gsjax's works as in gsjax: `--use_decoupled_appearance`,
`GSJAX_NCC_COMPACT=1`, `GSJAX_NAN_PROBE=1`, `--profile_iter`, `--debug`, and
`--ip` / `--port` (default 127.0.0.1:6009, as `train.py:15-16`: every run
offers the SIBR viewer server; one that cannot bind prints so and trains
on). Only sharding and multi-host (`--n_devices != 1`, `--dist_*`) raise.
"""

from __future__ import annotations


def main(argv=None, on_step=None):
    """Run the training CLI on `argv` (default sys.argv[1:]); `on_step(trainer,
    metrics)` is called after every step. Returns the Trainer."""
    import random
    import sys
    from argparse import ArgumentParser

    import numpy as np

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
    parser.add_argument("--n_devices", type=int, default=1)
    parser.add_argument("--dist_coordinator", type=str, default="")
    parser.add_argument("--dist_num_processes", type=int, default=1)
    parser.add_argument("--dist_process_id", type=int, default=0)
    parser.add_argument("--dist_auto", action="store_true", default=False)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' for the "
                             "plain-PyTorch path)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    args.save_iterations.append(args.iterations)
    args.test_iterations.append(args.iterations)

    lpe, ope, ppe = lp.extract(args), op.extract(args), pp.extract(args)
    print("Optimizing " + lpe.model_path)
    dump_cfg_args(lpe.model_path, args)
    random.seed(args.seed)
    np.random.seed(args.seed)
    trainer = run_training(lpe, ope, ppe, args, device=args.device, on_step=on_step)
    print("\nTraining complete.")
    return trainer
