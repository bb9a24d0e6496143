"""Start N local ranks and wait for them: the one launcher of the training
CLI's `--n_devices N`, the render CLI's and the multi-rank tests.

    results = launch(fn, n, args=(...), device="cpu", timeout=120)

Each rank is a process of `torch.multiprocessing` (start method `spawn`)
that joins a group of `n` (`multihost.init_group`: `gloo` on the CPU or
when ranks share a card, `nccl` with a card each), runs `fn(rank, *args)`
with `torch` on `threads` threads and sends back its return value. The
launcher returns the values in rank order. When a rank raises or dies, or
the clock passes `timeout` seconds, it kills every rank and raises: a dead
rank never leaves its peers waiting in a collective.
"""

from __future__ import annotations

import queue
import socket
import time
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, fn, args, init_method, device, threads, results, env, join):
    import os

    os.environ.update(env)
    import torch
    import torch.distributed as dist

    from gsjax_torch.parallel.multihost import init_group

    try:
        if threads:
            torch.set_num_threads(threads)
        if join:
            init_group(init_method, n, rank, device)
        out = fn(rank, *args)
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, n: int, args=(), device="cpu", timeout: float | None = 120.0,
           init_method: str | None = None, threads: int | None = 1,
           rank_env: list[dict] | None = None, join: bool = True) -> list:
    """Run `fn(rank, *args)` on `n` spawned ranks of one group (see the
    module docstring); returns their values in rank order. `init_method`:
    the rendezvous (default tcp on a free localhost port; tests pass
    `file://...` so that parallel workers never share a port); `threads`:
    torch threads per rank (None: torch's default); `rank_env`: per rank, the
    environment variables to set in it; `join`: whether the launcher joins
    the ranks to a group before `fn`."""
    if n < 1:
        raise ValueError(f"launch needs at least one rank, got {n}")
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, fn, tuple(args), init_method, str(device),
                               threads, results, dict(rank_env[r]) if rank_env else {},
                               join)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    done, errors = {}, []
    try:
        while len(done) < n and not errors:
            try:
                rank, ok, out = results.get(timeout=0.2)
                if ok:
                    done[rank] = out
                else:
                    errors.append(f"rank {rank} raised:\n{out}")
                continue
            except queue.Empty:
                pass
            for r, p in enumerate(procs):
                if r not in done and p.exitcode not in (None, 0):
                    errors.append(f"rank {r} died with exit code {p.exitcode}")
            if deadline is not None and time.monotonic() > deadline:
                errors.append(f"ranks {sorted(set(range(n)) - set(done))} still "
                              f"running after {timeout} s")
    finally:
        if errors or len(done) < n:
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=30)
    if errors:
        raise RuntimeError("launch failed: " + "\n".join(errors))
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"launch: ranks exited with codes {bad}")
    return [done[r] for r in range(n)]
