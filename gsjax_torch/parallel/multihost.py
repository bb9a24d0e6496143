"""Multi-process start-up on `torch.distributed` (port of
`gsjax/parallel/multihost.py`).

One process per rank. A rank joins its group from the training CLI's flags:

    --dist_coordinator <host:port> --dist_num_processes <P> --dist_process_id <r>

(`tcp://host:port`, rank 0 serving the store), or `--dist_auto`: the
`env://` rendezvous that `torchrun` sets up (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE). `parallel.launch` starts N
local ranks itself for `--n_devices N`.

A rank's device is `cuda:(local_rank % device_count)` when the caller asks
for the card (`cpu` when it asks for the CPU): several ranks on one host may
share a card. The backend follows: `nccl` when each rank has a card of its
own, `gloo` when ranks share a card or run on the CPU. The choice is
printed; a device is never changed behind the caller's back.

gsjax's contract (multihost.py:15-23) holds: the model is replicated and
only tile rows are split, so every rank must draw the same views and the
same densification randoms. The training CLI seeds Python's, numpy's and
torch's generators identically from `--seed` on every rank, and the Trainer
consumes them in lockstep.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

def local_rank_and_size(rank: int, world: int) -> tuple[int, int]:
    """This process's rank among the ranks of its host, and their number:
    torchrun's LOCAL_RANK / LOCAL_WORLD_SIZE, else (rank, world), every rank
    on one host."""
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """The device of a rank: `cuda` (no index) -> cuda:(local_rank %
    device_count); an explicit index or the CPU stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("a rank asked for cuda and no card is present; "
                               "pass --device cpu for ranks on the CPU")
        dev = torch.device("cuda", local_rank % n)
    return dev


def choose_backend(device: torch.device, local_world: int) -> str:
    """`nccl` when each of the host's `local_world` ranks has a card of its
    own, else `gloo` (ranks sharing a card, or on the CPU)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_group(init_method: str, world: int, rank: int,
               device) -> tuple[torch.device, str]:
    """Join the group of `world` ranks at `init_method` as `rank`; returns
    (this rank's device, backend), both printed."""
    local_rank, local_world = local_rank_and_size(rank, world)
    dev = rank_device(device, local_rank)
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank)
    print(f"rank {rank}/{world}: torch.distributed backend {backend} on {dev}",
          flush=True)
    return dev, backend


def maybe_init_distributed(args, device=None) -> bool:
    """Join a group from the CLI flags (`--dist_coordinator` + counts, or
    `--dist_auto`) on this rank's device for `device` (`local_device`);
    returns whether this call joined one (not without those flags, nor when
    the group is already up)."""
    if dist.is_initialized():
        return False
    coord = getattr(args, "dist_coordinator", "") or ""
    auto = bool(getattr(args, "dist_auto", False))
    if not coord and not auto:
        return False
    device = "cuda" if device is None else device
    if auto:
        init_group("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), device)
    else:
        method = coord if "://" in coord else f"tcp://{coord}"
        init_group(method, int(getattr(args, "dist_num_processes", 1)),
                   int(getattr(args, "dist_process_id", 0)), device)
    return True


def is_primary() -> bool:
    """True on the process that writes checkpoints, PLYs and logs: rank 0,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def ranks() -> int:
    """The size of the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device) -> torch.device:
    """`device` for this process: under a group, the rank's (`rank_device`
    of its local rank), else `device` itself."""
    if not dist.is_initialized():
        return torch.device(device)
    local_rank, _ = local_rank_and_size(dist.get_rank(), dist.get_world_size())
    return rank_device(device, local_rank)


def resolve_ranks(n_devices: int, device) -> int:
    """The ranks `--n_devices N` starts: N <= 0 means every device (every
    card, or the one CPU); on the card at most one rank a card, so
    min(N, cards); N ranks on the CPU."""
    n = int(n_devices)
    dev = torch.device("cuda" if device is None else device)
    if n == 1:
        return 1
    if dev.type != "cuda":
        return n if n > 0 else 1
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("--n_devices on cuda needs a card; pass --device cpu")
    return cards if n <= 0 else min(n, cards)
