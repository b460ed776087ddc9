"""Multi-process distribution layer over `torch.distributed`.

Port of `av1dec_tpu.parallel.dist`.  `initialize_distributed` joins
this process to a group; keyframe-delimited GOPs are independent, so GOP
assignment is pure data parallelism: rank r decodes the GOPs g with
g % world_size == r, each with its own Decoder, and no pixel data
crosses between ranks (`my_gop_shard`, `decode_my_gops`).
"""
from __future__ import annotations

import datetime
import os

# how long a rank waits for the others (group start, each collective)
TIMEOUT = datetime.timedelta(seconds=300)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> str:
    """Join this process to a `torch.distributed` group; returns the
    backend.

    `coordinator` ("host:port" of rank 0), `num_processes` and
    `process_id` default to AV1DEC_COORDINATOR, AV1DEC_NUM_PROCS and
    AV1DEC_PROC_ID, then to torchrun's MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE and RANK.  `backend` defaults to "nccl" only when every
    rank has a card of its own; ranks that would share a card (NCCL
    refuses two ranks on one GPU), or a machine without a card, must
    name one (`backend="gloo"`).  Under NCCL the rank's card is
    LOCAL_RANK, or the rank modulo the card count."""
    import torch
    import torch.distributed as dist
    env = os.environ
    if coordinator is None:
        coordinator = env.get("AV1DEC_COORDINATOR")
        if coordinator is None and env.get("MASTER_ADDR"):
            coordinator = (f"{env['MASTER_ADDR']}:"
                           f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        n = env.get("AV1DEC_NUM_PROCS") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if process_id is None:
        r = env.get("AV1DEC_PROC_ID") or env.get("RANK")
        process_id = int(r) if r is not None else None
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed: give the coordinator, the number of "
            "processes and this process's id (arguments, AV1DEC_* or "
            "torchrun's variables)")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        if cards < num_processes:
            raise ValueError(
                f"initialize_distributed: {num_processes} ranks and "
                f"{cards} cards: ranks would share a card, which NCCL "
                f"refuses; pass backend='gloo'")
        backend = "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)) %
                              cards)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=TIMEOUT)
    return backend


def global_mesh(axis: str = "data"):
    """A mesh over every rank of the group, all on `axis`."""
    import torch.distributed as dist

    from av1dec_tpu_torch.parallel.mesh import make_mesh
    n = dist.get_world_size()
    return make_mesh(n, data=n if axis == "data" else 1)


def wire_device(group, device):
    """Where tensors cross between the ranks of `group` (None: the whole
    group): on `device` under NCCL, through the CPU otherwise (gloo)."""
    import torch
    import torch.distributed as dist
    return torch.device(device) if dist.get_backend(group) == "nccl" \
        else torch.device("cpu")


def my_gop_shard(path: str):
    """(gop_bounds, mine): the keyframe-delimited GOP bounds of `path`
    and the ones this rank owns (round-robin by rank)."""
    import torch.distributed as dist

    from av1dec_tpu_torch.container import _gop_jobs
    bounds = [(s, e) for _, s, e, _, _ in _gop_jobs(path, None, None)[0]]
    rank, n = dist.get_rank(), dist.get_world_size()
    mine = [b for i, b in enumerate(bounds) if i % n == rank]
    return bounds, mine


def decode_my_gops(path: str, config=None, device="cuda"):
    """Decode this rank's GOP shard on `device` (a card unless "cpu" is
    named); returns [(gop index, frames)], frames as
    `container._decode_gop` gives them."""
    import torch.distributed as dist

    from av1dec_tpu_torch import resolve_device
    from av1dec_tpu_torch.container import _decode_gop, _gop_jobs
    jobs, _ = _gop_jobs(path, config, str(resolve_device(device)))
    rank, n = dist.get_rank(), dist.get_world_size()
    return [(i, _decode_gop(j)[0]) for i, j in enumerate(jobs)
            if i % n == rank]
