"""Multi-process launch helper over ``torch.distributed``.

Counterpart of hygeia_tpu/parallel/launcher.py. Every process runs the same
pipeline entry; ``initialize_distributed`` joins them into one process
group and the (genome x seed) mesh spreads its shards over the ranks
(parallel/mesh.py). Only rank 0 writes outputs.

    torchrun --nproc_per_node 4 -m hygeia_tpu_torch.cli run --two_group --mesh 4x2 ...

``torchrun`` sets RANK, WORLD_SIZE and MASTER_ADDR (and LOCAL_RANK); a
caller can also pass the rendezvous itself (a ``tcp://host:port`` or
``file://`` address, the process count and this process's rank).

The backend is explicit. NCCL when each rank has a card of its own
(LOCAL_RANK < torch.cuda.device_count()); gloo only when the caller asks
for it (``backend="gloo"`` or HYGEIA_DIST_BACKEND=gloo): the CPU tests, and
ranks that share one card, which NCCL refuses. A request that cannot run
raises; no backend is picked in its place.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _backend(backend, local_rank):
    backend = backend or os.environ.get("HYGEIA_DIST_BACKEND") or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown torch.distributed backend {backend!r} (nccl or gloo)")
    if backend == "nccl":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not dist.is_nccl_available() or local_rank >= n_cards:
            raise RuntimeError(
                f"NCCL needs a card for each rank: local rank {local_rank}, {n_cards} cards "
                f"(NCCL available: {dist.is_nccl_available()}); ranks that share a card or run on "
                "the CPU take backend='gloo' (HYGEIA_DIST_BACKEND=gloo)")
    return backend


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None, backend=None):
    """Join the process group and return (rank, world size).

    Without arguments and without torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR) this is a no-op that returns (0, 1). Calling it again
    returns the existing group's (rank, world size). With NCCL the rank's
    card (LOCAL_RANK, else the rank) becomes the current CUDA device."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is not None:
        addr = str(coordinator_address)
        init_method = addr if "://" in addr else f"tcp://{addr}"
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and process_id")
        world, rank = int(num_processes), int(process_id)
    elif all(os.environ.get(k) for k in _ENV):
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return 0, 1
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend = _backend(backend, local_rank)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return rank, world


def is_primary_host():
    """True on rank 0, and in a process that joined no group."""
    return not dist.is_initialized() or dist.get_rank() == 0
