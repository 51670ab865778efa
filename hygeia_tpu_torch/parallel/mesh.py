"""The (genome x seed) mesh of meshed INFER over ranks.

Counterpart of hygeia_tpu/parallel/mesh.py. The JAX mesh places one shard
on each device; here the n_genome * n_seed shards are spread over the
``torch.distributed`` ranks, each rank owning a contiguous run of them in
genome-major order (shard i = g * n_seed + q), so genome neighbours share
a rank wherever they can and a message between them is an index shift.
With one rank, its one card holds every shard.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    shape: tuple  # (n_genome, n_seed)
    world: int
    rank: int
    device: torch.device

    @property
    def n_genome(self):
        return self.shape[0]

    @property
    def n_seed(self):
        return self.shape[1]

    @property
    def shards_per_rank(self):
        return self.shape[0] * self.shape[1] // self.world

    def shards(self, rank=None):
        """The (g, q) shards of ``rank`` (default: this rank), in order."""
        r = self.rank if rank is None else rank
        per = self.shards_per_rank
        return [divmod(i, self.shape[1]) for i in range(r * per, (r + 1) * per)]


def make_mesh(n_genome=None, n_seed=1, *, world=None, rank=None, device):
    """A (n_genome, n_seed) mesh over ``world`` ranks (default: the
    process group's, or 1 without one); n_genome defaults to world // n_seed
    (at least 1). The world size must divide n_genome * n_seed."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if n_genome is None:
        n_genome = max(1, world // n_seed)
    n_genome, n_seed, world, rank = int(n_genome), int(n_seed), int(world), int(rank)
    if n_genome < 1 or n_seed < 1 or (n_genome * n_seed) % world:
        raise ValueError(
            f"mesh {n_genome}x{n_seed} ({n_genome * n_seed} shards) does not divide over {world} ranks")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    return Mesh((n_genome, n_seed), world, rank, torch.device(device))
