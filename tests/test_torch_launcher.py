"""The port's launcher and mesh (hygeia_tpu_torch/parallel/{launcher,mesh}.py)
on the CPU: tests/test_launcher.py's two-process check on gloo, with a
``file://`` rendezvous under the test's directory (no port to collide
on), and the launcher's and the mesh's refusals."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hygeia_tpu_torch.parallel import launcher
from hygeia_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from hygeia_tpu_torch.parallel.launcher import initialize_distributed, is_primary_host
from hygeia_tpu_torch.parallel.mesh import make_mesh

pid, rendezvous = int(sys.argv[1]), sys.argv[2]
assert is_primary_host()  # no group yet
idx, count = initialize_distributed(f"file://{rendezvous}", 2, pid, backend="gloo")
assert (idx, count) == (pid, 2), (idx, count)
assert initialize_distributed() == (pid, 2)  # a second call is safe
assert is_primary_host() == (pid == 0)
mesh = make_mesh(4, 1, device="cpu")
assert (mesh.world, mesh.rank) == (2, pid) and mesh.shards() == [(2 * pid, 0), (2 * pid + 1, 0)]
local = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 100.0 * pid
total = local.sum()
dist.all_reduce(total)
print("RESULT", float(total), flush=True)
dist.destroy_process_group()
"""


def test_two_process_distributed_all_reduce(tmp_path):
    """Two processes join one gloo group through initialize_distributed and
    sum across it: (0+..+5) + (100+..+105) = 630 on both; is_primary_host()
    holds on rank 0 only."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(pid), str(tmp_path / "rendezvous")],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    for out in outs:
        assert "RESULT 630.0" in out, out


def test_without_a_group_it_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert launcher.initialize_distributed() == (0, 1)
    assert launcher.is_primary_host()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("backend,error", [(None, RuntimeError), ("nccl", RuntimeError), ("mpi", ValueError)])
def test_the_backend_is_never_picked_silently(tmp_path, monkeypatch, backend, error):
    """NCCL (the default) needs a card for each rank: on a host without one
    it raises and names gloo; an unknown backend raises; nothing joins."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.delenv("HYGEIA_DIST_BACKEND", raising=False)
    with pytest.raises(error, match="gloo"):
        launcher.initialize_distributed(f"file://{tmp_path / 'r'}", 1, 0, backend=backend)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("shape,world", [((4, 2), 3), ((3, 1), 2), ((1, 1), 2)])
def test_mesh_must_divide_over_the_ranks(shape, world):
    with pytest.raises(ValueError, match=f"mesh {shape[0]}x{shape[1]}.*{world} ranks"):
        make_mesh(*shape, world=world, rank=0, device="cpu")


def test_mesh_shards_are_contiguous_in_genome_major_order():
    """Each rank owns a contiguous run of shards, genome-major: genome
    neighbours share a rank wherever they can; world 1 holds them all."""
    assert make_mesh(2, 2, device="cpu").shards() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    runs = [make_mesh(4, 2, world=4, rank=r, device="cpu").shards() for r in range(4)]
    assert runs == [[(g, 0), (g, 1)] for g in range(4)]
    runs = [make_mesh(3, 2, world=2, rank=r, device="cpu").shards() for r in range(2)]
    assert runs == [[(0, 0), (0, 1), (1, 0)], [(1, 1), (2, 0), (2, 1)]]
    assert make_mesh(n_seed=1, device="cpu").shape == (1, 1)
