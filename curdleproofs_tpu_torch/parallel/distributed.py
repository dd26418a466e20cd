"""Multi-host process groups and work placement (the JAX package's
`parallel/distributed.py`, on `torch.distributed`).

Placement policy, as the reference's:
- WITHIN one MSM, shard points and windows over the devices of ONE process
  (`sharded_msm`, a grid of that process's devices).
- ACROSS proofs, shard the batch over processes: each verifies its own
  slice with its own accumulator and final MSM.  The random-linear-
  combination accumulator makes slices independently sound, so the only
  traffic between processes is the verdict reduction: one all-gather of an
  int32 a process, over gloo, whatever device each process's MSMs run on.

Two differences from the reference follow from that: `global_mesh` lays
out this process's devices only (the reference's spans the hosts of the
group, which its own policy keeps out of any one MSM), and the group is a
gloo process group that the caller points at a coordinator.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["init_multihost", "process_slice", "global_mesh",
           "all_hosts_agree", "distributed_batch_verify"]


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank_world() -> tuple[int, int]:
    if _in_group():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> tuple[int, int]:
    """Join (or create) the multi-host process group.

    No-op in a single-process run.  The coordinator "host:port", world size
    and rank come from the arguments or from CURDLEPROOFS_COORDINATOR /
    _NPROCS / _PROCID.  Idempotent.  Returns (rank, world size).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "CURDLEPROOFS_COORDINATOR")
    if num_processes is None and os.environ.get("CURDLEPROOFS_NPROCS"):
        num_processes = int(os.environ["CURDLEPROOFS_NPROCS"])
    if process_id is None and os.environ.get("CURDLEPROOFS_PROCID"):
        process_id = int(os.environ["CURDLEPROOFS_PROCID"])
    if (coordinator_address or (num_processes or 0) > 1) and not _in_group():
        if not coordinator_address or num_processes is None \
                or process_id is None:
            raise ValueError("a process group needs the coordinator "
                             "host:port, the world size and this rank")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    return _rank_world()


def process_slice(n_items: int) -> slice:
    """This process's contiguous shard of an n_items batch."""
    rank, world = _rank_world()
    per = -(-n_items // world)
    return slice(rank * per, min(n_items, (rank + 1) * per))


def global_mesh(n_window_shards: int = 1,
                axes: tuple[str, str] = ("points", "windows"),
                devices=None):
    """Mesh over this process's devices (`sharded_msm.make_msm_mesh`:
    every visible card unless `devices` names them)."""
    from .sharded_msm import make_msm_mesh

    return make_msm_mesh(None, n_window_shards, axes, devices)


def all_hosts_agree(local_ok: bool) -> bool:
    """AND-reduce a local verdict across the process group (one all-gather
    of an int32 a process; trivially the local verdict in a single-process
    run)."""
    _, world = _rank_world()
    if world == 1:
        return bool(local_ok)
    flag = torch.tensor([1 if local_ok else 0], dtype=torch.int32)
    flags = [torch.zeros_like(flag) for _ in range(world)]
    dist.all_gather(flags, flag)
    return bool(min(int(f) for f in flags) == 1)


def distributed_batch_verify(crs, instances, proofs, rng,
                             local_mesh=None) -> bool:
    """Verify a proof batch sharded across processes, each with its own
    accumulator (its final MSM sharded over `local_mesh` when given).

    Every process must call this with the SAME full batch; each verifies
    only `process_slice(len(proofs))` and the verdicts AND-reduce.
    """
    from .batch_verify import batch_verify

    sl = process_slice(len(proofs))
    ok = batch_verify(crs, instances[sl], proofs[sl], rng, mesh=local_mesh)
    return all_hosts_agree(bool(ok))
