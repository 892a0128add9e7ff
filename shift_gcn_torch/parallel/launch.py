"""Multi-process launch: detection, the default process group and each
rank's device.

The counterpart of the reference CLI's ``should_init_distributed``
(``cli/train.py``) for ``torch.distributed``, one process per GPU.  A
run is multi-process when a launcher says so, overridable with
``SGT_DISTRIBUTED=1/0``:

- torchrun: ``WORLD_SIZE`` > 1, with ``RANK``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
- SLURM: ``SLURM_NTASKS`` > 1 (``SLURM_PROCID``, ``SLURM_LOCALID``,
  ``SLURM_NNODES``);
- Open MPI: ``OMPI_COMM_WORLD_SIZE`` > 1 (``OMPI_COMM_WORLD_RANK``,
  ``OMPI_COMM_WORLD_LOCAL_RANK``, ``OMPI_COMM_WORLD_LOCAL_SIZE``).

SLURM and Open MPI launches need ``MASTER_ADDR`` and ``MASTER_PORT`` in
the environment for the rendezvous.  The backend follows
the device: NCCL for CUDA, gloo for the CPU.  ``cuda`` means
``cuda:<local rank>``, and that device is made current before anything
runs on it.  A default group that the caller has already initialized
is joined as it is, with its own backend (several gloo ranks can share
one card that way, which NCCL refuses).
"""

from __future__ import annotations

import os
from typing import Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

_FALSE = ("0", "false", "no", "off", "")


class RankEnv(NamedTuple):
    rank: int
    world: int
    local_rank: int
    local_world: int


def _int(env: Mapping[str, str], var: str) -> Optional[int]:
    try:
        return int(env.get(var, "") or "")
    except ValueError:
        return None


def should_init_distributed(env: Optional[Mapping[str, str]] = None
                            ) -> bool:
    """Whether a launcher started this process as one of several."""
    env = os.environ if env is None else env
    force = env.get("SGT_DISTRIBUTED")
    if force is not None:
        return force.strip().lower() not in _FALSE
    return any((_int(env, var) or 0) > 1 for var in (
        "WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"))


def rank_env(env: Optional[Mapping[str, str]] = None) -> RankEnv:
    """This process's rank, world size, local rank and ranks per node,
    from the first launcher whose variables are set (single process
    when none is)."""
    env = os.environ if env is None else env
    for world, rank, local, nodes, local_world in (
            ("WORLD_SIZE", "RANK", "LOCAL_RANK", None, "LOCAL_WORLD_SIZE"),
            ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
             "SLURM_NNODES", None),
            ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
             "OMPI_COMM_WORLD_LOCAL_RANK", None,
             "OMPI_COMM_WORLD_LOCAL_SIZE")):
        size = _int(env, world)
        if size is None:
            continue
        r = _int(env, rank) or 0
        per_node = _int(env, local_world) if local_world else None
        if per_node is None and nodes and _int(env, nodes):
            per_node = size // _int(env, nodes)
        return RankEnv(r, size, _int(env, local) or 0, per_node or size)
    return RankEnv(0, 1, 0, 1)


def rank_device(device="cuda", env: Optional[Mapping[str, str]] = None
                ) -> torch.device:
    """``cuda`` without an index means this rank's card,
    ``cuda:<local rank>``; any other device is kept as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank_env(env).local_rank)
    return device


def init_distributed(device="cuda", env: Optional[Mapping[str, str]] = None
                     ) -> torch.device:
    """Make this rank's device current and join the default process
    group, initializing it (NCCL on CUDA, gloo on the CPU, rendezvous at
    ``MASTER_ADDR:MASTER_PORT``) unless the caller already has.  Returns
    the device."""
    device = rank_device(device, env)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    env = os.environ if env is None else env
    info = rank_env(env)
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        if not env.get(var):
            raise RuntimeError(
                f"multi-process launch without {var}: set MASTER_ADDR and "
                "MASTER_PORT (torchrun sets both)")
    cuda = device.type == "cuda"
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=info.rank, world_size=info.world,
        device_id=device if cuda else None)
    return device


def node_count(env: Optional[Mapping[str, str]] = None) -> int:
    """Nodes of this launch: the world over the ranks per node."""
    info = rank_env(env)
    if not dist.is_initialized():
        return 1
    world = dist.get_world_size()
    per_node = info.local_world if info.world == world else world
    return max(1, world // max(1, per_node))
