"""Multi-process setup: one process per card.

Port of `diffusestylegesture_tpu/parallel/multihost.py`. JAX's
`jax.distributed.initialize` + a global mesh become `init_process_group`
from the `torchrun` environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`) and a `DeviceMesh` over the world. Without
that environment the process is a world of one (its own group on a free
localhost port), so every collective of the parallel paths still runs.

On cards the backend is NCCL, rank r takes `cuda:LOCAL_RANK`, and a missing
CUDA or NCCL raises; gloo runs only where the caller asks for the CPU. Every
group has a `timeout`, so a rank that died makes the others raise in seconds
instead of hanging.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.device:
    """Join (or, already joined, keep) the default process group and return
    this rank's device: `cuda:LOCAL_RANK` (NCCL) or the CPU (gloo).

    `init_method`, `rank` and `world_size` default to the torchrun
    environment; without one the process is rank 0 of a world of one."""
    dev_type = torch.device(device).type
    if dev_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank))
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: device 'cuda' requested but "
                               "torch.cuda.is_available() is False; pass device='cpu'")
        if not dist.is_nccl_available():
            raise RuntimeError("multihost.initialize: this PyTorch has no NCCL")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device("cpu")
    if dist.is_initialized():
        return dev
    if init_method is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif world_size == 1:
            init_method = f"tcp://localhost:{free_port()}"
        else:
            raise RuntimeError("multihost.initialize: a world of several ranks needs "
                               "MASTER_ADDR / MASTER_PORT (torchrun sets them) or init_method=")
    kw = dict(device_id=dev) if dev_type == "cuda" else {}
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo", init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def global_mesh(axes: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None):
    """A `DeviceMesh` over every rank of the default group, shaped [world, 1, …]
    unless `shape` is given; the device type is the group's backend's."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("global_mesh: call multihost.initialize() first")
    world = dist.get_world_size()
    if shape is None:
        shape = [world] + [1] * (len(axes) - 1)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {world} ranks")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev_type, tuple(int(s) for s in shape), mesh_dim_names=tuple(axes))


def global_batch_from_host_local(mesh, batch, axis: str = "data"):
    """Each rank's host slice of the global batch (numpy or tensors, the same
    rows on every rank of an axis it does not shard) → tensors on the rank's
    device: its shard of the global batch. Every rank along `axis` must pass
    the same number of rows (checked with an all-gather)."""
    from . import comm

    group = mesh.get_group(axis)
    dev = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
           else torch.device("cpu"))
    out = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(dev)
           for k, v in batch.items()}
    rows = torch.tensor([len(next(iter(out.values())))], device=dev)
    counts = comm.all_gather_cat(rows, group)
    if bool((counts != counts[0]).any()):
        raise ValueError(f"ranks along {axis!r} hold different row counts {counts.tolist()}")
    return out


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
