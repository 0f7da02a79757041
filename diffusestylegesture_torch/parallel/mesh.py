"""Device meshes and batch placement.

Port of `diffusestylegesture_tpu/parallel/mesh.py`. JAX has one kind of mesh
(single-controller, global arrays); the port has two:

* `make_mesh` → `LocalMesh`: the cards of this process as an array with named
  axes, for single-process serving (`ZeggsSampler.generate(mesh=)`,
  `BeatTwhSampler.generate(mesh=)`): one replica of the model per card, each
  card its rows of the batch.
* `multihost.global_mesh` → `torch.distributed.device_mesh.DeviceMesh`: one
  process per card (`torchrun`), for training; its axes carry the JAX names
  (`data`, `model`, `seq`, `pipe`, `expert`) and each axis a process group.

`replicated` / `data_sharded` name a placement on either, `shard_batch` gives
each card (or this rank) its rows, and `replicate` copies a tree to every
card (or broadcasts it from rank 0).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class LocalMesh:
    """The cards of one process, `devices` an object array of `torch.device`
    whose axes are named `axis_names`."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The cards along `axis`, at index 0 of every other axis."""
        d = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[d] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(axes: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> LocalMesh:
    """A mesh over `devices` (default: every visible card), shaped [n, 1, …]
    unless `shape` is given. No card and no devices raises: pass
    `devices=[torch.device("cpu")] * n` to run on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card is visible; pass devices= "
                               "(e.g. [torch.device('cpu')] * 2) to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = [len(devices)] + [1] * (len(axes) - 1)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return LocalMesh(arr.reshape(tuple(shape)), axes)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A tensor's layout on a mesh: sharded on its leading axis over `axis`,
    or replicated (`axis` None)."""

    mesh: object
    axis: Optional[str] = None


def replicated(mesh) -> Placement:
    return Placement(mesh, None)


def data_sharded(mesh, axis: str = "data") -> Placement:
    """Batch-axis (leading dim) sharding."""
    return Placement(mesh, axis)


def _is_local(mesh) -> bool:
    return isinstance(mesh, LocalMesh)


def row_bounds(batch: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of each part when `batch` rows split into `parts` in
    order, the first `batch % parts` parts one row longer."""
    cuts = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(batch), parts)])
    return [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])]


def _axis_rank(mesh, axis: str) -> Tuple[int, int]:
    return mesh.size(axis), mesh.get_local_rank(axis)


def shard_batch(mesh, batch, axis: str = "data"):
    """Rows of a dict (or tensor) of (B, …) arrays along `axis`.

    LocalMesh: a list, one entry a card of the axis, each its rows on that
    card. DeviceMesh: this rank's rows (every rank passes the same global
    batch; for each rank's own slice see `multihost.global_batch_from_host_local`),
    on the rank's device."""
    def rows(x, lo, hi, dev):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)[lo:hi].to(dev)

    def apply(lo, hi, dev):
        if isinstance(batch, dict):
            return {k: rows(v, lo, hi, dev) for k, v in batch.items()}
        return rows(batch, lo, hi, dev)

    first = next(iter(batch.values())) if isinstance(batch, dict) else batch
    B = len(first)
    if _is_local(mesh):
        devs = mesh.axis_devices(axis)
        return [apply(lo, hi, dev) for (lo, hi), dev in zip(row_bounds(B, len(devs)), devs)]
    n, r = _axis_rank(mesh, axis)
    if B % n:
        raise ValueError(f"batch {B} does not divide over {axis}={n}")
    lo, hi = row_bounds(B, n)[r]
    return apply(lo, hi, torch.device(mesh.device_type, torch.cuda.current_device())
                 if mesh.device_type == "cuda" else torch.device("cpu"))


def replicate(mesh, tree):
    """LocalMesh: a list of copies of the tensor (or dict of tensors), one a
    card. DeviceMesh: every tensor broadcast in place from global rank 0."""
    import torch.distributed as dist

    tensors = list(tree.values()) if isinstance(tree, dict) else [tree]
    if _is_local(mesh):
        copies = []
        for dev in mesh.devices.flat:
            copies.append({k: v.to(dev) for k, v in tree.items()} if isinstance(tree, dict)
                          else tree.to(dev))
        return copies
    if dist.get_world_size() > 1:
        for t in tensors:
            dist.broadcast(t, src=0)
    return tree
