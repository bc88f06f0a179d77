"""Device meshes for scaling the batched solver over several devices.

The workload is instance-data-parallel: independent circuit instances split
over the ``data`` axis and need no communication while they solve.  A
:class:`Mesh` here is an ordered tuple of ``torch.device`` entries and the
axis names, the counterpart of the JAX package's ``jax.sharding.Mesh`` over
``jax.devices()``.  An entry may repeat: two shards on one card (or
``["cpu"] * k``) is how a machine with one device runs more than one shard.

The batch axis is split into contiguous slices, one per entry, entry i
taking instances ``[i * per, min((i + 1) * per, B))`` with ``per = ceil(B /
size)`` (:func:`shard_bounds`, the arithmetic of
:func:`~acvm_tpu_torch.parallel.distributed.process_batch_slice`): the
counterpart of the JAX package's ``P("data")`` on the batch.  A slice may be
empty where B < size.  The JAX package's ``rows_sharding`` (the S axis of the
TPU's rows layout) has no counterpart: the port has one layout, ``(NW, B,
8)``, and shards its instance axis.

A mesh built by :func:`~acvm_tpu_torch.parallel.distributed.global_mesh` has
one entry per rank of a ``torch.distributed`` job (``ranks``): each process
solves its own entry's slice and the results are gathered
(:class:`~acvm_tpu_torch.gpu.batch_solver.BatchSolver`).
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """``devices``: one ``torch.device`` an entry of the ``data`` axis;
    ``ranks``: the ``torch.distributed`` rank that owns each entry, or None
    when every entry lies in this process."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    def local_entries(self, rank: Optional[int] = None) -> List[int]:
        """The entries this process solves: all of them, or those of ``rank``."""
        if self.ranks is None:
            return list(range(self.size))
        return [i for i, r in enumerate(self.ranks) if r == rank]


def as_device(d) -> torch.device:
    """A device name or ``torch.device`` with the index of a bare ``cuda``."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def on_device(device: torch.device):
    """Make ``device`` current where it is a card (a kernel launches on the
    current device's stream); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = "data") -> Mesh:
    """A mesh over ``devices`` (names or ``torch.device``s, repeats allowed),
    by default every visible CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible (pass devices=['cpu', ...])")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(as_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devices, (axis_name,))


def shard_bounds(total: int, size: int) -> List[Tuple[int, int]]:
    """The contiguous instance slice ``(lo, hi)`` of each of ``size`` entries."""
    per = (total + size - 1) // size if size else 0
    return [(min(i * per, total), min((i + 1) * per, total)) for i in range(size)]


def batch_sharding(mesh: Mesh, total: int, axis_name: str = "data") -> List[Tuple[int, int]]:
    """The instance slices of a batch of ``total`` over the mesh's entries."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"batch_sharding: the mesh has no axis {axis_name!r}")
    return shard_bounds(total, mesh.size)


def shard_batch(arrays, mesh: Mesh, axis_name: str = "data"):
    """Batch-major tensors (a tensor, or a list / tuple / dict of them) ->
    one such structure an entry: its slice of the leading axis, on its
    device."""
    def leading(a):
        if isinstance(a, dict):
            return leading(next(iter(a.values())))
        if isinstance(a, (list, tuple)):
            return leading(a[0])
        return a.shape[0]

    def put(a, lo, hi, device):
        if isinstance(a, dict):
            return {k: put(v, lo, hi, device) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(put(v, lo, hi, device) for v in a)
        return torch.as_tensor(a[lo:hi]).to(device)

    bounds = batch_sharding(mesh, leading(arrays), axis_name)
    return [put(arrays, lo, hi, d) for (lo, hi), d in zip(bounds, mesh.devices)]


def shard_state(state, mesh: Mesh, axis_name: str = "data"):
    """A solver state ``(W, ok, fail, mem)`` -> one state an entry: the
    panel ``(NW, B, 8)`` and the memory stacks ``(K, size, B, 8)`` split on
    their instance axis, ``ok`` / ``fail`` on their only one."""
    W, ok, fail, mem = state
    bounds = batch_sharding(mesh, int(ok.shape[0]), axis_name)
    return [(W[:, lo:hi].to(d), ok[lo:hi].to(d), fail[lo:hi].to(d),
             {size: m[:, :, lo:hi].to(d) for size, m in mem.items()})
            for (lo, hi), d in zip(bounds, mesh.devices)]
