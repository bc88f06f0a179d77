"""Multi-process glue: one batch over the ranks of a ``torch.distributed`` job.

Usage, in every process of the job::

    from acvm_tpu_torch.parallel import distributed
    distributed.initialize()             # from the launcher's or torchrun's environment
    mesh = distributed.global_mesh()     # one entry a rank: its own device
    solver = BatchSolver(plan, mesh=mesh)
    result = solver.solve(inputs)        # the global batch, the same on every rank

Every rank is handed the whole batch (as the JAX package's worker is): each
solves its own slice (:func:`process_batch_slice`), then the flags are
gathered so that every rank sees the whole batch, and so, on demand, are
witness rows, instance columns and the panel (each such read of a result is a
collective: every rank makes it, in the same order).  NCCL carries the
gathers where each rank owns its own card; gloo carries them (through host
tensors) on the CPU and where ranks share a card, which NCCL refuses.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh


def _env_int(*names) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def platform() -> str:
    """``ACVM_TPU_PLATFORM`` (set by the launcher), else ``cuda`` where a card
    is visible, else ``cpu``."""
    return os.environ.get("ACVM_TPU_PLATFORM") or ("cuda" if torch.cuda.is_available() else "cpu")


def local_device() -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the visible cards, so
    that ranks may share one), or the CPU."""
    if platform() == "cpu":
        return torch.device("cpu")
    local_rank = _env_int("LOCAL_RANK", "ACVM_TPU_PROCESS_ID", "RANK") or 0
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(world_size: int) -> str:
    """gloo on the CPU and where the ranks of this host outnumber its cards
    (NCCL refuses two ranks on one device); NCCL where each rank owns a card."""
    if platform() == "cpu":
        return "gloo"
    local_ranks = _env_int("LOCAL_WORLD_SIZE") or world_size
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``torch.distributed.init_process_group`` for this rank.  Arguments
    default to the launcher's ``ACVM_TPU_COORDINATOR`` (host:port) /
    ``ACVM_TPU_NUM_PROCESSES`` / ``ACVM_TPU_PROCESS_ID``, else torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.  Nothing
    tells a process of a cluster by itself: without them it raises."""
    if dist.is_initialized():
        return
    address = coordinator_address or os.environ.get("ACVM_TPU_COORDINATOR")
    if address is None and os.environ.get("MASTER_ADDR"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    world = num_processes if num_processes is not None else _env_int(
        "ACVM_TPU_NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("ACVM_TPU_PROCESS_ID", "RANK")
    if address is None or world is None or rank is None:
        raise ValueError(
            "distributed.initialize: give the coordinator address, the number of "
            "processes and this process's rank (or the launcher's / torchrun's environment)")
    backend = choose_backend(world)
    if address.rsplit(":", 1)[0] in ("localhost", "127.0.0.1"):
        # A job on this host: its collectives go over the loopback device
        # (gloo and NCCL otherwise pick one by the host name, which need not
        # resolve to an address the ranks can reach).
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank)


def initialize_from_env() -> None:
    """Initialize this process as one rank of a job spawned by
    :func:`~acvm_tpu_torch.parallel.launcher.launch_local`."""
    initialize(
        coordinator_address=os.environ["ACVM_TPU_COORDINATOR"],
        num_processes=int(os.environ["ACVM_TPU_NUM_PROCESSES"]),
        process_id=int(os.environ["ACVM_TPU_PROCESS_ID"]),
    )


def global_mesh(axis_name: str = "data") -> Mesh:
    """A 1-D mesh with one entry a rank, in rank order: each rank's own
    device (:func:`local_device`)."""
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(local_device()))
    return Mesh(tuple(torch.device(n) for n in names), (axis_name,), tuple(range(len(names))))


def process_batch_slice(total_batch: int) -> slice:
    """The contiguous slice of a global batch owned by this process."""
    n = dist.get_world_size()
    i = dist.get_rank()
    per = (total_batch + n - 1) // n
    return slice(min(i * per, total_batch), min((i + 1) * per, total_batch))


def collective_device() -> torch.device:
    """Where this job's collectives take their tensors: the rank's card under
    NCCL, the host under gloo."""
    return local_device() if dist.get_backend() == "nccl" else torch.device("cpu")


def all_gather_batch(local: torch.Tensor, bounds: Sequence[Tuple[int, int]], dim: int = 0
                     ) -> torch.Tensor:
    """Each rank's slice of a batch (rank r holds ``bounds[r]`` along ``dim``)
    -> the whole batch, on every rank, on :func:`collective_device`.  The
    slices are padded to the longest for the gather and trimmed after it."""
    per = max(hi - lo for lo, hi in bounds)
    dtype = local.dtype
    x = local.to(collective_device())
    if dtype == torch.bool:
        x = x.to(torch.uint8)
    if x.shape[dim] < per:
        pad = list(x.shape)
        pad[dim] = per - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in bounds]
    dist.all_gather(parts, x)
    whole = torch.cat([p.narrow(dim, 0, hi - lo) for p, (lo, hi) in zip(parts, bounds)], dim)
    return whole.to(dtype)


def broadcast_from(tensor: Optional[torch.Tensor], shape, dtype, src: int) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank (the others pass None), on
    :func:`collective_device`."""
    dev = collective_device()
    x = tensor.to(dev).contiguous() if dist.get_rank() == src else torch.empty(
        shape, dtype=dtype, device=dev)
    dist.broadcast(x, src)
    return x
