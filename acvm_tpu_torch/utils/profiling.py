"""Observability: device traces and solver throughput counters.

* :func:`trace` is a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto) into the directory the caller
  passes.
* :class:`SolveStats` is wall-clock and throughput accounting for batched
  solves: ``BatchSolver.solve(..., stats=...)`` fills one in when given.  A
  segment's time then ends in ``torch.cuda.synchronize()`` (a CUDA panel), so
  it is the device's time and not the time to queue its launches; without
  stats nothing waits for the device until the flags are read.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_TRACE_NUMBER = itertools.count()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block (the host, and the CUDA device where there
    is one) and write its Chrome trace to
    ``log_dir/acvm_tpu_torch.<pid>.<n>.trace.json``.  Yields the
    ``torch.profiler.profile`` (its ``key_averages()`` give time by kernel),
    or None without a ``log_dir``, when nothing is traced::

        with profiling.trace("traces"):
            solver.solve(batch)
    """
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"acvm_tpu_torch.{os.getpid()}.{next(_TRACE_NUMBER)}.trace.json")
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)


@dataclass
class SolveStats:
    batch: int = 0
    total_ops: int = 0
    # Seconds of each segment's device levels, and of each segment's host
    # stages (gather to the host, the stages, write back).
    segment_seconds: List[float] = field(default_factory=list)
    host_stage_seconds: List[float] = field(default_factory=list)
    # Host packing, upload and panel build of the inputs.
    pack_seconds: float = 0.0
    # Host stages (one an opcode) that ran instance by instance through the
    # sequential solvers: no batched route exists for them, one raised
    # ``HostBatchFallback``, or the solver was built with host_batch=False.
    host_per_instance_stages: int = 0
    # Passes the batch was solved in: more than one where it was streamed.
    passes: int = 0

    @property
    def device_seconds(self) -> float:
        return sum(self.segment_seconds)

    @property
    def host_seconds(self) -> float:
        return sum(self.host_stage_seconds)

    @property
    def total_seconds(self) -> float:
        return self.device_seconds + self.host_seconds + self.pack_seconds

    def ops_per_second(self) -> float:
        t = self.total_seconds
        return (self.batch * self.total_ops / t) if t > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "batch": self.batch,
            "total_ops": self.total_ops,
            "device_seconds": self.device_seconds,
            "host_seconds": self.host_seconds,
            "pack_seconds": self.pack_seconds,
            "host_per_instance_stages": self.host_per_instance_stages,
            "passes": self.passes,
            "op_solves_per_second": self.ops_per_second(),
        }


class Timer:
    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
