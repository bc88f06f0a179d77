"""Solver throughput counters.

:class:`SolveStats` is wall-clock and throughput accounting for batched
solves: ``BatchSolver.solve(..., stats=...)`` fills one in when given.  A
segment's time then ends in ``torch.cuda.synchronize()`` (a CUDA panel), so
it is the device's time and not the time to queue its launches; without
stats nothing waits for the device until the flags are read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List


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
