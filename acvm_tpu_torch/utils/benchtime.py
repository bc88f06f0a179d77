"""Shared timing helpers for measurements on the card.

Two hazards make a host clock read the wrong thing:

1. CUDA launches return before the device runs them, so a timed region must
   end with the device done: :func:`sync` waits for the device and reads one
   element back to the host.
2. That readback itself costs a round trip (:func:`measure_rtt`); an elapsed
   time not much larger than it measures the round trip, not the work.

:func:`timed_rate` is the one guarded way to turn (work, elapsed) into a
rate: it subtracts one round trip and *refuses* (returns None) when the
elapsed time is not at least ``min_ratio`` round trips; the caller must then
increase the work, never clamp.
"""

from __future__ import annotations

import time
from typing import Optional

_RTT_CACHE: list = []


def sync(x) -> None:
    """Wait for the device, then read one element of ``x`` back to the
    host."""
    import torch

    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    x[tuple(0 for _ in x.shape)].item()


def measure_rtt() -> float:
    """Seconds of a small launch and its readback on the current CUDA device
    (the least of 7, cached).  Raises ``RuntimeError`` without a card: there
    is no device round trip to measure."""
    if not _RTT_CACHE:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("measure_rtt: no CUDA device")
        x = torch.ones((8, 128), dtype=torch.int32, device="cuda")
        x = x + 1
        sync(x)
        samples = []
        for _ in range(7):
            t0 = time.perf_counter()
            x = x + 1
            sync(x)
            samples.append(time.perf_counter() - t0)
        _RTT_CACHE.append(min(samples))
    return _RTT_CACHE[0]


def timed_rate(
    work: float, elapsed: float, rtt: Optional[float] = None,
    min_ratio: float = 2.0,
) -> Optional[float]:
    """``work / (elapsed - rtt)``, or None when the measurement is
    dominated by the round trip (elapsed <= min_ratio * rtt) and must be
    retried with more work rather than reported."""
    if rtt is None:
        rtt = measure_rtt()
    if elapsed <= min_ratio * rtt:
        return None
    return work / (elapsed - rtt)
