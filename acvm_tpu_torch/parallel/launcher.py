"""Launch N ranks of a worker on this machine as one ``torch.distributed`` job.

* :func:`launch_local` spawns ``[python] argv`` once a rank with the
  environment :func:`~acvm_tpu_torch.parallel.distributed.initialize_from_env`
  reads (``ACVM_TPU_COORDINATOR`` = ``localhost:<free port>``,
  ``ACVM_TPU_NUM_PROCESSES``, ``ACVM_TPU_PROCESS_ID``, ``ACVM_TPU_PLATFORM``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), waits for all, and raises with every
  failing rank's output (the other ranks are stopped at the first failure).
  With ``platform="cpu"`` the ranks run on the host over gloo; with
  ``"cuda"`` rank r takes ``cuda:(r mod cards)``: NCCL where each rank owns a
  card, gloo where they share one.
* ``python -m acvm_tpu_torch.parallel.launcher --num-processes 2 --platform
  cpu worker.py [args]`` does the same from a shell.

The CUDA kernels and the host Grumpkin library are built before the ranks
start, so that the ranks find them built and do not compile into
``acvm_tpu_torch/_build/`` at once.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def prebuild(platform: str) -> None:
    """Build what the ranks would otherwise each build at first use."""
    from .. import build, native

    native.build()
    if platform == "cuda":
        build.build()


def launch_local(
    num_processes: int,
    argv: Sequence[str],
    *,
    platform: str = "cpu",
    port: Optional[int] = None,
    timeout: float = 900,
) -> List[subprocess.CompletedProcess]:
    """Run ``num_processes`` ranks of ``[python] argv`` as one job; returns
    their completed processes in rank order, or raises ``RuntimeError`` with
    each failing rank's output."""
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"launch_local: platform must be 'cpu' or 'cuda', not {platform!r}")
    prebuild(platform)
    port = port or _free_port()
    base_env = dict(os.environ)
    procs = []
    with tempfile.TemporaryDirectory() as logs:
        for rank in range(num_processes):
            rank_env = dict(base_env)
            rank_env.update(
                ACVM_TPU_COORDINATOR=f"localhost:{port}",
                ACVM_TPU_NUM_PROCESSES=str(num_processes),
                ACVM_TPU_PROCESS_ID=str(rank),
                ACVM_TPU_PLATFORM=platform,
                LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(num_processes),
            )
            out = open(os.path.join(logs, f"{rank}.out"), "w+")
            err = open(os.path.join(logs, f"{rank}.err"), "w+")
            procs.append((subprocess.Popen([sys.executable, *argv], env=rank_env, stdout=out,
                                           stderr=err, text=True), out, err))
        deadline = time.monotonic() + timeout
        why = {}
        while any(p.poll() is None for p, _, _ in procs):
            failed = any(p.poll() not in (None, 0) for p, _, _ in procs)
            if failed or time.monotonic() > deadline:
                for rank, (p, _, _) in enumerate(procs):
                    if p.poll() is None:
                        why[rank] = "stopped: another rank failed" if failed else "timeout"
                        p.kill()
                        p.wait()
                break
            time.sleep(0.05)
        done, failures = [], []
        for rank, (p, out, err) in enumerate(procs):
            p.wait()
            out.seek(0)
            err.seek(0)
            result = subprocess.CompletedProcess(p.args, p.returncode, out.read(), err.read())
            out.close()
            err.close()
            done.append(result)
            if p.returncode != 0:
                failures.append((rank, why.get(rank, f"rc={p.returncode}"), result))
    if failures:
        detail = "\n".join(f"--- rank {r} ({w})\nstdout:\n{c.stdout}\nstderr:\n{c.stderr}"
                           for r, w, c in failures)
        raise RuntimeError(f"distributed launch failed:\n{detail}")
    return done


def main(args: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Launch N local ranks of a distributed acvm_tpu_torch worker.")
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--platform", default="cpu", choices=["cpu", "cuda"])
    parser.add_argument("--timeout", type=float, default=900)
    parser.add_argument("worker", nargs=argparse.REMAINDER)
    ns = parser.parse_args(args)
    if not ns.worker:
        parser.error("worker script (and its args) required")
    results = launch_local(ns.num_processes, ns.worker, platform=ns.platform,
                           timeout=ns.timeout)
    for rank, r in enumerate(results):
        sys.stdout.write(f"--- rank {rank}\n{r.stdout}")


if __name__ == "__main__":
    main()
