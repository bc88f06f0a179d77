"""Build, load and count the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C launcher.  ``nvcc``
compiles it for ``sm_90a`` into ``acvm_tpu_torch/_build/<name>-<hash>.so`` at
first use (the hash covers the sources and the flags, so an edited source
rebuilds); ``ctypes`` loads it.  A kernel of :data:`VARIANTS` is built from
another source, or with extra defines: the wide-field modes (p > 2^255) of
``mul``, ``pow`` and ``batch_inv``, named ``<name>_wide``, and ``inv_wide``
from ``csrc/inv.cu``.  Nothing is built or loaded at import time, and
a failed build raises: there is no other route for a CUDA tensor.

``LAUNCHES`` counts kernel launches per kernel name.  A wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels its
path really went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("level", "mul", "pow", "dot", "pt_add", "dot_v1", "mul_v1", "pt_ladder", "batch_inv",
           "divmod", "brillig_vm", "sha256", "keccak", "blake2s", "mul_wide", "pow_wide",
           "batch_inv_wide", "ecdsa_mul", "inv_wide", "dot_mxu")
# Kernels built from a source other than csrc/<name>.cu, or with defines:
# name -> (source, defines).
VARIANTS = {
    "mul_wide": ("mul", ("ACVM_WIDE",)),
    "pow_wide": ("pow", ("ACVM_WIDE",)),
    "batch_inv_wide": ("batch_inv", ("ACVM_WIDE",)),
    "inv_wide": ("inv", ()),
}
PROBES = ("imad_rate", "mont_probe")
HEADERS = ("field.cuh", "ec.cuh", "pow.cuh", "divmod.cuh", "hash.cuh", "inv.cuh")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_HASH_ARGS = [_P, _LL, _LL, _P, _P, _P, _I, _P, _LL, _LL, _I, _P, _I, _LL]
# C launcher of each kernel: (symbol, argtypes).  Without argtypes ctypes would
# pass every pointer as a 32-bit int.
_SIGNATURES = {
    "mul": ("acvm_mont_mul", [_P, _P, _P, _LL, _I, _I, _P, _P]),
    # a, out, n, the chain's schedule words, field, stream.
    "pow": ("acvm_mont_pow", [_P, _P, _LL, _P, _P, _P]),
    "dot": ("acvm_mont_dot", [_P] * 8 + [_LL, _LL, _I, _I, _P, _P]),
    "level": ("acvm_fused_level", [_P, _P, _LL, _LL, _I, _I, _P, _P]),
    # Two operand views and the output view, each (pointer, point stride,
    # coordinate stride, instance stride), then pairs, instances, field, stream.
    "pt_add": ("acvm_pt_add", [_P, _LL, _LL, _LL] * 3 + [_LL, _LL, _P, _P]),
    "dot_v1": ("acvm_mont_dot_v1", [_P] * 5 + [_LL, _LL, _I, _P, _P]),
    "mul_v1": ("acvm_mont_mul_v1", [_P, _P, _P, _LL, _P]),
    # Base view (pointer, coordinate stride, instance stride), scalars, output
    # view, instances, field, stream.
    "pt_ladder": ("acvm_pt_ladder", [_P, _LL, _LL, _P, _P, _LL, _LL, _LL, _P, _P]),
    # a, out, rows G, columns L, rows a chunk, chunks a block, schedule words,
    # field, stream (fields/kernels.py::batch_inv_plan).
    "batch_inv": ("acvm_batch_inv", [_P, _P, _LL, _LL, _I, _I, _P, _P, _P]),
    # a, b, q, r, elements, bits of a to read, stream.
    "divmod": ("acvm_divmod", [_P, _P, _P, _P, _LL, _I, _P]),
    # The instruction table, opcodes, registers, memory, status, steps,
    # instances, registers an instance, memory cells, step budget, field words,
    # p - 2's chain, the launch plan (threads a block, table, registers and
    # memory on chip, shared bytes), stream.
    "brillig_vm": ("acvm_brillig_vm",
                   [_P, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P]),
    # The hash kernels (csrc/hash.cuh): the source (pointer, row stride,
    # instance stride, row / limb / shift tables), M, the sink (pointer, row
    # stride, instance stride, words a row, output rows), G, B; then keccak's
    # byte counts, or blake2s' multiples of p and their count; then the stream.
    "sha256": ("acvm_sha256", _HASH_ARGS + [_P]),
    "keccak": ("acvm_keccak", _HASH_ARGS + [_P, _P]),
    "blake2s": ("acvm_blake2s", _HASH_ARGS + [_P, _I, _P]),
    # u1, u2, Q (3, B, 8), the generator's window table, out (3, B, 8),
    # verifications, a = -3, field, stream.
    "ecdsa_mul": ("acvm_ecdsa_mul", [_P, _P, _P, _P, _P, _LL, _I, _P, _P]),
    # a, out, n, the field's divstep constants (fields/kernels.py::inv_constants), stream.
    "inv_wide": ("acvm_inv_wide", [_P, _P, _LL, _P, _P]),
    # vals, coeffs, qc, out, gates, instances, terms, field, stream.
    "dot_mxu": ("acvm_mont_dot_mxu", [_P, _P, _P, _P, _LL, _LL, _I, _P, _P]),
    # A probe of the card's multiply-add rate; no path of the solver runs it.
    "imad_rate": ("acvm_imad_rate", [_P, _I, _I, _I, _P]),
    # The candidate Montgomery products side by side: a, b, out, n, chain
    # length, variant, threads a block, field, stream.
    "mont_probe": ("acvm_mont_probe", [_P, _P, _P, _LL, _I, _I, _I, _P, _P]),
}
for _name, (_source, _) in VARIANTS.items():
    _SIGNATURES.setdefault(_name, _SIGNATURES.get(_source))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def source_path(name: str) -> Path:
    return CSRC / f"{VARIANTS.get(name, (name,))[0]}.cu"


def variant_flags(name: str) -> List[str]:
    """The ``-D`` switches kernel ``name`` is built with (none for a kernel
    built from its own source)."""
    return [f"-D{d}" for d in VARIANTS.get(name, ("", ()))[1]]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA kernels "
        "of acvm_tpu_torch cannot be built on this machine"
    )


def lib_path(name: str, defines: Iterable[str] = (), source: Optional[Path] = None) -> Path:
    """Where kernel ``name`` built with ``defines`` lives: named by a hash of
    its source, every header of :data:`HEADERS` and the flags.  An explicit
    ``source`` (another tree's copy) hashes the headers its tree has; the
    package's own kernels need every one."""
    base = source.parent if source else CSRC
    defines = [*variant_flags(name), *defines]
    h = hashlib.sha256()
    for path in (source or source_path(name), *(base / header for header in HEADERS)):
        if source is None or path.exists():
            h.update(path.read_bytes())
    h.update(" ".join([*NVCC_FLAGS, *defines]).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS, extra_flags: List[str] = ()) -> Dict[str, object]:
    """Compile the named kernels that are not built yet, all ``nvcc`` runs
    started together.  Returns ``{"seconds": wall time, "built": [names],
    "log": {name: compiler output}}``; raises if any compile fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists() and not extra_flags:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *variant_flags(name), *extra_flags, "-I", str(CSRC),
               "-o", str(tmp), str(source_path(name))]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, cmd,
        )
    log = {}
    failed = []
    for name, (proc, tmp, out, cmd) in procs.items():
        text, _ = proc.communicate()
        log[name] = text
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs), "log": log}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def load_variant(name: str, defines: Iterable[str], source: Optional[Path] = None,
                 signature: Optional[tuple] = None):
    """The C launcher of kernel ``name`` compiled with extra ``-D`` switches
    (the measurement switches a source documents), built beside the kernel's
    own library and not counted in ``LAUNCHES``.  ``source`` and
    ``signature`` name another copy of the kernel (an older tree's, with its
    headers beside it) and its launcher's ``(symbol, argtypes)``.  For
    measurements only: no path of the solver calls it."""
    flags = [f"-D{d}" for d in defines]
    out = lib_path(name, flags, Path(source) if source else None)
    source = Path(source) if source else source_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_nvcc(), *NVCC_FLAGS, *variant_flags(name), *flags, "-I", str(source.parent),
               "-o", str(out), str(source)]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{done.stdout}")
    symbol, argtypes = signature or _SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(out)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, *args) -> None:
    """Call the C launcher of kernel ``name`` and count the launch.  The
    launcher returns ``cudaGetLastError()``: a refused launch raises here."""
    fn = getattr(load(name), _SIGNATURES[name][0])
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: cudaError {err}")
    if name in LAUNCHES:
        LAUNCHES[name] += 1
