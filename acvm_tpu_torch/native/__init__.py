"""The host Grumpkin library: BN254-Fr and Grumpkin in C++, loaded with ctypes.

``grumpkin_native.cc`` (this package's own copy of the JAX package's
``acvm_tpu/native/grumpkin_native.cc``, the same C ABI,
``acvm_native_abi_version() == 1``) holds Montgomery BN254-Fr arithmetic on
4 x 64-bit limbs and Jacobian Grumpkin group operations: the host-side
replacement for the reference's barretenberg C++/WASM calls.  Its callers are
the window tables of the device MSM (:func:`acvm_tpu_torch.gpu.ec._window_table_np`)
and the host black boxes (:mod:`acvm_tpu_torch.blackbox.grumpkin`).

``g++ -O3 -shared -fPIC -std=c++17`` builds it at first use into
``acvm_tpu_torch/_build/`` (named by a hash of the source and the flags, so
an edited source rebuilds; written under a temporary name and renamed, so
processes that build at once do not see each other's half-written file).  A
failed build raises with g++'s output: there is no silent fallback.  The
pure-Python curve code (:mod:`acvm_tpu_torch.blackbox.ec`) is the plain
version, taken only where a caller asks for it (``native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

from ..build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "grumpkin_native.cc"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library built from this source with these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"acvm_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raise with g++'s output if the
    compile fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(f"the host Grumpkin library cannot be built: {' '.join(cmd)}: {exc}")
    if done.returncode != 0:
        raise RuntimeError(
            f"g++ failed to build the host Grumpkin library:\n{' '.join(cmd)}\n{done.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.grumpkin_mul.argtypes = [u8p, u8p, u8p]
        lib.grumpkin_msm.argtypes = [u8p, u8p, ctypes.c_size_t, u8p]
        lib.grumpkin_mul_batch.argtypes = [u8p, u8p, ctypes.c_size_t, u8p]
        lib.grumpkin_add.argtypes = [u8p, u8p, u8p]
        lib.bn254fr_mul_batch.argtypes = [u8p, u8p, ctypes.c_size_t, u8p]
        lib.bn254fr_inv_batch.argtypes = [u8p, ctypes.c_size_t, u8p]
        lib.acvm_native_abi_version.restype = ctypes.c_int
        version = lib.acvm_native_abi_version()
        if version != ABI_VERSION:
            raise RuntimeError(f"host Grumpkin library: ABI version {version}, want {ABI_VERSION}")
        _lib = lib
        return _lib


def _buf(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def _point_bytes(point: Optional[Tuple[int, int]]) -> bytes:
    if point is None:
        return b"\x00" * 64
    return point[0].to_bytes(32, "big") + point[1].to_bytes(32, "big")


def _bytes_point(data: bytes) -> Optional[Tuple[int, int]]:
    x = int.from_bytes(data[:32], "big")
    y = int.from_bytes(data[32:64], "big")
    if x == 0 and y == 0:
        return None
    return (x, y)


def grumpkin_mul(point, scalar: int):
    """scalar * point (affine ints, None for infinity); scalar < 2^256."""
    out = (ctypes.c_uint8 * 64)()
    load().grumpkin_mul(_buf(_point_bytes(point)), _buf(int(scalar).to_bytes(32, "big")), out)
    return _bytes_point(bytes(out))


def grumpkin_add(p1, p2):
    out = (ctypes.c_uint8 * 64)()
    load().grumpkin_add(_buf(_point_bytes(p1)), _buf(_point_bytes(p2)), out)
    return _bytes_point(bytes(out))


def grumpkin_msm(points: List, scalars: List[int]):
    """sum_i scalars[i] * points[i]."""
    if len(points) != len(scalars):
        raise ValueError("grumpkin_msm: as many scalars as points")
    pts = b"".join(_point_bytes(p) for p in points)
    ss = b"".join(int(s).to_bytes(32, "big") for s in scalars)
    out = (ctypes.c_uint8 * 64)()
    load().grumpkin_msm(_buf(pts or b"\x00"), _buf(ss or b"\x00"), len(points), out)
    return _bytes_point(bytes(out))


def grumpkin_mul_batch(point, scalars: List[int]):
    """[s * point for s in scalars]."""
    ss = b"".join(int(s).to_bytes(32, "big") for s in scalars)
    out = (ctypes.c_uint8 * (64 * len(scalars) or 1))()
    load().grumpkin_mul_batch(_buf(_point_bytes(point)), _buf(ss or b"\x00"), len(scalars), out)
    raw = bytes(out)
    return [_bytes_point(raw[64 * i : 64 * (i + 1)]) for i in range(len(scalars))]
