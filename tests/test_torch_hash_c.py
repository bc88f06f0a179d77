"""The C of the SHA-256, BLAKE2s and Keccak kernels, run on the CPU.

``csrc/sha256.cu``, ``csrc/blake2s.cu`` and ``csrc/keccak.cu`` are compiled
with ``g++`` against the stub ``cuda_runtime.h`` below: the CUDA qualifiers
as nothing, ``__ldg``, ``__funnelshift_r`` and ``__byte_perm`` in C,
``__syncwarp`` and ``__reduce_max_sync`` of a one-lane warp, the message
stage's copy (``hash.cuh``'s ``stage_copy``) as a plain copy or a zero fill,
and ``HASH_STAGE_LAUNCH`` as a host loop over the grid (``field.cuh``'s
borrow chain, which BLAKE2s' hash-to-field mode runs, has a plain-C form
outside nvcc).  ``INV_LAUNCH`` serves ``tests/test_torch_inv_c.py``'s build of
``csrc/inv.cu``.  The block is one lane (``-DHASH_WARP=1``), so a block's staging runs in
order.  Each kernel is built twice: with its tables in shared memory whole,
and with ``-DHASH_TABLE_CAP=64``, so that every message longer than 64 bytes
stages its table entries block by block beside its words.

The launchers, with their own argument lists (``build._SIGNATURES``), are
called through ``gadgets._launch`` on CPU tensors, in the panel form (random
row / limb / shift tables, G gadgets) and the matrix form, at the lengths
where the padding changes and at 1,000 bytes (the two-stage ring wraps), and
held to the plain versions and to hashlib / the host Keccak; BLAKE2s also in
hash-to-field mode, held to ``digest_to_field_plain``.  The card runs the same
shapes in ``tests/test_torch_gpu.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from acvm_tpu_torch import build
from acvm_tpu_torch.blackbox.hashes import keccak256
from acvm_tpu_torch.fields import kernels as fk
from acvm_tpu_torch.fields.kernels import LIMBS
from acvm_tpu_torch.fields.params import BLS12_381_FR, BN254_FR
from acvm_tpu_torch.gpu import gadgets

STUB = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__
#define __align__(n)
#define __launch_bounds__(n)
#define __grid_constant__
using std::min;
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return uint4{a, b, c, d}; }
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t n) {
    n &= 31;
    return n ? (lo >> n) | (hi << (32 - n)) : lo;
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
    const uint64_t v = (uint64_t)y << 32 | x;
    uint32_t r = 0;
    for (int k = 0; k < 4; ++k) r |= (uint32_t)(v >> (8 * ((s >> (4 * k)) & 7)) & 0xFF) << (8 * k);
    return r;
}
inline void __syncwarp() {}
inline int __reduce_max_sync(unsigned, int v) { return v; }
inline void stage_copy(uint32_t* dst, const uint32_t* src, bool valid) { *dst = valid ? *src : 0u; }
inline void stage_commit() {}
inline void stage_wait_prior() {}
inline uint32_t hash_smem[1 << 16];
#define HASH_STAGE_LAUNCH(kernel, grid, smem, stream, ...)      \
    do {                                                        \
        const dim3 grid_ = (grid);                              \
        if ((size_t)(smem) > sizeof(hash_smem)) return 1;       \
        for (unsigned y = 0; y < grid_.y; ++y)                  \
            for (unsigned x = 0; x < grid_.x; ++x) {            \
                blockIdx = dim3(x, y);                          \
                threadIdx = dim3(0);                            \
                kernel(__VA_ARGS__);                            \
            }                                                   \
    } while (0)
#define INV_LAUNCH(kernel, blocks, threads, stream, ...)        \
    do {                                                        \
        blockDim = dim3(threads);                               \
        for (unsigned x = 0; x < (unsigned)(blocks); ++x)       \
            for (unsigned t = 0; t < (unsigned)(threads); ++t) { \
                blockIdx = dim3(x);                             \
                threadIdx = dim3(t);                            \
                kernel(__VA_ARGS__);                            \
            }                                                   \
    } while (0)
"""

CAPS = (None, 64)  # the default table capacity (1,024 entries), and 64
SHA_LENGTHS = (1, 55, 56, 63, 64, 119, 120, 1000)
BLAKE2S_LENGTHS = (0, 1, 32, 55, 56, 63, 64, 65, 127, 128, 129, 1000)
KECCAK_LENGTHS = (1, 135, 136, 137, 272, 1000)


def _compile(out, name, defines):
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    *(f"-D{d}" for d in defines), "-I", str(out.parent), "-o", str(out),
                    str(build.source_path(name))], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def cpu_builds(tmp_path_factory):
    """(kernel, cap) -> the C launcher of a one-lane CPU build, and kernel ->
    the library of a build at the card's block width (never launched)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    stub = tmp_path_factory.mktemp("hash_c")
    (stub / "cuda_runtime.h").write_text(STUB)
    launchers, full_width = {}, {}
    for name in ("sha256", "blake2s", "keccak"):
        symbol, argtypes = build._SIGNATURES[name]
        for cap in CAPS:
            defines = ["HASH_WARP=1", *([f"HASH_TABLE_CAP={cap}"] if cap else [])]
            fn = getattr(_compile(stub / f"{name}-{cap}.so", name, defines), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            launchers[name, cap] = fn
        full_width[name] = _compile(stub / f"{name}-warp.so", name, [])
    return launchers, full_width


@pytest.fixture
def on_cpu(cpu_builds, monkeypatch):
    """``gadgets._launch`` and ``_digest_on_card`` routed to the CPU build of
    one table capacity: returns a setter of that capacity."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=None))
    chosen = {}

    def launch(name, *args):
        assert cpu_builds[0][name, chosen["cap"]](*args) == 0, name

    monkeypatch.setattr(build, "launch", launch)
    return lambda cap: chosen.update(cap=cap)


def _messages(B, M, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, size=(B, M)))


def _var_lengths(B, M, seed):
    """Lengths 0 ... M with the padding's edges first."""
    edges = [v for v in (0, 1, 135, 136, 137, M) if v <= M]
    length = np.random.default_rng(seed).integers(0, M + 1, size=B)
    length[:min(B, len(edges))] = edges[:B]
    return torch.from_numpy(length.astype(np.int32))


def _panel_case(kind, G, B, M, seed):
    """A panel with G gadgets' random (row, limb, shift) tables over rows
    0 ... 29 and their digest rows above (one a gadget for hash-to-field);
    keccak_var's lengths."""
    rng = np.random.default_rng(seed)
    n_out = 1 if kind == "hash_to_field" else 32
    NW = 30 + n_out * G
    W = torch.from_numpy(rng.integers(-2**31, 2**31, size=(NW, B, LIMBS)).astype(np.int32))
    tables = [torch.from_numpy(t.astype(np.int32)) for t in (
        rng.integers(0, 30, size=(G, M)), rng.integers(0, LIMBS, size=(G, M)),
        8 * rng.integers(0, 4, size=(G, M)))]
    out_idx = torch.from_numpy((30 + rng.permutation(n_out * G)).reshape(G, n_out).astype(np.int32))
    length = None
    if kind == "keccak_var":
        length = torch.stack([_var_lengths(B, M, seed + 1 + g) for g in range(G)])
    return W, tables, out_idx, length


def _panel_on_cpu(kind, W, tables, out_idx, length, modulus=None):
    """hash_rows' launch, on CPU tensors."""
    G, M = tables[0].shape
    B = W.shape[1]
    gadgets._launch(kind, (W, B * LIMBS, LIMBS), tables, M, (W, B * LIMBS, LIMBS, LIMBS), out_idx, G,
                    B, length=length,
                    subtrahends=None if modulus is None else gadgets.to_field_subtrahends(modulus))
    return W


def _check_panel(kind, G, B, M, seed, modulus=None):
    W, tables, out_idx, length = _panel_case(kind, G, B, M, seed)
    want = gadgets.hash_rows_plain(kind, W.clone(), *tables, out_idx, length, modulus)
    got = _panel_on_cpu(kind, W.clone(), tables, out_idx, length, modulus)
    assert torch.equal(got, want), (kind, G, B, M)
    return got, want, out_idx


@pytest.mark.parametrize("cap", CAPS, ids=("tables_whole", "tables_staged"))
@pytest.mark.parametrize("M", SHA_LENGTHS)
def test_sha256_c_equals_plain_version_and_hashlib(on_cpu, cap, M):
    on_cpu(cap)
    for B in (1, 31, 33):
        msg = _messages(B, M, M + B)
        got = gadgets._digest_on_card("sha256", msg)
        assert torch.equal(got, gadgets.sha256_digest_plain(msg)), B
        for b in (0, B - 1):
            assert bytes(got[b].tolist()) == hashlib.sha256(bytes(msg[b].tolist())).digest()
    _check_panel("sha256", 3, 5, M, M)
    _check_panel("sha256", 1, 33, M, M + 1)


@pytest.mark.parametrize("cap", CAPS, ids=("tables_whole", "tables_staged"))
@pytest.mark.parametrize("M", BLAKE2S_LENGTHS)
def test_blake2s_c_equals_plain_version_hashlib_and_to_field(on_cpu, cap, M):
    """The matrix form (Schnorr's challenge), the panel form, and the
    panel's hash-to-field mode in BN254 and BLS12-381 (the digest read
    big-endian, less 4p / 2p / p where each fits)."""
    on_cpu(cap)
    for B in (1, 31, 33):
        msg = _messages(B, M, M + B)
        got = gadgets._digest_on_card("blake2s", msg)
        assert torch.equal(got, gadgets.blake2s_digest_plain(msg)), B
        for b in (0, B - 1):
            assert bytes(got[b].tolist()) == hashlib.blake2s(bytes(msg[b].tolist())).digest()
    _check_panel("blake2s", 3, 5, M, M)
    _check_panel("blake2s", 1, 33, M, M + 1)
    W, (rows, limbs, shifts), _, _ = _panel_case("hash_to_field", 2, 33, M, M + 2)
    for modulus in (BN254_FR.modulus, BLS12_381_FR.modulus):
        got, _, out_idx = _check_panel("hash_to_field", 2, 33, M, M + 2, modulus)
        for g, b in ((0, 0), (1, 32)):  # hashlib's digest, big-endian, mod p
            msg = bytes(int(W[rows[g, j], b, limbs[g, j]]) >> int(shifts[g, j]) & 0xFF for j in range(M))
            want = int.from_bytes(hashlib.blake2s(msg).digest(), "big") % modulus
            assert fk.limbs32_to_ints(got[int(out_idx[g, 0]), b].numpy()) == [want], (g, b)


@pytest.mark.parametrize("cap", CAPS, ids=("tables_whole", "tables_staged"))
@pytest.mark.parametrize("M", KECCAK_LENGTHS)
def test_keccak_c_equals_plain_versions_and_host_keccak(on_cpu, cap, M):
    on_cpu(cap)
    for B in (1, 31, 33):
        msg = _messages(B, M, M + B)
        got = gadgets._digest_on_card("keccak256", msg)
        assert torch.equal(got, gadgets.keccak256_digest_plain(msg)), B
        assert bytes(got[B - 1].tolist()) == keccak256(bytes(msg[B - 1].tolist()))
        length = _var_lengths(B, M, M + B)
        got = gadgets._digest_on_card("keccak_var", msg, length)
        assert torch.equal(got, gadgets.keccak256_var_digest_plain(msg, length)), B
        for b in (0, B - 1):
            assert bytes(got[b].tolist()) == keccak256(bytes(msg[b, :int(length[b])].tolist()))
    for kind in ("keccak256", "keccak_var"):
        _check_panel(kind, 3, 5, M, M)
        _check_panel(kind, 1, 33, M, M + 1)


def test_stage_shared_bytes_stay_under_the_static_limit(cpu_builds):
    """A block's dynamic shared memory (the ring, the table entries, the
    digest rows) as the launchers compute it at the card's 32 lanes, at the
    paths' lengths and around the table capacity: under the 48 KB a launch
    takes without an opt-in; one stage of the ring where the message fits
    one compression block, two past it; the tables whole up to 1,024 bytes
    and two compression blocks' entries past it."""
    for name, block in (("sha256", 64), ("blake2s", 64), ("keccak", 136)):
        shared_bytes = getattr(cpu_builds[1][name], f"acvm_{name}_shared_bytes")
        for M in (32, 64, 65, 136, 137, 232, 1024, 1025, 5000):
            stages = 1 if M <= block else 2
            entries = M if M <= 1024 else 2 * block
            ring = stages * block * 32
            assert shared_bytes(M, 1) == 4 * (ring + 2 * entries + 32) <= 48 * 1024, (name, M)
            assert shared_bytes(M, 0) == 4 * (ring + 32), (name, M)
