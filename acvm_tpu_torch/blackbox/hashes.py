"""Host-side hash primitives used by the black-box solvers.

Reference: ``blackbox_solver/src/lib.rs:47-99`` — sha256 / blake2s(256) /
keccak256 digests, plus ``hash_to_field_128_security`` = blake2s then reduce
mod the field order.  sha256/blake2s come from hashlib; keccak256 (the original
pre-SHA3 padding) is implemented here since hashlib only ships SHA-3.

The batched device implementations live in ``acvm_tpu_torch.gpu.gadgets``
(a CUDA kernel and a plain tensor version of each); these host versions define
bit-exactness.
"""

from __future__ import annotations

import hashlib

from ..fields.field import FieldElement
from ..fields.params import FieldParams, BN254_FR

# ---------------------------------------------------------------------------
# Keccak-f[1600] permutation + Keccak-256 sponge (original 0x01 padding)
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_KECCAK_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK64 = (1 << 64) - 1


def _rotl64(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def keccak_f1600(state: list[int]) -> list[int]:
    """One Keccak-f[1600] permutation over a 5x5 lane state (row-major x + 5*y)."""
    a = list(state)
    for rc in _KECCAK_RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [(a[i] ^ d[i % 5]) for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                    a[x + 5 * y], _KECCAK_ROT[x][y]
                )
        # chi
        a = [
            b[i] ^ ((~b[(i + 1) % 5 + 5 * (i // 5)]) & b[(i + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # iota
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    rate = 136  # bytes, for 256-bit output
    state = [0] * 25
    # absorb
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            state[i] ^= lane
        state = keccak_f1600(state)
    # squeeze (single block suffices for 32 bytes)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out[:32]


# ---------------------------------------------------------------------------
# Digest wrappers
# ---------------------------------------------------------------------------


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def blake2s(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


def hash_to_field_128_security(
    data: bytes, params: FieldParams = BN254_FR
) -> FieldElement:
    return FieldElement.from_be_bytes_reduce(blake2s(data), params)
