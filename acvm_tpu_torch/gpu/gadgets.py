"""Batched hash gadgets: SHA-256, BLAKE2s (and hash-to-field), Keccak-256.

Replaces the reference's RustCrypto digest calls on the batched path
(``blackbox_solver/src/lib.rs:47-99``) and the JAX package's unrolled ``jnp``
round loops (``acvm_tpu/tpu/gadgets.py``).  Each digest has two versions:

* a hand-written CUDA kernel, one a hash family (``csrc/sha256.cu``,
  ``csrc/blake2s.cu``, ``csrc/keccak.cu``): a thread a (gadget, instance),
  the state in registers from the first message byte to the last digest byte;
* a plain version in tensor ops over the whole batch, which the CPU runs and
  ``chip_smoke.py`` holds each kernel to.  Words are 32-bit values held in
  int64 (torch's CPU uint32 has no arithmetic), masked after every add and
  rotate; Keccak's 64-bit lanes are (lo, hi) 32-bit halves, so a shift never
  drags a sign bit in (torch's ``>>`` on int64 is arithmetic).

Two entry forms.  The digest functions take a ``(B, M)`` byte matrix and give
``(B, 32)`` int32 bytes (Schnorr's challenge hashes such a matrix).
:func:`hash_rows` hashes a group of G gadgets straight off the witness panel
``(NW, B, 8)``: message byte j of gadget g is byte ``src_shift[g, j] / 8`` of
limb ``src_limb[g, j]`` of row ``src_w[g, j]``, and the digest goes back as 32
canonical rows (limb 0 the byte) or, for hash-to-field, one row.  Both take
the kernel on a CUDA tensor, or raise; the plain version on a CPU tensor.

The BLAKE2s plain version keeps the state as four (4, B) rows a, b, c, d and
runs one G on all four columns at once; the diagonal half-round rotates rows
b, c, d by 1, 2, 3 columns first.  Keccak's plain permutation runs on all 25
lanes at once, its rho and pi steps one gather with a per-lane rotation.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from .. import build
from ..fields.kernels import LIMBS, int_to_limbs32, wrap_i32
from . import intops

_M32 = 0xFFFFFFFF

# Calls of a plain digest on CUDA tensors (the comparisons of
# ``chip_smoke.py``); a solve on the card leaves them unchanged.
PLAIN_ON_CARD = {"sha256_digest": 0, "blake2s_digest": 0, "keccak256_digest": 0,
                 "keccak256_var_digest": 0}

# A group's kind -> the kernel that hashes it.
KERNEL_OF = {"sha256": "sha256", "blake2s": "blake2s", "hash_to_field": "blake2s",
             "keccak256": "keccak", "keccak_var": "keccak"}

# int32 operations a compression block (a Keccak-f permutation for keccak) of
# each kernel's round structure: the work its bound counts.
#   sha256: 64 rounds of 24 (three rotates and two XORs a Sigma, three for
#     Ch, four for Maj, seven adds), 48 schedule words of 13, 8 adds folding
#     the state in;
#   blake2s: 10 rounds of 8 G functions of 14 (six adds, four XORs, four
#     rotates), 16 XORs folding the state in, 2 for the counter and the
#     last-block flag;
#   keccak: 24 rounds of 155 64-bit operations, two int32 each (theta 55, rho
#     and pi 24 rotates, chi 75, iota 1).
# Hash-to-field adds at most 3 x 16 for its conditional subtractions.
OPS_PER_BLOCK = {"sha256": 64 * 24 + 48 * 13 + 8, "blake2s": 10 * 8 * 14 + 16 + 2,
                 "keccak": 24 * 155 * 2}
TO_FIELD_OPS = 3 * 16


def _rotr32(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _to_bytes_le(words: torch.Tensor) -> torch.Tensor:
    """(n, B) words -> (B, 4 n) bytes, each word little-endian."""
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=words.device)
    out = (words[:, :, None] >> shifts) & 0xFF  # (n, B, 4)
    return out.permute(1, 0, 2).reshape(words.shape[1], -1)


def _count_plain(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        PLAIN_ON_CARD[name] += 1


# ---------------------------------------------------------------------------
# SHA-256
# ---------------------------------------------------------------------------

_SHA_INIT = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
_SHA_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]


def sha256_digest_plain(message: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sha256_digest`: the static padding appended to
    the whole batch, then 64 rounds a block as tensor ops over (B,) words."""
    _count_plain("sha256_digest", message)
    B, M = message.shape
    dev = message.device
    num_blocks = (M + 8) // 64 + 1  # the message, 0x80 and 8 length bytes
    padded = torch.zeros((B, num_blocks * 64), dtype=torch.int64, device=dev)
    padded[:, :M] = message.to(torch.int64) & 0xFF
    padded[:, M] = 0x80
    padded[:, -8:] = torch.tensor(list((8 * M).to_bytes(8, "big")), dtype=torch.int64, device=dev)
    words = padded.reshape(B, num_blocks, 16, 4)
    w_be = (words[..., 0] << 24) | (words[..., 1] << 16) | (words[..., 2] << 8) | words[..., 3]

    state = [torch.full((B,), v, dtype=torch.int64, device=dev) for v in _SHA_INIT]
    for blk in range(num_blocks):
        w = [w_be[:, blk, t] for t in range(16)]
        for t in range(16, 64):
            s0 = _rotr32(w[t - 15], 7) ^ _rotr32(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = _rotr32(w[t - 2], 17) ^ _rotr32(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
        a, b, c, d, e, f, g, h = state
        for t in range(64):
            s1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
            ch = (e & f) ^ ((e ^ _M32) & g)
            temp1 = (h + s1 + ch + _SHA_K[t] + w[t]) & _M32
            s0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            h, g, f, e = g, f, e, (d + temp1) & _M32
            d, c, b, a = c, b, a, (temp1 + s0 + maj) & _M32
        state = [(s + v) & _M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]
    # big-endian words: byte-swap the little-endian byte order
    return _to_bytes_le(torch.stack(state)).reshape(B, 8, 4).flip(-1).reshape(B, 32).to(torch.int32)


# ---------------------------------------------------------------------------
# BLAKE2s-256 (no key)
# ---------------------------------------------------------------------------

_B2S_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
_B2S_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _b2s_g(a, b, c, d, x, y):
    a = (a + b + x) & _M32
    d = _rotr32(d ^ a, 16)
    c = (c + d) & _M32
    b = _rotr32(b ^ c, 12)
    a = (a + b + y) & _M32
    d = _rotr32(d ^ a, 8)
    c = (c + d) & _M32
    b = _rotr32(b ^ c, 7)
    return a, b, c, d


@lru_cache(maxsize=None)
def _b2s_schedule(device: torch.device) -> torch.Tensor:
    """(10, 4, 4) message-word indices: per round the x and y words of the
    column half-round, then of the diagonal one."""
    rows = [[s[0:8:2], s[1:8:2], s[8:16:2], s[9:16:2]] for s in _B2S_SIGMA]
    return torch.tensor(rows, dtype=torch.int64, device=device)


def blake2s_digest_plain(message: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`blake2s_digest`."""
    _count_plain("blake2s_digest", message)
    B, M = message.shape
    dev = message.device
    iv = torch.tensor(_B2S_IV, dtype=torch.int64, device=dev)
    h = iv[:, None].expand(8, B).clone()
    h[0] ^= 0x01010020  # depth = 1, fanout = 1, digest of 32 bytes

    num_blocks = max(1, (M + 63) // 64)
    padded = torch.zeros((B, num_blocks * 64), dtype=torch.int64, device=dev)
    padded[:, :M] = message.to(torch.int64) & 0xFF
    words = padded.reshape(B, num_blocks, 16, 4)
    m_le = (
        words[..., 0] | (words[..., 1] << 8) | (words[..., 2] << 16) | (words[..., 3] << 24)
    ).permute(1, 2, 0)  # (blocks, 16, B)
    schedule = _b2s_schedule(dev)

    for blk in range(num_blocks):
        t = min((blk + 1) * 64, M)
        last = [0, 0, _M32 if blk == num_blocks - 1 else 0, 0]
        tweak = torch.tensor(
            [t & _M32, t >> 32, last[2], 0], dtype=torch.int64, device=dev
        )
        a, b, c = h[0:4], h[4:8], iv[0:4, None].expand(4, B)
        d = iv[4:8, None] ^ tweak[:, None]
        # every round's message words in one gather: (10, 4, 4, B)
        msg = m_le[blk][schedule.reshape(-1)].reshape(10, 4, 4, B)
        for r in range(10):
            a, b, c, d = _b2s_g(a, b, c, d, msg[r, 0], msg[r, 1])
            b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
            a, b, c, d = _b2s_g(a, b, c, d, msg[r, 2], msg[r, 3])
            b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
        h = h ^ torch.cat([a, b]) ^ torch.cat([c, d])
    return _to_bytes_le(h).to(torch.int32)


def to_field_subtrahends(modulus: int) -> List[int]:
    """The multiples 4p, 2p, p that lie below 2^256, largest first: subtracted
    each where it fits, they bring a 256-bit value below p (the JAX package's
    ``run_hashes``, ``acvm_tpu/tpu/batch_solver.py:451-472``)."""
    return [k * modulus for k in (4, 2, 1) if k * modulus < 1 << 256]


def digest_to_field_plain(digest: torch.Tensor, modulus: int) -> torch.Tensor:
    """(N, 32) digest bytes read big-endian -> (N, 8) int32 limbs of the value
    mod p, by the conditional subtractions of :func:`to_field_subtrahends`."""
    d = digest.to(torch.int64)
    val = wrap_i32(torch.stack([d[:, 31 - 4 * j] | (d[:, 30 - 4 * j] << 8) | (d[:, 29 - 4 * j] << 16)
                                | (d[:, 28 - 4 * j] << 24) for j in range(LIMBS)], dim=-1))
    for m in to_field_subtrahends(modulus):
        mk = torch.from_numpy(int_to_limbs32(m).copy()).to(digest.device)
        val = torch.where(intops.int_geq(val, mk)[..., None], intops.int_sub(val, mk), val)
    return val


# ---------------------------------------------------------------------------
# Keccak-256 (the original 0x01 padding)
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
KECCAK_RATE = 136


@lru_cache(maxsize=None)
def _keccak_tables(device: torch.device):
    """rho and pi as one gather: lane i of B is lane src[i] of A rotated left
    by rot[i]; as (swap, rot mod 32) on (lo, hi) halves.  chi's two
    neighbours of each lane."""
    src, rot = [0] * 25, [0] * 25
    for x in range(5):
        for y in range(5):
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            src[dst], rot[dst] = x + 5 * y, _KECCAK_ROT[x][y]
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)  # noqa: E731
    rot_t = as_t(rot)[:, None]
    chi1 = [(i + 1) % 5 + 5 * (i // 5) for i in range(25)]
    chi2 = [(i + 2) % 5 + 5 * (i // 5) for i in range(25)]
    return as_t(src), rot_t >= 32, rot_t % 32, as_t(chi1), as_t(chi2)


def _rotl64(lo, hi, swap, n):
    """Rotate (lo, hi) 32-bit halves left by n + 32 swap, n < 32 (tensors
    that broadcast).  n = 0 is safe: x >> 32 of a 32-bit value is 0."""
    if swap is not None:
        lo, hi = torch.where(swap, hi, lo), torch.where(swap, lo, hi)
    return (((lo << n) & _M32) | (hi >> (32 - n)),
            ((hi << n) & _M32) | (lo >> (32 - n)))


def keccak_f1600_plain(lo: torch.Tensor, hi: torch.Tensor):
    """Keccak-f[1600] on (25, B) int64 lane halves (lane x + 5 y)."""
    src, swap, rot, chi1, chi2 = _keccak_tables(lo.device)
    for rc in _KECCAK_RC:
        c_lo = lo[0:5] ^ lo[5:10] ^ lo[10:15] ^ lo[15:20] ^ lo[20:25]
        c_hi = hi[0:5] ^ hi[5:10] ^ hi[10:15] ^ hi[15:20] ^ hi[20:25]
        r_lo, r_hi = _rotl64(c_lo.roll(-1, 0), c_hi.roll(-1, 0), None, 1)  # C[x + 1] <<< 1
        d_lo, d_hi = c_lo.roll(1, 0) ^ r_lo, c_hi.roll(1, 0) ^ r_hi  # ^ C[x - 1]
        lo, hi = lo ^ d_lo.repeat(5, 1), hi ^ d_hi.repeat(5, 1)
        b_lo, b_hi = _rotl64(lo[src], hi[src], swap, rot)
        lo = b_lo ^ ((b_lo[chi1] ^ _M32) & b_lo[chi2])
        hi = b_hi ^ ((b_hi[chi1] ^ _M32) & b_hi[chi2])
        lo[0] ^= rc & _M32
        hi[0] ^= rc >> 32
    return lo, hi


def _keccak_plain(message: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of each instance's first length[b] bytes (length <= M):
    the padding is built where the length puts it, and the permutation of
    block k commits only where k is below the instance's block count."""
    B, M = message.shape
    dev = message.device
    max_blocks = M // KECCAK_RATE + 1
    total = max_blocks * KECCAK_RATE
    length = length.to(torch.int64)[:, None]
    pos = torch.arange(total, dtype=torch.int64, device=dev)[None]
    padded = torch.zeros((B, total), dtype=torch.int64, device=dev)
    padded[:, :M] = message.to(torch.int64) & 0xFF
    padded = torch.where(pos < length, padded, 0)
    padded ^= torch.where(pos == length, 0x01, 0)
    num_blocks = length // KECCAK_RATE + 1  # (B, 1)
    padded ^= torch.where(pos == num_blocks * KECCAK_RATE - 1, 0x80, 0)
    words = padded.reshape(B, max_blocks, KECCAK_RATE // 4, 4)
    words = (words[..., 0] | (words[..., 1] << 8) | (words[..., 2] << 16) | (words[..., 3] << 24))
    words = words.permute(1, 2, 0)  # (blocks, 34, B): lane i's halves at 2 i, 2 i + 1

    lo = torch.zeros((25, B), dtype=torch.int64, device=dev)
    hi = torch.zeros_like(lo)
    rate_lanes = KECCAK_RATE // 8
    for blk in range(max_blocks):
        a_lo, a_hi = lo.clone(), hi.clone()
        a_lo[:rate_lanes] ^= words[blk, 0::2]
        a_hi[:rate_lanes] ^= words[blk, 1::2]
        p_lo, p_hi = keccak_f1600_plain(a_lo, a_hi)
        active = (blk < num_blocks[:, 0])[None]
        lo, hi = torch.where(active, p_lo, lo), torch.where(active, p_hi, hi)
    return _to_bytes_le(torch.stack([lo[:4], hi[:4]], dim=1).reshape(8, B)).to(torch.int32)


def keccak256_digest_plain(message: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`keccak256_digest`."""
    _count_plain("keccak256_digest", message)
    B, M = message.shape
    return _keccak_plain(message, torch.full((B,), M, dtype=torch.int64, device=message.device))


def keccak256_var_digest_plain(message: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`keccak256_var_digest`."""
    _count_plain("keccak256_var_digest", message)
    return _keccak_plain(message, length)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, what: str, shape, device) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape) \
            or t.device != device:
        raise TypeError(f"{what}: expected a contiguous {tuple(shape)} int32 tensor on {device}, "
                        f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_length(length: torch.Tensor, M: int, what: str) -> None:
    """A keccak_var length must lie in 0 ... M: past M the kernel would read
    bytes beyond the message.  One reduction before the launch."""
    if length.numel():
        lo, hi = torch.aminmax(length)
        if int(lo) < 0 or int(hi) > M:
            raise ValueError(f"{what}: lengths must lie in 0 ... {M}, got {int(lo)} ... {int(hi)}")


def _launch(kind: str, src, tables, M: int, dst, out_idx, G: int, B: int,
            length=None, subtrahends=None, launch=None) -> None:
    """One launch of the kernel of ``kind``.  ``src`` / ``dst``: (tensor, row
    stride, instance stride) in int32 words, ``dst`` with the words a row
    gets (8: a canonical row; 1: one word); ``tables``: the (G, M) row, limb
    and shift tables, or None for a matrix whose row j is byte j.
    ``launch(name, *args)`` calls the C launcher (:func:`build.launch`, or
    another build of the same source: ``chip_smoke.py``'s measurement and
    parent builds)."""
    name = KERNEL_OF[kind]
    stream = torch.cuda.current_stream(src[0].device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = [src[0].data_ptr(), src[1], src[2], *(ptr(t) for t in (tables or (None,) * 3)), M,
            dst[0].data_ptr(), dst[1], dst[2], dst[3], ptr(out_idx), G, B]
    if name == "keccak":
        args.append(ptr(length))
    elif name == "blake2s":
        subs = np.zeros((3, LIMBS), dtype=np.uint32)
        for i, m in enumerate(subtrahends or ()):
            subs[i] = int_to_limbs32(m).view(np.uint32)
        args += [subs.ctypes.data, len(subtrahends) if subtrahends is not None else -1]
    (launch or build.launch)(name, *args, stream)


def _digest_on_card(kind: str, message: torch.Tensor, length=None, launch=None) -> torch.Tensor:
    B, M = message.shape
    msg = message.to(torch.int32).contiguous()
    out = torch.empty((B, 32), dtype=torch.int32, device=message.device)
    if length is not None:
        length = length.to(torch.int32).reshape(1, B).contiguous()
    if B:
        _launch(kind, (msg, 1, M), None, M, (out, 1, 32, 1), None, 1, B, length=length, launch=launch)
    return out


def sha256_digest(message: torch.Tensor) -> torch.Tensor:
    """SHA-256 of a (B, M) byte matrix (any integer dtype) -> (B, 32) int32
    bytes.  CUDA: one ``sha256`` launch; CPU: :func:`sha256_digest_plain`."""
    if not message.is_cuda:
        return sha256_digest_plain(message)
    return _digest_on_card("sha256", message)


def blake2s_digest(message: torch.Tensor) -> torch.Tensor:
    """BLAKE2s-256 (no key) of a (B, M) byte matrix -> (B, 32) int32 bytes.
    CUDA: one ``blake2s`` launch; CPU: :func:`blake2s_digest_plain`."""
    if not message.is_cuda:
        return blake2s_digest_plain(message)
    return _digest_on_card("blake2s", message)


def keccak256_digest(message: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of a (B, M) byte matrix -> (B, 32) int32 bytes.  CUDA: one
    ``keccak`` launch; CPU: :func:`keccak256_digest_plain`."""
    if not message.is_cuda:
        return keccak256_digest_plain(message)
    return _digest_on_card("keccak256", message)


def keccak256_var_digest(message: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of each row's first ``length[b]`` bytes (0 ... M, else
    ValueError) -> (B, 32) int32 bytes.  CUDA: one ``keccak`` launch; CPU:
    :func:`keccak256_var_digest_plain`."""
    _check_length(length, message.shape[1], "keccak256_var_digest")
    if not message.is_cuda:
        return keccak256_var_digest_plain(message, length)
    return _digest_on_card("keccak_var", message, length)


def hash_rows_plain(kind: str, W: torch.Tensor, src_w, src_limb, src_shift, out_idx,
                    length=None, modulus: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`hash_rows`: the message bytes gathered off
    the panel, the plain digest, the rows written back with one
    ``index_copy_``."""
    G, M = src_w.shape
    B = W.shape[1]
    rows = W.index_select(0, src_w.reshape(-1).long()).to(torch.int64) & _M32  # (G M, B, 8)
    limb = rows.gather(2, src_limb.reshape(-1, 1, 1).long().expand(G * M, B, 1))[..., 0]
    message = ((limb >> src_shift.reshape(-1, 1).long()) & 0xFF).reshape(G, M, B)
    message = message.permute(0, 2, 1).reshape(G * B, M)
    if kind == "sha256":
        digest = sha256_digest_plain(message)
    elif kind in ("blake2s", "hash_to_field"):
        digest = blake2s_digest_plain(message)
    elif kind == "keccak256":
        digest = keccak256_digest_plain(message)
    else:
        digest = keccak256_var_digest_plain(message, length.reshape(G * B))
    if kind == "hash_to_field":
        out = digest_to_field_plain(digest, modulus).reshape(G, B, LIMBS)
    else:
        out = torch.zeros((G, 32, B, LIMBS), dtype=torch.int32, device=W.device)
        out[..., 0] = digest.reshape(G, B, 32).permute(0, 2, 1)
    W.index_copy_(0, out_idx.reshape(-1).long(), out.reshape(-1, B, LIMBS))
    return W


def hash_rows(kind: str, W: torch.Tensor, src_w: torch.Tensor, src_limb: torch.Tensor,
              src_shift: torch.Tensor, out_idx: torch.Tensor, length: Optional[torch.Tensor] = None,
              modulus: Optional[int] = None) -> torch.Tensor:
    """Hash a group of G gadgets of one kind and message length M over the
    panel ``W`` (NW, B, 8) int32, in place, and return it.

    ``src_w``, ``src_limb``, ``src_shift``: (G, M) int32, message byte j of
    gadget g; ``out_idx``: (G, 32) int32 digest rows (each written (byte, 0,
    ..., 0)), or (G, 1) for ``hash_to_field`` (BLAKE2s read big-endian and
    brought below ``modulus``); ``length``: (G, B) int32 bytes hashed for
    ``keccak_var`` (0 ... M, else ValueError).  CUDA: one launch of the
    kind's kernel; CPU: :func:`hash_rows_plain`."""
    if kind not in KERNEL_OF:
        raise ValueError(f"hash_rows: unknown kind {kind!r}")
    if (kind == "keccak_var") != (length is not None) or (kind == "hash_to_field") != (modulus is not None):
        raise ValueError(f"hash_rows: {kind!r} takes a length only for keccak_var and a "
                         "modulus only for hash_to_field")
    if length is not None:
        _check_length(length, src_w.shape[1], "hash_rows")
    if not W.is_cuda:
        return hash_rows_plain(kind, W, src_w, src_limb, src_shift, out_idx, length, modulus)
    G, M = src_w.shape
    NW, B, _ = W.shape
    _check(W, "hash_rows W", (NW, B, LIMBS), W.device)
    for t, what in ((src_w, "src_w"), (src_limb, "src_limb"), (src_shift, "src_shift")):
        _check(t, f"hash_rows {what}", (G, M), W.device)
    _check(out_idx, "hash_rows out_idx", (G, 1 if kind == "hash_to_field" else 32), W.device)
    if length is not None:
        _check(length, "hash_rows length", (G, B), W.device)
    if G and B:
        _launch(kind, (W, B * LIMBS, LIMBS), (src_w, src_limb, src_shift), M,
                (W, B * LIMBS, LIMBS, LIMBS), out_idx, G, B, length=length,
                subtrahends=to_field_subtrahends(modulus) if modulus is not None else None)
    return W
