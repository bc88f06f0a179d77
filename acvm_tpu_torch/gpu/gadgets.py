"""Batched hash gadgets as plain tensor ops: BLAKE2s-256.

Replaces the reference's RustCrypto digest call on the batched path
(``blackbox_solver/src/lib.rs:47-99``): the whole digest runs as vector ops
over the instance batch.  Words are 32-bit values held in int64 (torch's CPU
uint32 has no arithmetic), masked after every add and rotate.  SHA-256 and
Keccak-256 are not part of this package yet.

The four G functions of a BLAKE2s half-round are independent, so the state is
kept as four (4, B) rows a, b, c, d and one G runs on all four columns at
once; the diagonal half-round rotates rows b, c, d by 1, 2, 3 columns first.
That is a quarter of the tensor ops of the word-by-word form, which matters
where every op is a kernel launch.
"""

from __future__ import annotations

from functools import lru_cache

import torch

_M32 = 0xFFFFFFFF

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


def _rotr32(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


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


def blake2s_digest(message: torch.Tensor) -> torch.Tensor:
    """BLAKE2s-256 (no key) of a (B, M) byte matrix (any integer dtype) ->
    (B, 32) int64 bytes."""
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

    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=dev)
    out = (h[:, :, None] >> shifts) & 0xFF  # (8, B, 4)
    return out.permute(1, 0, 2).reshape(B, 32)
