"""Integer (non-modular) limb operations: full-width add/sub/mul mod 2^256,
masking to 2^bit_size, comparisons, shifts and binary long division.

All ops are elementwise over leading batch dims with a trailing axis of 8
``int32`` limbs (uint32 bit patterns), on either device.  They are plain
tensor ops (the JAX package has no kernel for them either): each splits its
operands into 16-bit half-limbs held in int64, where sums, borrows and
products have headroom, and joins the result back.  The one exception is
:func:`long_divmod`, a scan of up to 256 dependent steps, which is the
hand-written ``divmod`` kernel on a CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build
from ..fields.kernels import HALF, LIMBS, M16, carry_half, join_half, split_half, sub_half
from ..fields.torch_ops import geq

BITS = 16  # bits per half-limb


def int_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^256."""
    return join_half(carry_half(split_half(a) + split_half(b), bits=17))


def int_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2^256 (a borrow out of the top is dropped)."""
    return join_half(sub_half(split_half(a), split_half(b))[0])


def int_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^256 by schoolbook convolution: column k sums the
    half-limb products a_i * b_(k-i), at most 16 of them (< 2^36)."""
    ha, hb = torch.broadcast_tensors(split_half(a), split_half(b))
    acc = torch.zeros_like(ha)
    for i in range(HALF):
        acc[..., i:] += ha[..., i : i + 1] * hb[..., : HALF - i]
    return join_half(carry_half(acc, bits=36))


def mask_to_bits(a: torch.Tensor, bit_size: int) -> torch.Tensor:
    """a mod 2^bit_size."""
    mask = (1 << bit_size) - 1
    words = [(mask >> (32 * i)) & 0xFFFFFFFF for i in range(a.shape[-1])]
    signed = [w - (1 << 32) if w >= 1 << 31 else w for w in words]
    return a & torch.tensor(signed, dtype=torch.int32, device=a.device)


def int_geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return geq(a, b)


def int_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~geq(a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def _shl_half(h: torch.Tensor, shift: int) -> torch.Tensor:
    limb_shift, bit_shift = divmod(shift, BITS)
    if limb_shift >= HALF:
        return torch.zeros_like(h)
    shifted = F.pad(h, (limb_shift, 0))[..., :HALF]
    if bit_shift == 0:
        return shifted
    carry_in = F.pad(shifted, (1, 0))[..., :HALF]
    return ((shifted << bit_shift) & M16) | (carry_in >> (BITS - bit_shift))


def _shr_half(h: torch.Tensor, shift: int) -> torch.Tensor:
    limb_shift, bit_shift = divmod(shift, BITS)
    if limb_shift >= HALF:
        return torch.zeros_like(h)
    shifted = F.pad(h, (0, limb_shift))[..., limb_shift:]
    if bit_shift == 0:
        return shifted
    carry_in = F.pad(shifted, (0, 1))[..., 1:]
    return (shifted >> bit_shift) | ((carry_in << (BITS - bit_shift)) & M16)


def shl_static(a: torch.Tensor, shift: int) -> torch.Tensor:
    """(a << shift) mod 2^256 for a static shift amount."""
    return join_half(_shl_half(split_half(a), shift))


def shr_static(a: torch.Tensor, shift: int) -> torch.Tensor:
    """a >> shift for a static shift amount."""
    return join_half(_shr_half(split_half(a), shift))


def _gather_or_zero(h: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    take = h.gather(-1, src.clamp(0, HALF - 1))
    return torch.where((src >= 0) & (src < HALF), take, torch.zeros_like(take))


def shl_dynamic(a: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(a << shift) mod 2^256 with per-element shift amounts.

    ``shift``: (...,) integers (any value >= 256 yields 0)."""
    h = split_half(a)
    shift = shift.to(torch.int64)
    limb_shift = (shift // BITS)[..., None]
    bit = (shift % BITS)[..., None]
    src = torch.arange(HALF, dtype=torch.int64, device=a.device) - limb_shift
    gathered = _gather_or_zero(h, src)
    carry = _gather_or_zero(h, src - 1)
    # bit == 0: carry >> 16 == 0 for 16-bit half-limbs, no special case.
    return join_half(((gathered << bit) & M16) | (carry >> (BITS - bit)))


def shr_dynamic(a: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """a >> shift with per-element shift amounts (>= 256 yields 0)."""
    h = split_half(a)
    shift = shift.to(torch.int64)
    limb_shift = (shift // BITS)[..., None]
    bit = (shift % BITS)[..., None]
    src = torch.arange(HALF, dtype=torch.int64, device=a.device) + limb_shift
    gathered = _gather_or_zero(h, src)
    carry = _gather_or_zero(h, src + 1)
    return join_half((gathered >> bit) | ((carry << (BITS - bit)) & M16))


# Calls of the plain division on CUDA tensors (the comparisons of
# ``chip_smoke.py``); a solve on the card leaves it unchanged.
PLAIN_ON_CARD = {"long_divmod": 0}


# Divisors below 2^SHORT_DIVISOR_BITS divide by short division over 16-bit
# half-limbs in int64: the running remainder r < b, so (r << 16) | half
# stays below 2^63.
SHORT_DIVISOR_BITS = 47


def _short_divmod_plain(ha: torch.Tensor, hb: torch.Tensor, b_zero: torch.Tensor):
    """(q, r) of half-limb integers whose divisors lie below
    2^SHORT_DIVISOR_BITS, one int64 division a half-limb from the top."""
    d = hb[..., 0] | (hb[..., 1] << BITS) | (hb[..., 2] << (2 * BITS))
    d = torch.where(b_zero, torch.ones_like(d), d)
    q = torch.zeros_like(ha)
    r = torch.zeros_like(d)
    for j in range(HALF - 1, -1, -1):
        cur = (r << BITS) | ha[..., j]
        q[..., j] = cur // d
        r = cur - q[..., j] * d
    hr = torch.zeros_like(ha)
    for j in range(3):
        hr[..., j] = (r >> (BITS * j)) & M16
    return join_half(q), join_half(hr)


def long_divmod_plain(a: torch.Tensor, b: torch.Tensor, num_bits: int = 256):
    """Plain version of :func:`long_divmod`.  Where every divisor lies below
    2^SHORT_DIVISOR_BITS (a Quotient by 2^32, say), short division: 16 steps
    of int64 tensor ops.  Else bit-serial restoring division, one step of
    tensor ops for each of the ``num_bits`` bits of a, from the top.
    Doubling the remainder never leaves 256 bits: before the last step it is
    at most a >> 1.  The steps above the highest bit set in any element of a
    are skipped: there the remainder stays 0 and no quotient bit is set."""
    a, b = torch.broadcast_tensors(a, b)
    if a.is_cuda:
        PLAIN_ON_CARD["long_divmod"] += 1
    if num_bits < 256:
        a = mask_to_bits(a, num_bits)
    ha = split_half(a)
    b_zero = is_zero(b)
    hb = split_half(b)
    if (hb[..., 3:] == 0).all() and (hb[..., 2] >> (SHORT_DIVISOR_BITS - 2 * BITS) == 0).all():
        q, r = _short_divmod_plain(ha, hb, b_zero)
        zero = torch.zeros_like(r)
        return torch.where(b_zero[..., None], zero, q), torch.where(b_zero[..., None], zero, r)
    q = torch.zeros_like(ha)
    r = torch.zeros_like(a)
    # Each half-limb's largest value over the elements has the bit length of
    # their OR.
    tops = ha.reshape(-1, HALF).amax(0).tolist() if ha.numel() else [0]
    high = max((BITS * j + int(v).bit_length() for j, v in enumerate(tops) if v), default=0)
    for k in range(high - 1, -1, -1):
        limb, bit_off = divmod(k, BITS)
        a_bit = (ha[..., limb] >> bit_off) & 1
        hr = _shl_half(split_half(r), 1)
        hr[..., 0] += a_bit
        r = join_half(hr)
        ge = geq(r, b) & ~b_zero
        r = torch.where(ge[..., None], int_sub(r, b), r)
        q[..., limb] |= ge.to(torch.int64) << bit_off
    zero = torch.zeros_like(r)
    q32 = join_half(q)
    return torch.where(b_zero[..., None], zero, q32), torch.where(b_zero[..., None], zero, r)


def long_divmod(a: torch.Tensor, b: torch.Tensor, num_bits: int = 256):
    """Euclidean (q, r) of full-width limb integers (broadcasts); only the
    bits of a below ``num_bits`` are read.  b == 0 yields (0, 0), matching the
    reference Quotient directive.

    CUDA tensors: one ``divmod`` launch (``csrc/divmod.cu``: a thread an
    element, word-level long division in base 2^32 in registers) or an error.
    CPU tensors: :func:`long_divmod_plain`.  Both give the same bits.
    """
    for t, name in ((a, "a"), (b, "b")):
        if t.dtype != torch.int32 or t.shape[-1] != LIMBS:
            raise TypeError(f"long_divmod {name}: expected (..., {LIMBS}) int32 limbs, "
                            f"got {tuple(t.shape)} {t.dtype}")
    if not 0 <= num_bits <= 256:
        raise ValueError("long_divmod: num_bits must lie in [0, 256]")
    if not a.is_cuda:
        return long_divmod_plain(a, b, num_bits)
    a, b = (t.contiguous() for t in torch.broadcast_tensors(a, b))
    q = torch.empty_like(a)
    r = torch.empty_like(a)
    n = a.numel() // LIMBS
    if n:
        build.launch("divmod", a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(), n,
                     num_bits, torch.cuda.current_stream(a.device).cuda_stream)
    return q, r
