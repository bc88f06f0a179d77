"""Field kernels: Montgomery multiply, fixed-exponent power, inverse, expression dot.

A field element is 8 little-endian 32-bit limbs stored as ``torch.int32`` (the
bit pattern of uint32; torch's CPU uint32 has no arithmetic), Montgomery form
with R = 2^256, canonical (< p) unless stated.

Each public function here is a wrapper with two routes and nothing between:

* a CUDA tensor launches the hand-written kernel under ``csrc/`` (built at
  first use, see :mod:`acvm_tpu_torch.build`) or raises;
* a CPU tensor runs the plain PyTorch version beside it (``*_plain``): int64
  arithmetic over 16-bit half-limbs (:class:`HalfField`).

What each kernel replaces in the JAX package, and what bounds it on an H100:

* ``mont_mul``  — ``fields/pallas_mul_v2.py::_make_mul_kernel``.  96 bytes and
  136 32-bit multiply-adds per element: bound by the integer pipes.
* ``mont_pow``  — ``fields/pallas_mul.py::_make_pow_kernel``.  A sliding
  window over odd powers (:func:`pow_schedule`, 311 products for p - 2 of
  BN254) per 64 bytes: bound by the integer pipes once the card is full, by one
  chain's latency below that; the chain stays in registers and local memory.
* ``mont_inv`` (wide fields) — ``fields/jnp_ops.py::LimbContext.mont_inv`` in
  wide mode, which the port first ran as ``pow_wide`` (a Fermat chain a
  thread): ``inv_wide`` (``csrc/inv.cu``),
  20 batches of 30 constant-time divsteps on 32-bit words and a 9-limb matrix
  update after each (:data:`INV_OPS`, ~20,500 int32 operations a value) per
  64 bytes: bound by one warp's latency through its divsteps at a solve's
  8,192 values, by the integer pipes past ~2^15 values.
* ``mont_batch_inv`` — ``fields/jnp_ops.py::LimbContext.mont_batch_inv`` (the
  prefix/suffix scans over the multiply kernel around one pow chain).  One
  launch: a thread runs a chunk of g values of one column forward (prefix
  products) and back, 3(g - 1) products; the block's chunk totals share ONE
  chain through a second level of the trick (:func:`batch_inv_plan`).  Bound
  by the integer pipes and, below a card's worth of lanes, by the chain's
  latency.  A value is read twice and its prefix written to the output,
  read back and overwritten: ~160 bytes a value where the function needs 64.
* ``mont_dot``  — ``fields/pallas_mul_v2.py::_make_dot_kernel_v2``.  32 bytes
  per operand against 136 multiply-adds per product: integer pipes at the usual
  2-3 terms; one launch per expression panel keeps every intermediate out of
  device memory.
* ``mont_mul_v1`` — ``fields/pallas_mul.py::_make_kernel`` (``mont_mul_pallas``
  and ``_flex``): the first-generation multiply, BN254 Fr only.  Same bound as
  ``mont_mul``.
* ``mont_dot_v1`` — ``fields/pallas_mul.py::_make_dot_kernel``
  (``mont_dot_pallas``): the first-generation dot over ONE operand panel, the
  products of quadratic terms multiplied before the call by ``mont_mul_v1``.
  Same bound as ``mont_dot``; its extra cost is the product panel's trip
  through device memory.

``mont_mul``, ``mont_pow`` and ``mont_batch_inv`` serve both field modes:
a narrow field (2p < 2^256: BN254 Fr, BLS12-381 Fr) launches ``mul`` /
``pow`` / ``batch_inv``, a wide one (2^255 < p < 2^256: the base fields and
group orders of secp256k1 and secp256r1) the ``*_wide`` build of the same
source, whose sums and products keep a ninth word.  ``mont_inv`` launches
``inv_wide`` for a wide field and ``pow`` at p - 2 for a narrow one.  Every
other kernel here is narrow only and refuses a wide field
(:func:`require_narrow`).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import build
from .params import FieldParams, BN254_FR

LIMBS = 8  # 32-bit limbs per element
HALF = 16  # 16-bit half-limbs per element (the plain versions' working form)
M16 = 0xFFFF
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Field constants
# ---------------------------------------------------------------------------


def int_to_limbs32(value: int) -> np.ndarray:
    """One Python int -> (8,) int32 limbs (uint32 bit pattern)."""
    return np.frombuffer(int(value).to_bytes(32, "little"), dtype="<u4").astype(
        np.uint32
    ).view(np.int32)


def ints_to_limbs32(values) -> np.ndarray:
    """Iterable of Python ints (< 2^256) -> (N, 8) int32 limbs."""
    values = list(values)
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return (
        np.frombuffer(buf, dtype="<u4").astype(np.uint32).view(np.int32)
        .reshape(len(values), LIMBS)
    )


def limbs32_to_ints(arr) -> list:
    """(..., 8) int32/uint32 limbs -> flat list of Python ints."""
    a = np.ascontiguousarray(np.asarray(arr)).view(np.uint32).reshape(-1, LIMBS)
    raw = a.astype("<u4").tobytes()
    return [
        int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(a.shape[0])
    ]


def n0_inv32(params: FieldParams) -> int:
    """-p^-1 mod 2^32, the per-limb Montgomery constant of the 32-bit CIOS."""
    return (-pow(params.modulus, -1, 1 << 32)) % (1 << 32)


def is_wide(params: FieldParams) -> bool:
    """2p >= 2^256: sums and Montgomery products need a ninth word (the wide
    mode of the JAX ``LimbContext``)."""
    return 2 * params.modulus >= 1 << 256


@lru_cache(maxsize=None)
def field_words(params: FieldParams) -> np.ndarray:
    """The 17 uint32 words [p | R mod p | n0] every C launcher takes.  Which
    mode a field needs (:func:`is_wide`) the launcher picks; a narrow-only
    kernel refuses a wide field with :func:`require_narrow`."""
    if not params.modulus % 2 or params.modulus >= 1 << 256:
        raise ValueError(f"field {params.name}: the kernels need an odd modulus < 2^256")
    words = np.zeros(2 * LIMBS + 1, dtype=np.uint32)
    words[:LIMBS] = int_to_limbs32(params.modulus).view(np.uint32)
    words[LIMBS : 2 * LIMBS] = int_to_limbs32(params.r).view(np.uint32)
    words[2 * LIMBS] = n0_inv32(params)
    return words


def require_narrow(params: FieldParams, kernel: str) -> None:
    """Refuse a wide field for a narrow-only kernel, on either device."""
    if is_wide(params):
        raise NotImplementedError(
            f"{kernel}: field {params.name} has 2p >= 2^256, and this kernel is narrow "
            "only (the wide fields run mul, pow, batch_inv and ecdsa_mul)"
        )


def _host_ptr(words: np.ndarray) -> int:
    return words.ctypes.data_as(ctypes.c_void_p).value


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or t.shape[-1] != LIMBS:
        raise TypeError(
            f"{name}: expected (..., {LIMBS}) int32 limbs, got "
            f"{tuple(t.shape)} {t.dtype}"
        )


# ---------------------------------------------------------------------------
# Half-limb helpers (the plain versions' arithmetic)
# ---------------------------------------------------------------------------


def split_half(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 16) int64 half-limbs in [0, 2^16)."""
    u = x.to(torch.int64) & M32
    return torch.stack([u & M16, u >> 16], dim=-1).reshape(*x.shape[:-1], HALF)


def join_half(h: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 normalized half-limbs -> (..., 8) int32."""
    h = h.reshape(*h.shape[:-1], LIMBS, 2)
    return wrap_i32(h[..., 0] | (h[..., 1] << 16))


def wrap_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bit pattern,
    without relying on how a narrowing cast treats values >= 2^31."""
    return (((u + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


@lru_cache(maxsize=None)
def _lanes(width: int, device: torch.device):
    """(2^i, i) for ``width`` half-limb positions, as int64 tensors."""
    i = torch.arange(width, dtype=torch.int64, device=device)
    return 1 << i, i


def _ripple_half(s: torch.Tensor):
    """Resolve the last carries of (..., n) int64 half-limbs (n <= 32) in one
    carry-lookahead step, without a loop over the positions.  Needs
    0 <= s_i <= 2^17 - 2 (2^17 - 1 at position 0), so a position carries out
    at most once.  Position i *generates* a carry when s_i >= 2^16 and
    *propagates* one when its low half is all ones; packed as the bits of two
    integers x = g | p and y = g, the carries of the binary sum x + y are
    exactly the carries of the half-limb chain.  Returns the normalized
    half-limbs and the carry out of the top position."""
    n = s.shape[-1]
    weight, lane = _lanes(n, s.device)
    lo = s & M16
    g = ((s >> 16) * weight).sum(dim=-1)
    x = g | ((lo == M16) * weight).sum(dim=-1)
    carries = (x + g) ^ x ^ g  # bit i: the carry into position i
    out = (lo + ((carries[..., None] >> lane) & 1)) & M16
    return out, (carries >> n) & 1


def carry_half(t: torch.Tensor, bits: int = 62) -> torch.Tensor:
    """Propagate carries through (..., n) int64 accumulations with entries in
    [0, 2^bits); the carry out of the top half-limb is dropped (callers know
    it is zero, or a multiple of 2^(16n) they mean to discard).  A sum of two
    normalized arrays (entries <= 2^17 - 2) passes ``bits=17`` and skips the
    folding passes."""
    while bits > 17:
        c = t >> 16
        t = t & M16
        t[..., 1:] += c[..., :-1]
        bits = max(bits - 16, 16) + 1
    return _ripple_half(t)[0]


def sub_half(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^256 for normalized (..., 16) half-limbs, as a + ~b + 1,
    and the flag a >= b (the carry out of the complement sum)."""
    t = a + (M16 - b)
    t[..., 0] += 1
    return _ripple_half(t)


def _column_sums(a: torch.Tensor, b: torch.Tensor, cols: int) -> torch.Tensor:
    """The first ``cols`` (<= 31) columns of the schoolbook product of two
    normalized (..., 16) half-limb arrays: column k = sum of a_i * b_j over
    i + j = k, each < 2^36.  The 16 x 16 outer product is padded to rows of 32
    and re-read as rows of 31, which shifts row i right by i; one sum over
    the rows then adds the anti-diagonals."""
    shape = torch.broadcast_shapes(a.shape, b.shape)[:-1]
    outer = a[..., :, None] * b[..., None, :]
    skew = torch.nn.functional.pad(outer, (0, HALF)).reshape(shape + (2 * HALF * HALF,))
    skew = skew[..., : HALF * (2 * HALF - 1)].reshape(shape + (HALF, 2 * HALF - 1))
    return skew.sum(dim=-2)[..., :cols]


class HalfField:
    """One field's arithmetic over (..., 16) int64 half-limbs: the working
    form of every plain version.  No CUDA kernel on any device, and no loop
    over limb positions: each operation is a fixed, short sequence of tensor
    ops (what counts where every op is a dispatch or a launch).

    For a wide field (:func:`is_wide`) a sum of two elements and the
    Montgomery product's (T + m p) / R may reach 2^256: both keep the carry
    out of the top half-limb and hand it to the conditional subtract."""

    def __init__(self, params: FieldParams, device: torch.device):
        field_words(params)  # an odd modulus < 2^256
        self.wide = is_wide(params)

        def half(v: int) -> torch.Tensor:
            return torch.tensor(
                [(v >> (16 * i)) & M16 for i in range(HALF)], dtype=torch.int64, device=device
            )

        self.params = params
        self.p = half(params.modulus)
        self.one = half(params.r)
        # -p^-1 mod 2^256: the Montgomery constant of the whole-word reduction
        self.n_prime = half((-pow(params.modulus, -1, 1 << 256)) % (1 << 256))

    def cond_sub(self, a: torch.Tensor, top: Optional[torch.Tensor] = None) -> torch.Tensor:
        """a - p where a >= p, else a.  a normalized, a < 2p.  A wide field
        passes ``top``, the value's bit 256 (0 or 1, shape a.shape[:-1]):
        where it is set the value passed p and the difference mod 2^256 is
        the value less p."""
        diff, geq = sub_half(a, self.p)
        take = geq != 0 if top is None else (geq | top) != 0
        return torch.where(take[..., None], diff, a)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.wide:
            return self.cond_sub(*_ripple_half(a + b))
        return self.cond_sub(carry_half(a + b, bits=17))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b mod p for canonical a, b: the difference mod 2^256, plus p
        where it borrowed (the carry out of that sum is the borrow's 2^256)."""
        diff, geq = sub_half(a, b)
        return torch.where((geq != 0)[..., None], diff, carry_half(diff + self.p, bits=17))

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor, reduce: bool = True) -> torch.Tensor:
        """Montgomery product a * b * R^-1, R = 2^256, by whole-word reduction:
        T = a * b, m = (T mod R) * (-p^-1) mod R, result = (T + m * p) / R,
        which is < 2p; canonical with ``reduce``.  int64 has the headroom to
        hold a product's whole column sums, so each of the three products is
        one outer product and each normalization one carry pass.  A wide
        field keeps the result's bit 256 in a 17th half-limb and always
        reduces."""
        T = _column_sums(a, b, 2 * HALF - 1)
        m = carry_half(_column_sums(carry_half(T[..., :HALF], bits=36), self.n_prime, HALF), bits=36)
        top = 2 if self.wide else 1
        U = torch.nn.functional.pad(T + _column_sums(m, self.p, 2 * HALF - 1), (0, top))
        t = carry_half(U, bits=37)[..., HALF:]  # the low half is zero by construction
        if self.wide:
            if not reduce:
                raise ValueError("HalfField.mont_mul: a wide field's product always reduces")
            return self.cond_sub(t[..., :HALF], t[..., HALF])
        return self.cond_sub(t) if reduce else t

    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=-1)


@lru_cache(maxsize=None)
def half_field(params: FieldParams, device: torch.device) -> HalfField:
    return HalfField(params, torch.device(device))


# ---------------------------------------------------------------------------
# mul
# ---------------------------------------------------------------------------


def mont_mul_plain(
    a: torch.Tensor, b: torch.Tensor, params: FieldParams = BN254_FR,
    reduce: bool = True,
) -> torch.Tensor:
    """Plain version of :func:`mont_mul` (any device)."""
    hf = half_field(params, a.device)
    return join_half(hf.mont_mul(split_half(a), split_half(b), reduce))


def mont_mul(
    a: torch.Tensor, b: torch.Tensor, params: FieldParams = BN254_FR,
    reduce: bool = True, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """a * b * R^-1 mod p, elementwise with broadcasting over the leading
    axes.  ``reduce=False`` returns the redundant representative < 2p (narrow
    fields only).  ``out`` (contiguous, of the broadcast shape; may be ``a``)
    receives the result on the CUDA route.  A wide field launches
    ``mul_wide``; a must be canonical there (b may be any 256-bit value)."""
    _check(a, "mont_mul a")
    _check(b, "mont_mul b")
    if not reduce and is_wide(params):
        raise ValueError(f"mont_mul: the product over {params.name} always reduces")
    if not a.is_cuda:
        r = mont_mul_plain(a, b, params, reduce)
        if out is not None:
            out.copy_(r)
            return out
        return r
    if b.device != a.device:
        raise ValueError("mont_mul: operands on different devices")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.numel() < b.numel():
        a, b = b, a
    a = a.expand(shape).contiguous()
    b_broadcast = b.numel() == LIMBS
    b = b.contiguous() if b_broadcast else b.expand(shape).contiguous()
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
    elif not (out.is_contiguous() and tuple(out.shape) == tuple(shape)
              and out.dtype == torch.int32 and out.device == a.device):
        raise ValueError("mont_mul: out must be a contiguous int32 tensor of the result shape")
    n = out.numel() // LIMBS
    if n:
        build.launch(
            "mul_wide" if is_wide(params) else "mul", a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            int(b_broadcast), int(reduce), _host_ptr(field_words(params)), _stream(a),
        )
    return out


# ---------------------------------------------------------------------------
# pow
# ---------------------------------------------------------------------------

POW_WINDOW = 4  # bits of a window: the table holds the odd powers a .. a^15
POW_MAX_WINDOWS = 64  # a window starts at least POW_WINDOW bits below the last


def pow_schedule(exponent: int):
    """The left-to-right sliding-window chain of a^exponent over the odd
    powers a^1, a^3, ..., a^15, as ``(first, steps, tail)``: start from table
    entry ``first`` (a^(2 first + 1)); for each ``(squarings, entry)`` of
    ``steps`` square that many times and multiply by the entry; square
    ``tail`` times.  Exact for any exponent in [0, 2^256); 0 is
    ``(-1, [], 0)`` (the result is one)."""
    if not 0 <= exponent < 1 << 256:
        raise ValueError("pow_schedule: exponent out of range")
    if exponent == 0:
        return -1, [], 0
    windows = []  # (odd value, position of its lowest bit), top window first
    i = exponent.bit_length() - 1
    while i >= 0:
        if not (exponent >> i) & 1:
            i -= 1
            continue
        lo = max(i - POW_WINDOW + 1, 0)
        while not (exponent >> lo) & 1:
            lo += 1
        windows.append(((exponent >> lo) & ((1 << (i - lo + 1)) - 1), lo))
        i = lo - 1
    (value, prev), steps = windows[0], []
    for value_k, lo in windows[1:]:
        steps.append((prev - lo, (value_k - 1) // 2))
        prev = lo
    return (value - 1) // 2, steps, prev


# Products that build the table of a .. a^15 (a tree of depth 4: a^2; a^3, a^4;
# a^5, a^7, a^8; a^9, a^11, a^13, a^15).
POW_TABLE_PRODUCTS = 10


def pow_chain_products(exponent: int) -> int:
    """Montgomery products one chain of :func:`pow_schedule` takes."""
    first, steps, tail = pow_schedule(exponent)
    if first < 0:
        return 0
    return POW_TABLE_PRODUCTS + sum(sq + 1 for sq, _ in steps) + tail


@lru_cache(maxsize=None)
def pow_schedule_words(exponent: int) -> np.ndarray:
    """The 3 + 64 uint32 words [first | windows | tail | op] the C launchers
    of ``pow`` and ``batch_inv`` take; op k = squarings << 16 | entry."""
    first, steps, tail = pow_schedule(exponent)
    words = np.zeros(3 + POW_MAX_WINDOWS, dtype=np.uint32)
    words[:3] = [first & M32, len(steps), tail]
    for k, (sq, entry) in enumerate(steps):
        words[3 + k] = sq << 16 | entry
    return words


def _odd_power_table(hf: "HalfField", base: torch.Tensor) -> list:
    """[a, a^3, ..., a^15] in half-limbs, by the kernel's tree."""
    mul = hf.mont_mul
    a2 = mul(base, base)
    a3, a4 = mul(a2, base), mul(a2, a2)
    a5, a7, a8 = mul(a4, base), mul(a4, a3), mul(a4, a4)
    return [base, a3, a5, a7, mul(a8, base), mul(a8, a3), mul(a8, a5), mul(a8, a7)]


def mont_pow_plain(
    a: torch.Tensor, exponent: int, params: FieldParams = BN254_FR
) -> torch.Tensor:
    """Plain version of :func:`mont_pow`: the same sliding-window chain."""
    hf = half_field(params, a.device)
    base = split_half(a)
    first, steps, tail = pow_schedule(exponent)
    if first < 0:
        acc = hf.one.expand(base.shape)
    else:
        table = _odd_power_table(hf, base)
        acc = table[first]
        for squarings, entry in steps:
            for _ in range(squarings):
                acc = hf.mont_mul(acc, acc)
            acc = hf.mont_mul(acc, table[entry])
        for _ in range(tail):
            acc = hf.mont_mul(acc, acc)
    zero = (base == 0).all(dim=-1, keepdim=True)
    return join_half(torch.where(zero, torch.zeros_like(acc), acc))


def mont_pow(
    a: torch.Tensor, exponent: int, params: FieldParams = BN254_FR
) -> torch.Tensor:
    """a^exponent for a Montgomery-form base and a static exponent in
    [0, 2^256); zero bases map to zero.  ``exponent = p - 2`` is the inverse."""
    _check(a, "mont_pow a")
    if not 0 <= exponent < 1 << 256:
        raise ValueError("mont_pow: exponent out of range")
    if not a.is_cuda:
        return mont_pow_plain(a, exponent, params)
    a = a.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // LIMBS
    if n:
        build.launch(
            "pow_wide" if is_wide(params) else "pow", a.data_ptr(), out.data_ptr(), n,
            _host_ptr(pow_schedule_words(exponent)), _host_ptr(field_words(params)),
            _stream(a),
        )
    return out


# ---------------------------------------------------------------------------
# inv: the inverse by constant-time divsteps (csrc/inv.cuh)
# ---------------------------------------------------------------------------

INV_LIMBS = 9  # signed 30-bit limbs: 270 bits
INV_BATCHES = 20  # of 30 divsteps: 600 in all
M30 = (1 << 30) - 1

# int32 operations one inversion of `inv.cuh` runs, counted from its code
# (an IMAD.WIDE, a 32 x 32 -> 64 multiply-add, counts one; a 64-bit shift two):
#   a divstep 27: the two masks 3, the conditional negations 6, the
#     conditional adds to g, q, r 6 and to f, u, v 6, the mask and zeta 3,
#     the shifts 3;
#   the update of (d, e) 122: the signs and md, me 8, the first products and
#     the residue that clears the low bits 14, the shifts 4, then 12 a limb
#     for limbs 1-8 (six multiply-adds, two masks, two 64-bit shifts);
#   the update of (f, g) 88: 8, then 10 a limb for limbs 1-8;
#   the conversions in and out and the normalization, 140 once.
INV_DIVSTEP_OPS = 27
INV_OPS = INV_BATCHES * (30 * INV_DIVSTEP_OPS + 122 + 88) + 140


def _limbs30(value: int) -> list:
    return [(value >> (30 * i)) & M30 for i in range(INV_LIMBS)]


@lru_cache(maxsize=None)
def inv_constants(params: FieldParams) -> np.ndarray:
    """The 9 + 9 + 1 int32 words [M | R^2 mod M | M^-1 mod 2^30] the C
    launcher of ``inv_wide`` takes (M and R^2 in 30-bit limbs)."""
    field_words(params)  # an odd modulus < 2^256
    m = params.modulus
    return np.array(_limbs30(m) + _limbs30(params.r2) + [pow(m, -1, 1 << 30)], dtype=np.int32)


def _divsteps_30(zeta, f, g):
    """30 divsteps on the low words of f and g (int64 tensors holding
    uint32 values): the new zeta and the transition matrix (u, v, q, r),
    exact signed values in [-2^30, 2^30].  Branch-free, as ``inv.cuh``."""
    u, v = torch.ones_like(f), torch.zeros_like(f)
    q, r = torch.zeros_like(f), torch.ones_like(f)
    for _ in range(30):
        c1 = zeta >> 63  # zeta < 0
        c2 = -(g & 1)  # g odd
        g = (g + (((f ^ c1) - c1) & c2)) & M32
        q = q + (((u ^ c1) - c1) & c2)
        r = r + (((v ^ c1) - c1) & c2)
        c1 = c1 & c2
        zeta = (zeta ^ c1) - 1
        f = (f + (g & c1)) & M32
        u = u + (q & c1)
        v = v + (r & c1)
        g = g >> 1
        u = u << 1
        v = v << 1
    return zeta, (u, v, q, r)


def _update_fg(f: list, g: list, t) -> None:
    """[f, g] = t [f, g] / 2^30 over lists of 9 int64 limb tensors."""
    u, v, q, r = t
    cf = (u * f[0] + v * g[0]) >> 30
    cg = (q * f[0] + r * g[0]) >> 30
    for i in range(1, INV_LIMBS):
        cf = cf + u * f[i] + v * g[i]
        cg = cg + q * f[i] + r * g[i]
        f[i - 1], g[i - 1] = cf & M30, cg & M30
        cf, cg = cf >> 30, cg >> 30
    f[-1], g[-1] = cf, cg


def _update_de(d: list, e: list, t, m: list, m_inv30: int) -> None:
    """[d, e] = (t [d, e] + M [md, me]) / 2^30, d and e kept in (-2M, M)."""
    u, v, q, r = t
    sd, se = d[-1] >> 63, e[-1] >> 63
    md = (u & sd) + (v & se)
    me = (q & sd) + (r & se)
    cd = u * d[0] + v * e[0]
    ce = q * d[0] + r * e[0]
    md = md - ((m_inv30 * (cd & M30) + md) & M30)
    me = me - ((m_inv30 * (ce & M30) + me) & M30)
    cd = (cd + m[0] * md) >> 30
    ce = (ce + m[0] * me) >> 30
    for i in range(1, INV_LIMBS):
        cd = cd + u * d[i] + v * e[i] + m[i] * md
        ce = ce + q * d[i] + r * e[i] + m[i] * me
        d[i - 1], e[i - 1] = cd & M30, ce & M30
        cd, ce = cd >> 30, ce >> 30
    d[-1], e[-1] = cd, ce


def _normalize(d: list, sign: torch.Tensor, m: list) -> list:
    """d in (-2M, M), negated where sign < 0, -> [0, M)."""
    add, neg = d[-1] >> 63, sign >> 63
    d = [((d[i] + (m[i] & add)) ^ neg) - neg for i in range(INV_LIMBS)]
    for i in range(INV_LIMBS - 1):
        d[i + 1], d[i] = d[i + 1] + (d[i] >> 30), d[i] & M30
    add = d[-1] >> 63
    d = [d[i] + (m[i] & add) for i in range(INV_LIMBS)]
    for i in range(INV_LIMBS - 1):
        d[i + 1], d[i] = d[i + 1] + (d[i] >> 30), d[i] & M30
    return d


def mont_inv_divsteps_plain(a: torch.Tensor, params: FieldParams = BN254_FR) -> torch.Tensor:
    """Plain version of :func:`mont_inv`'s ``inv_wide``: the same 20 x 30
    divsteps and the same updates as ``csrc/inv.cuh``, in int64 tensor ops
    over the 9 signed 30-bit limbs of every value (any device, any field).
    a R -> a^-1 R for canonical a R; 0 -> 0."""
    _check(a, "mont_inv_divsteps_plain a")
    words = inv_constants(params).tolist()
    m, r2, m_inv30 = words[:INV_LIMBS], words[INV_LIMBS : 2 * INV_LIMBS], words[-1]
    x = a.reshape(-1, LIMBS).to(torch.int64) & M32
    g = []
    for i in range(INV_LIMBS):
        w, s = divmod(30 * i, 32)
        bits = x[:, w] >> s
        if s > 2 and w + 1 < LIMBS:
            bits = bits | (x[:, w + 1] << (32 - s))
        g.append(bits & M30)
    f = [torch.full_like(g[0], v) for v in m]
    d = [torch.zeros_like(g[0]) for _ in range(INV_LIMBS)]
    e = [torch.full_like(g[0], v) for v in r2]
    zeta = torch.full_like(g[0], -1)
    for _ in range(INV_BATCHES):
        zeta, t = _divsteps_30(zeta, f[0], g[0])
        _update_de(d, e, t, m, m_inv30)
        _update_fg(f, g, t)
    d = _normalize(d, f[-1], m)
    words32 = []
    for k in range(LIMBS):
        limb, s = divmod(32 * k, 30)
        words32.append(((d[limb] >> s) | (d[limb + 1] << (30 - s))) & M32)
    return wrap_i32(torch.stack(words32, dim=-1)).reshape(a.shape)


def divsteps_to_zero(x: int, modulus: int) -> int:
    """Divsteps (delta from 1/2, as ``inv.cuh`` runs them) until g reaches 0
    from f = modulus, g = x, on Python ints: how long the run of x is.  The
    kernel runs 600 whatever it is; a long run is an edge case for its
    tests."""
    zeta, f, g, steps = -1, modulus, x, 0
    while g:
        if g & 1:
            if zeta < 0:
                f, g, zeta = g, g - f, -zeta - 2
            else:
                g, zeta = g + f, zeta - 1
        else:
            zeta -= 1
        g >>= 1
        steps += 1
    return steps


def mont_inv(a: torch.Tensor, params: FieldParams = BN254_FR) -> torch.Tensor:
    """Inverses in Montgomery form, a R -> a^-1 R, zero to zero; a canonical.
    A wide field (:func:`is_wide`): one ``inv_wide`` launch on a CUDA tensor
    (``csrc/inv.cu``, constant-time divsteps), :func:`mont_inv_divsteps_plain`
    on a CPU tensor.  A narrow field: :func:`mont_pow` at p - 2 (the ``pow``
    kernel's Fermat chain)."""
    _check(a, "mont_inv a")
    if not is_wide(params):
        return mont_pow(a, params.modulus - 2, params)
    if not a.is_cuda:
        return mont_inv_divsteps_plain(a, params)
    a = a.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // LIMBS
    if n:
        build.launch("inv_wide", a.data_ptr(), out.data_ptr(), n, _host_ptr(inv_constants(params)),
                     _stream(a))
    return out


# ---------------------------------------------------------------------------
# batch_inv
# ---------------------------------------------------------------------------


def _r_limbs(params: FieldParams, device) -> torch.Tensor:
    return torch.from_numpy(int_to_limbs32(params.r).copy()).to(device)


def _batch_inv_axis0_plain(b_m: torch.Tensor, params: FieldParams) -> torch.Tensor:
    """Batch inversion along axis 0: running prefix and suffix products
    around one Fermat chain."""
    G = b_m.shape[0]
    r = _r_limbs(params, b_m.device)
    is_zero = (b_m == 0).all(dim=-1, keepdim=True)
    b = torch.where(is_zero, r, b_m)
    prefix = torch.empty_like(b)
    suffix = torch.empty_like(b)
    prefix[0] = b[0]
    suffix[G - 1] = b[G - 1]
    for i in range(1, G):
        prefix[i] = mont_mul_plain(prefix[i - 1], b[i], params)
        suffix[G - 1 - i] = mont_mul_plain(b[G - 1 - i], suffix[G - i], params)
    total_inv = mont_pow_plain(prefix[G - 1], params.modulus - 2, params)  # (..., 8)
    # inv[i] = prefix[i-1] * suffix[i+1] * total_inv  (empty product = one)
    one = r.expand(b.shape[1:])[None]
    pre = torch.cat([one, prefix[:-1]], dim=0)
    suf = torch.cat([suffix[1:], one], dim=0)
    inv = mont_mul_plain(mont_mul_plain(pre, suf, params), total_inv[None], params)
    return torch.where(is_zero, torch.zeros_like(inv), inv)


def mont_batch_inv_plain(
    a: torch.Tensor, params: FieldParams = BN254_FR, axis: int = 0, max_scan: int = 256
) -> torch.Tensor:
    """Plain version of :func:`mont_batch_inv` (any device): Montgomery's
    trick in tensor ops.  The axis is cut into chunks of ``max_scan`` that are
    inverted side by side (the chunks share every op)."""
    if a.shape[axis] == 1:
        return mont_pow_plain(a, params.modulus - 2, params)
    a_m = torch.movedim(a, axis, 0)  # (G, ..., 8)
    G = a_m.shape[0]
    rest = a_m.shape[1:]
    gc = min(G, max_scan)
    C = -(-G // gc)
    pad = C * gc - G
    if pad:
        a_m = torch.cat([a_m, _r_limbs(params, a.device).expand((pad,) + rest)], dim=0)
    # (C, gc, ...) -> (gc, C, ...): step i of every chunk is one contiguous slab.
    chunks = a_m.reshape((C, gc) + rest).movedim(1, 0).contiguous()
    inv = _batch_inv_axis0_plain(chunks, params)
    inv = inv.movedim(0, 1).reshape((C * gc,) + rest)[:G]
    return torch.movedim(inv, 0, axis)


# batch_inv.cu's INV_MAX_LANES: the most chunks a block.
BATCH_INV_MAX_LANES = 256


class BatchInvPlan(NamedTuple):
    g: int              # rows a chunk (a lane)
    lanes: int          # chunks a block: neighbouring columns of one chunk
    blocks: int         # one Fermat chain each


def batch_inv_plan(G: int, L: int, max_scan: int, sms: int) -> BatchInvPlan:
    """The launch of one ``batch_inv`` over a (G, L) panel along axis 0 on a
    card of ``sms`` multiprocessors.

    Chunks of g = min(G, max_scan) rows.  A block's lanes are the fewest (a
    power of two from 32 to 256) that leave at most two blocks, two chains, an
    SM: a chain is one thread's ~305 dependent products, and where more blocks
    share an SM their chains meet on a scheduler (on an H100, 65,536 values in
    2 rows: 0.21 ms at 512 blocks, 0.16 at 256; `chip_smoke.py` row 9's
    `fold_2x32768_ms_by_lanes`).  Every lane's prefixes wait in the output
    through its block's chain."""
    if G < 1 or L < 1 or max_scan < 1 or sms < 1:
        raise ValueError("batch_inv_plan: G, L, max_scan and sms must be positive")
    g = min(G, max_scan)
    chunks = -(-G // g)
    lanes = 32
    while lanes < min(BATCH_INV_MAX_LANES, 32 * -(-L // 32)) and chunks * -(-L // lanes) > 2 * sms:
        lanes *= 2
    return BatchInvPlan(g, lanes, chunks * -(-L // lanes))


def mont_batch_inv(
    a: torch.Tensor, params: FieldParams = BN254_FR, axis: int = 0, max_scan: int = 256
) -> torch.Tensor:
    """Inverses in Montgomery form (a R -> a^-1 R) along ``axis`` by
    Montgomery's trick, in chunks of at most ``max_scan`` values that each
    share one Fermat chain; zero maps to zero.  Any chunking gives the same
    bits: inverses are unique and every output is canonical.  On the CUDA
    route the axis is moved to the front once (no copy for axis 0 of a
    contiguous tensor) and one ``batch_inv`` launch does the rest."""
    _check(a, "mont_batch_inv a")
    if a.dim() < 2 or axis % a.dim() == a.dim() - 1:
        raise ValueError("mont_batch_inv: axis must be a batch axis, not the limb axis")
    if max_scan < 1:
        raise ValueError("mont_batch_inv: max_scan must be at least 1")
    if not a.is_cuda:
        return mont_batch_inv_plain(a, params, axis, max_scan)
    a_m = torch.movedim(a, axis, 0).contiguous()
    G = a_m.shape[0]
    L = a_m.numel() // (G * LIMBS) if G else 0
    sms = torch.cuda.get_device_properties(a_m.device).multi_processor_count
    plan = batch_inv_plan(G, L, max_scan, sms) if L else None
    return torch.movedim(batch_inv_launch(a_m, params, plan), 0, axis)


def batch_inv_launch(a_m: torch.Tensor, params: FieldParams, plan: Optional[BatchInvPlan]) -> torch.Tensor:
    """One ``batch_inv`` launch along axis 0 of a contiguous CUDA tensor with
    the given plan (:func:`mont_batch_inv` passes :func:`batch_inv_plan`'s;
    a measurement may force another).  ``plan`` None: an empty panel."""
    out = torch.empty_like(a_m)
    if plan is not None:
        build.launch(
            "batch_inv_wide" if is_wide(params) else "batch_inv", a_m.data_ptr(), out.data_ptr(),
            a_m.shape[0], a_m.numel() // (a_m.shape[0] * LIMBS), plan.g, plan.lanes,
            _host_ptr(pow_schedule_words(params.modulus - 2)), _host_ptr(field_words(params)),
            _stream(a_m),
        )
    return out


# ---------------------------------------------------------------------------
# dot
# ---------------------------------------------------------------------------


def mont_dot_plain(
    lin_vals, lin_coeff, mul_vals1, mul_vals2, mul_coeff, qc, scale=None,
    params: FieldParams = BN254_FR,
) -> torch.Tensor:
    """Plain version of :func:`mont_dot`: the chain evaluated op by op."""
    some = lin_vals if lin_vals is not None else mul_vals1
    E, _, B, _ = some.shape
    hf = half_field(params, some.device)
    acc = split_half(qc)[:, None, :].expand(E, B, HALF)
    if lin_vals is not None:
        c = split_half(lin_coeff)
        v = split_half(lin_vals)
        for t in range(lin_vals.shape[1]):
            acc = hf.add(acc, hf.mont_mul(c[:, t, None, :], v[:, t]))
    if mul_vals1 is not None:
        c = split_half(mul_coeff)
        v1 = split_half(mul_vals1)
        v2 = split_half(mul_vals2)
        for t in range(mul_vals1.shape[1]):
            prod = hf.mont_mul(v1[:, t], v2[:, t])
            acc = hf.add(acc, hf.mont_mul(c[:, t, None, :], prod))
    if scale is not None:
        acc = hf.mont_mul(split_half(scale)[:, None, :], acc)
    return join_half(acc)


def mont_dot(
    lin_vals: Optional[torch.Tensor],
    lin_coeff: Optional[torch.Tensor],
    mul_vals1: Optional[torch.Tensor],
    mul_vals2: Optional[torch.Tensor],
    mul_coeff: Optional[torch.Tensor],
    qc: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    params: FieldParams = BN254_FR,
) -> torch.Tensor:
    """Expression-panel evaluation over gathered operands:

        out[e, b] = [scale[e] *R] ( qc[e]
                    + sum_t lin_coeff[e, t] *R lin_vals[e, t, b]
                    + sum_k mul_coeff[e, k] *R (mul_vals1[e, k, b] *R mul_vals2[e, k, b]) )

    ``*R`` is the Montgomery product; coefficients arrive pre-scaled (c*R for
    linear terms, c*R^2 for products) so standard-form operands give a
    standard-form result.  Shapes (gate-major): lin_vals (E, T1, B, 8);
    mul_vals* (E, T2, B, 8); coeffs (E, T*, 8); qc / scale (E, 8).  Returns
    (E, B, 8) canonical.  A panel with no terms passes ``None`` for it; at
    least one of the two must be present."""
    require_narrow(params, "mont_dot")
    some = lin_vals if lin_vals is not None else mul_vals1
    if some is None:
        raise ValueError("mont_dot: a panel needs linear or product terms")
    for name, t in (("lin_vals", lin_vals), ("lin_coeff", lin_coeff),
                    ("mul_vals1", mul_vals1), ("mul_vals2", mul_vals2),
                    ("mul_coeff", mul_coeff), ("qc", qc), ("scale", scale)):
        if t is not None:
            _check(t, f"mont_dot {name}")
            if t.device != some.device:
                raise ValueError(f"mont_dot: {name} on another device")
    E, _, B, _ = some.shape
    t1 = lin_vals.shape[1] if lin_vals is not None else 0
    t2 = mul_vals1.shape[1] if mul_vals1 is not None else 0
    if t1 and tuple(lin_coeff.shape) != (E, t1, LIMBS):
        raise ValueError("mont_dot: lin_coeff shape")
    if t2 and (tuple(mul_coeff.shape) != (E, t2, LIMBS)
               or mul_vals2.shape != mul_vals1.shape):
        raise ValueError("mont_dot: mul operand shapes")
    if not some.is_cuda:
        return mont_dot_plain(
            lin_vals, lin_coeff, mul_vals1, mul_vals2, mul_coeff, qc, scale, params
        )

    def ptr(t):
        return None if t is None else t.data_ptr()

    tensors = [
        None if t is None else t.contiguous()
        for t in (lin_vals, lin_coeff, mul_vals1, mul_vals2, mul_coeff, qc, scale)
    ]
    out = torch.empty((E, B, LIMBS), dtype=torch.int32, device=some.device)
    if E and B:
        build.launch(
            "dot", *[ptr(t) for t in tensors], out.data_ptr(), E, B, t1, t2,
            _host_ptr(field_words(params)), _stream(some),
        )
    return out


# ---------------------------------------------------------------------------
# first generation: mul_v1, dot_v1 (the dot_kernel="v1" route of eval_exprs)
# ---------------------------------------------------------------------------


def mont_mul_v1_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`mont_mul_v1` (any device)."""
    return mont_mul_plain(a, b, BN254_FR)


def mont_mul_v1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p over BN254 Fr, the first-generation kernel: the
    operands are broadcast against each other and flattened, as the
    reference's ``mont_mul_pallas_flex`` does (its padding to 512-row tiles
    was the TPU's and is not copied).  Canonical result of the broadcast
    shape."""
    _check(a, "mont_mul_v1 a")
    _check(b, "mont_mul_v1 b")
    if not a.is_cuda:
        return mont_mul_v1_plain(a, b)
    if b.device != a.device:
        raise ValueError("mont_mul_v1: operands on different devices")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape).contiguous()
    b = b.expand(shape).contiguous()
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // LIMBS
    if n:
        build.launch("mul_v1", a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _stream(a))
    return out


def mont_dot_v1_plain(
    vals: torch.Tensor, coeff: torch.Tensor, qc: torch.Tensor,
    scale: Optional[torch.Tensor] = None, params: FieldParams = BN254_FR,
) -> torch.Tensor:
    """Plain version of :func:`mont_dot_v1`: the linear chain of the plain
    dot over the one operand panel."""
    return mont_dot_plain(vals, coeff, None, None, None, qc, scale, params)


def mont_dot_v1(
    vals: torch.Tensor, coeff: torch.Tensor, qc: torch.Tensor,
    scale: Optional[torch.Tensor] = None, params: FieldParams = BN254_FR,
) -> torch.Tensor:
    """The first-generation expression dot, products already multiplied:

        out[e, b] = [scale[e] *R] ( qc[e] + sum_t coeff[e, t] *R vals[e, t, b] )

    ``vals`` (E, T, B, 8) with T >= 1, ``coeff`` (E, T, 8), ``qc`` / ``scale``
    (E, 8); returns (E, B, 8) canonical.  ``qc`` is added as given."""
    require_narrow(params, "mont_dot_v1")
    for name, t in (("vals", vals), ("coeff", coeff), ("qc", qc), ("scale", scale)):
        if t is not None:
            _check(t, f"mont_dot_v1 {name}")
            if t.device != vals.device:
                raise ValueError(f"mont_dot_v1: {name} on another device")
    if vals.dim() != 4 or vals.shape[1] == 0:
        raise ValueError("mont_dot_v1: vals must be (E, T, B, 8) with T >= 1")
    E, T, B, _ = vals.shape
    if tuple(coeff.shape) != (E, T, LIMBS) or tuple(qc.shape) != (E, LIMBS) or (
        scale is not None and tuple(scale.shape) != (E, LIMBS)
    ):
        raise ValueError("mont_dot_v1: coefficient shapes")
    if not vals.is_cuda:
        return mont_dot_v1_plain(vals, coeff, qc, scale, params)
    vals, coeff, qc = vals.contiguous(), coeff.contiguous(), qc.contiguous()
    scale = None if scale is None else scale.contiguous()
    out = torch.empty((E, B, LIMBS), dtype=torch.int32, device=vals.device)
    if E and B:
        build.launch(
            "dot_v1", vals.data_ptr(), coeff.data_ptr(), qc.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(), E, B, T,
            _host_ptr(field_words(params)), _stream(vals),
        )
    return out
