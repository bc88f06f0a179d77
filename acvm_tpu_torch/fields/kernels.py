"""Field kernels: Montgomery multiply, fixed-exponent power, expression dot.

A field element is 8 little-endian 32-bit limbs stored as ``torch.int32`` (the
bit pattern of uint32; torch's CPU uint32 has no arithmetic), Montgomery form
with R = 2^256, canonical (< p) unless stated.

Each public function here is a wrapper with two routes and nothing between:

* a CUDA tensor launches the hand-written kernel under ``csrc/`` (built at
  first use, see :mod:`acvm_tpu_torch.build`) or raises;
* a CPU tensor runs the plain PyTorch version beside it (``*_plain``): int64
  arithmetic over 16-bit half-limbs, the CIOS recurrence written out op by op.

What each kernel replaces in the JAX package, and what bounds it on an H100:

* ``mont_mul``  — ``fields/pallas_mul_v2.py::_make_mul_kernel``.  96 bytes and
  136 32-bit multiply-adds per element: bound by the integer pipes.
* ``mont_pow``  — ``fields/pallas_mul.py::_make_pow_kernel``.  335 multiplies
  per 64 bytes: bound by the integer pipes; the whole chain stays in registers
  and local memory.
* ``mont_dot``  — ``fields/pallas_mul_v2.py::_make_dot_kernel_v2``.  32 bytes
  per operand against 136 multiply-adds per product: integer pipes at the usual
  2-3 terms; one launch per expression panel keeps every intermediate out of
  device memory.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

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


@lru_cache(maxsize=None)
def field_words(params: FieldParams) -> np.ndarray:
    """The 17 uint32 words [p | R mod p | n0] every C launcher takes."""
    if 2 * params.modulus >= 1 << 256:
        raise NotImplementedError(
            f"field {params.name}: moduli with 2p >= 2^256 (the wide mode of "
            "the JAX LimbContext) are not ported"
        )
    words = np.zeros(2 * LIMBS + 1, dtype=np.uint32)
    words[:LIMBS] = int_to_limbs32(params.modulus).view(np.uint32)
    words[LIMBS : 2 * LIMBS] = int_to_limbs32(params.r).view(np.uint32)
    words[2 * LIMBS] = n0_inv32(params)
    return words


@lru_cache(maxsize=None)
def _p_half(params: FieldParams, device: torch.device) -> torch.Tensor:
    field_words(params)  # refuses wide moduli
    return torch.tensor(
        [(params.modulus >> (16 * i)) & M16 for i in range(HALF)],
        dtype=torch.int64, device=device,
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
    u = h[..., 0] | (h[..., 1] << 16)
    # uint32 value -> the int32 with the same bit pattern, without relying on
    # how a narrowing cast treats values >= 2^31.
    return (((u + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def carry_half(t: torch.Tensor) -> torch.Tensor:
    """Propagate (signed) carries through (..., 16) int64 accumulations; the
    carry out of the top half-limb is dropped (callers know it is zero, or a
    multiple of 2^256 they mean to discard)."""
    out = []
    carry = torch.zeros_like(t[..., 0])
    for i in range(HALF):
        v = t[..., i] + carry
        out.append(v & M16)
        carry = v >> 16  # arithmetic shift: a borrow travels as -1
    return torch.stack(out, dim=-1)


def cond_sub_half(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """a - p where a >= p, else a.  a normalized, a < 2p."""
    out = []
    carry = torch.zeros_like(a[..., 0])
    for i in range(HALF):
        v = a[..., i] - p[i] + carry
        out.append(v & M16)
        carry = v >> 16
    diff = torch.stack(out, dim=-1)
    return torch.where((carry == 0)[..., None], diff, a)


def add_half(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return cond_sub_half(carry_half(a + b), p)


def mul_half(
    a: torch.Tensor, b: torch.Tensor, p: torch.Tensor, n0: int, reduce: bool = True
) -> torch.Tensor:
    """CIOS Montgomery product over 16-bit half-limbs, 16 rounds.  int64 has
    the headroom to keep whole products in one accumulator word (each round
    adds < 2^33 a word, 2^37 over the chain), so carries are propagated once,
    at the end.  Result < 2p; canonical with ``reduce``."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape)
    b = b.expand(shape)
    t = torch.zeros(shape, dtype=torch.int64, device=a.device)
    zero = torch.zeros(shape[:-1] + (1,), dtype=torch.int64, device=a.device)
    for i in range(HALF):
        t = t + a[..., i : i + 1] * b
        m = ((t[..., 0:1] & M16) * n0) & M16
        t = t + m * p
        # t[0] is now divisible by 2^16: shift down one half-limb.
        t = torch.cat([t[..., 1:2] + (t[..., 0:1] >> 16), t[..., 2:], zero], dim=-1)
    t = carry_half(t)
    return cond_sub_half(t, p) if reduce else t


# ---------------------------------------------------------------------------
# mul
# ---------------------------------------------------------------------------


def mont_mul_plain(
    a: torch.Tensor, b: torch.Tensor, params: FieldParams = BN254_FR,
    reduce: bool = True,
) -> torch.Tensor:
    """Plain version of :func:`mont_mul` (any device)."""
    p = _p_half(params, a.device)
    return join_half(mul_half(split_half(a), split_half(b), p, params.n0_inv, reduce))


def mont_mul(
    a: torch.Tensor, b: torch.Tensor, params: FieldParams = BN254_FR,
    reduce: bool = True, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """a * b * R^-1 mod p, elementwise with broadcasting over the leading
    axes.  ``reduce=False`` returns the redundant representative < 2p.
    ``out`` (contiguous, of the broadcast shape; may be ``a``) receives the
    result on the CUDA route."""
    _check(a, "mont_mul a")
    _check(b, "mont_mul b")
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
            "mul", a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            int(b_broadcast), int(reduce), _host_ptr(field_words(params)), _stream(a),
        )
    return out


# ---------------------------------------------------------------------------
# pow
# ---------------------------------------------------------------------------


def mont_pow_plain(
    a: torch.Tensor, exponent: int, params: FieldParams = BN254_FR
) -> torch.Tensor:
    """Plain version of :func:`mont_pow`: the same 4-bit-window chain."""
    p = _p_half(params, a.device)
    n0 = params.n0_inv
    base = split_half(a)
    one = torch.tensor(
        [(params.r >> (16 * i)) & M16 for i in range(HALF)],
        dtype=torch.int64, device=a.device,
    ).expand(base.shape)
    table = [one]
    for _ in range(15):
        table.append(mul_half(table[-1], base, p, n0))
    acc = one
    # Leading zero windows are identity steps (R squared stays R, a^0 = R).
    for w in range((max(exponent.bit_length(), 1) - 1) // 4, -1, -1):
        for _ in range(4):
            acc = mul_half(acc, acc, p, n0)
        acc = mul_half(acc, table[(exponent >> (4 * w)) & 0xF], p, n0)
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
        exp_words = np.ascontiguousarray(int_to_limbs32(exponent).view(np.uint32))
        build.launch(
            "pow", a.data_ptr(), out.data_ptr(), n, _host_ptr(exp_words),
            _host_ptr(field_words(params)), _stream(a),
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
    p = _p_half(params, some.device)
    n0 = params.n0_inv
    acc = split_half(qc)[:, None, :].expand(E, B, HALF)
    if lin_vals is not None:
        c = split_half(lin_coeff)
        v = split_half(lin_vals)
        for t in range(lin_vals.shape[1]):
            acc = add_half(acc, mul_half(c[:, t, None, :], v[:, t], p, n0), p)
    if mul_vals1 is not None:
        c = split_half(mul_coeff)
        v1 = split_half(mul_vals1)
        v2 = split_half(mul_vals2)
        for t in range(mul_vals1.shape[1]):
            prod = mul_half(v1[:, t], v2[:, t], p, n0)
            acc = add_half(acc, mul_half(c[:, t, None, :], prod, p, n0), p)
    if scale is not None:
        acc = mul_half(split_half(scale)[:, None, :], acc, p, n0)
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
