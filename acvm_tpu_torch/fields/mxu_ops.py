"""Expression-panel evaluation on the matrix unit: the tensor cores.

The counterpart of the JAX package's ``fields/mxu_ops.py``.  There the
matrix unit is the TPU's MXU (exact bf16 einsums); here it is the H100's
tensor cores, through their exact-integer product of unsigned bytes
(``mma.sync ... .s32.u8.u8.s32``).  The arithmetic facts are the same:

1. **Limb convolution is a matrix product against a Toeplitz matrix.**  With
   8-bit limbs, ``c * v`` has convolution columns ``sum_{i+j=k} c_i v_j``; for
   the per-gate coefficient ``c`` (shared by the batch) that is ``v8 @
   Toeplitz(c8)``, the instances on the product's other axis.
2. **Byte products summed in int32 are exact.**  Each column is at most
   ``T * 32 * 255^2 < 2^24`` for T <= 8 terms.
3. **Montgomery reduction is linear**, so ONE reduction per (gate, instance)
   covers the whole sum: REDC(sum_t c_t R * v_t + qc R) = sum_t c_t v_t + qc.

So ``mont_dot_mxu`` replaces T Montgomery products and the modular adds of a
panel by one byte convolution and one reduction.  The hand-written kernel is
``csrc/dot_mxu.cu`` (:func:`mont_dot_mxu` launches it for a CUDA tensor, or
raises); :func:`mont_dot_mxu_plain` repeats its arithmetic in int64 torch ops
for a CPU tensor.  The reduction of the 512-bit sum X = X_lo + X_hi 2^256 is
``X_lo * 1 * R^-1 + X_hi mod p`` (one Montgomery product by the integer 1 and
one conditional subtract): the JAX package's constant-matrix REDC feeds bytes
of up to 256 into its matrix products, which an unsigned-byte operand cannot
hold, and the REDC is one step a (gate, instance) where the convolution is
32 T x 32 byte products (the kernel's source says more).

Bounds (enforced by :func:`mxu_ok`, BN254 and 1 <= T <= 8): every operand is
canonical (< p), so X < T p^2 + p < 2^512, and with p < 0.19 x 2^256 the high
half X_hi < 0.19 T p + 1 < 2p, which one conditional subtract reduces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build
from .kernels import (
    HALF,
    LIMBS,
    M32,
    _check,
    _host_ptr,
    _stream,
    carry_half,
    field_words,
    half_field,
    join_half,
    split_half,
)
from .params import BN254_FR, FieldParams

N8 = 2 * HALF  # 8-bit limbs of an element (32)
CONV = 2 * N8 - 1  # convolution columns (63)
MAX_TERMS = 8
# int64 elements of one chunk of the plain version's byte panel: the plain
# version walks the gates in chunks so that a card-sized panel fits.
PLAIN_CHUNK = 1 << 24


def mxu_ok(params: FieldParams, terms: int) -> bool:
    """A panel of ``terms`` terms over ``params`` takes the tensor-core route:
    BN254 and 1 <= terms <= 8 (the bounds above).  The JAX package's gate also
    asks for an opt-in and a batch that fills the MXU; here the opt-in is
    ``BatchSolver(dot_kernel="mxu")`` and any batch is taken."""
    return params.name == "bn254" and 1 <= terms <= MAX_TERMS


def split8(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 limbs -> (..., 32) int64 bytes, little-endian."""
    u = x.to(torch.int64) & M32
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=x.device)
    return ((u[..., None] >> shifts) & 0xFF).reshape(*x.shape[:-1], N8)


def conv_plain(v8: torch.Tensor, c8: torch.Tensor) -> torch.Tensor:
    """(E, T, B, 32) operand bytes and (E, T, 32) coefficient bytes ->
    (E, B, 63) int64 convolution columns, summed over the terms."""
    E, T, B, _ = v8.shape
    conv = torch.zeros((E, B, CONV), dtype=torch.int64, device=v8.device)
    for t in range(T):
        for j in range(N8):
            conv[:, :, j : j + N8] += v8[:, t, :, j, None] * c8[:, t, None, :]
    return conv


def redc_plain(conv: torch.Tensor, qc: torch.Tensor, params: FieldParams = BN254_FR) -> torch.Tensor:
    """(..., 63) convolution columns (each < 2^24) plus ``qc`` (broadcast
    (..., 8) int32, Montgomery form) -> (..., 8) canonical (X R^-1 mod p),
    the kernel's reduction in 16-bit half-limbs: X_lo * 1 * R^-1 + X_hi."""
    hf = half_field(params, conv.device)
    x = F.pad(conv, (0, 1))
    halves = x[..., 0::2] + (x[..., 1::2] << 8)  # (..., 32) columns < 2^33
    halves = halves + F.pad(split_half(qc), (0, HALF))
    X = carry_half(halves, bits=35)  # X < 2^512: no carry out of the top
    one = torch.zeros(HALF, dtype=torch.int64, device=conv.device)
    one[0] = 1
    lo = hf.mont_mul(one, X[..., :HALF])  # X_lo R^-1, canonical
    hi = hf.cond_sub(X[..., HALF:])  # X_hi < 2p
    return join_half(hf.add(lo, hi))


def _check_panel(vals, coeffs, qc, params, name):
    for label, t in (("vals", vals), ("coeffs", coeffs), ("qc", qc)):
        _check(t, f"{name} {label}")
        if t.device != vals.device:
            raise ValueError(f"{name}: {label} on another device")
    if vals.dim() != 4:
        raise ValueError(f"{name}: vals must be (E, T, B, 8)")
    E, T, B, _ = vals.shape
    if tuple(coeffs.shape) != (E, T, LIMBS) or tuple(qc.shape) != (E, LIMBS):
        raise ValueError(f"{name}: coeffs must be (E, T, 8) and qc (E, 8)")
    if not mxu_ok(params, T):
        raise ValueError(
            f"{name}: the tensor-core dot takes BN254 panels of 1-{MAX_TERMS} terms, "
            f"not {T} over {params.name} (mxu_ok)")
    return E, T, B


def mont_dot_mxu_plain(
    vals: torch.Tensor, coeffs: torch.Tensor, qc: torch.Tensor, params: FieldParams = BN254_FR
) -> torch.Tensor:
    """Plain version of :func:`mont_dot_mxu` (any device): the byte
    convolution and the reduction in int64 torch ops, the gates in chunks."""
    E, T, B = _check_panel(vals, coeffs, qc, params, "mont_dot_mxu_plain")
    out = torch.empty((E, B, LIMBS), dtype=torch.int32, device=vals.device)
    step = max(1, PLAIN_CHUNK // max(1, T * B * N8))
    for e0 in range(0, E, step):
        e1 = min(E, e0 + step)
        conv = conv_plain(split8(vals[e0:e1]), split8(coeffs[e0:e1]))
        out[e0:e1] = redc_plain(conv, qc[e0:e1, None, :], params)
    return out


def mont_dot_mxu(
    vals: torch.Tensor, coeffs: torch.Tensor, qc: torch.Tensor, params: FieldParams = BN254_FR
) -> torch.Tensor:
    """Fused expression-panel evaluation on the tensor cores:

        out[e, b] = qc[e] + sum_t coeffs[e, t] *R vals[e, t, b]

    in the port's gate-major layout: ``vals`` (E, T, B, 8) int32 standard
    form, canonical (as ``eval_exprs`` gathers it); ``coeffs`` (E, T, 8)
    Montgomery form (c R, or c R^2 where the panel holds w1 w2 R^-1
    products); ``qc`` (E, 8) **Montgomery form** (qc R), as the JAX
    package's.  Returns (E, B, 8) canonical standard form.  A CUDA tensor
    launches ``dot_mxu`` (or raises); a CPU tensor runs the plain version."""
    E, T, B = _check_panel(vals, coeffs, qc, params, "mont_dot_mxu")
    if not vals.is_cuda:
        return mont_dot_mxu_plain(vals, coeffs, qc, params)
    vals, coeffs, qc = vals.contiguous(), coeffs.contiguous(), qc.contiguous()
    out = torch.empty((E, B, LIMBS), dtype=torch.int32, device=vals.device)
    if E and B:
        build.launch(
            "dot_mxu", vals.data_ptr(), coeffs.data_ptr(), qc.data_ptr(), out.data_ptr(),
            E, B, T, _host_ptr(field_words(params)), _stream(vals),
        )
    return out


def panel_ops(E: int, T: int, B: int) -> dict:
    """What the function needs for one panel: bytes read and written once,
    byte products of the convolutions (32 x 32 a term) and the reduction's
    32-bit multiply-adds (one Montgomery product, 136)."""
    return {
        "bytes": (E * T * B + E * T + E + E * B) * LIMBS * 4,
        "u8_macs": E * B * T * N8 * N8,
        "madds": E * B * 136,
    }

