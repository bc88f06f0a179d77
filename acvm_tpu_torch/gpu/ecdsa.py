"""Batched ECDSA verification over secp256k1 / secp256r1 on limb tensors.

Port of ``acvm_tpu/tpu/ecdsa.py``: the device analogue of the host verifiers
(:mod:`acvm_tpu_torch.blackbox.ecdsa`, mirroring the reference
``blackbox_solver/src/lib.rs:101-210``): prehashed message, low-S rule, and the
reference's errors as a per-instance ``err`` mask.  The base field and the
group order of both curves are 256-bit moduli, so every field operation runs
in the *wide* mode of :class:`LimbContext` (``mul_wide`` on the card, and
``inv_wide``, constant-time divsteps, for s^-1 and Z^-1).

R = u1 G + u2 Q is ONE launch of ``csrc/ecdsa_mul.cu`` (:func:`ecdsa_mul`), a
thread a verification, where the reference gathers the generator's window
entries into a tree of complete additions, scans 256 double-and-add steps for
u2 Q and adds the two, each a long sequence of limb ops.  The kernel sums u1 G
over the generator's 64 window entries, builds each lane's table of 1Q ... 8Q,
runs u2 Q over signed 4-bit windows (:func:`signed_windows`: 256 doublings and
64 complete additions, every lane adding at the same steps) and adds the two.
Its plain version :func:`ecdsa_mul_plain` runs that chain one field operation
at a time over half-limbs (``ec.pt_double``, the mixed addition :func:`pt_madd`
and ``ec.pt_add``, whose canonical values are those of ``csrc/ec.cuh``'s
formulas), so X, Y and Z agree limb for limb; the reference's chain is
another one, with the same affine R.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .. import build
from ..blackbox.ec import SECP256K1, SECP256R1, Curve
from ..fields import kernels as fk
from ..fields.kernels import LIMBS, M32, int_to_limbs32
from ..fields.params import FieldParams
from ..fields.torch_ops import LimbContext, geq
from . import ec, intops
from .ec import NUM_WINDOWS, WINDOW_BITS

CURVES = {"secp256k1": SECP256K1, "secp256r1": SECP256R1}


@lru_cache(maxsize=None)
def curve_fields(curve_name: str) -> Tuple[FieldParams, FieldParams]:
    """The base field Fp and the scalar field Fn of a curve."""
    cp = CURVES[curve_name]
    return (FieldParams(name=f"{curve_name}_p", modulus=cp.p),
            FieldParams(name=f"{curve_name}_n", modulus=cp.n))


@lru_cache(maxsize=None)
def _curve_ctxs(curve_name: str, device: str) -> Tuple[LimbContext, LimbContext]:
    return tuple(LimbContext(params, device) for params in curve_fields(curve_name))


def _a_minus_3(curve_name: str) -> bool:
    """Whether the curve's a is -3 (secp256r1) rather than 0 (secp256k1): the
    two doublings the kernel is built with."""
    cp = CURVES[curve_name]
    if cp.a % cp.p not in (0, cp.p - 3):
        raise NotImplementedError(f"ecdsa_mul: a = {cp.a} (only a = 0 and a = -3 are built)")
    return cp.a % cp.p != 0


def _mont(value: int, params: FieldParams) -> np.ndarray:
    return int_to_limbs32(value % params.modulus * params.r % params.modulus)


@lru_cache(maxsize=None)
def _gen_table_np(curve_name: str) -> np.ndarray:
    """Windowed multiples of the curve generator, Montgomery form over Fp:
    table[w][d] = d * 2^(4w) * G as (X, Y, Z = R), (64, 16, 3, 8) int32; d = 0
    (and any multiple at infinity) is all zeros.  The JAX package's table in
    this package's limbs (``convert.window_table_from_jax``)."""
    cp = CURVES[curve_name]
    curve = Curve(cp)
    fp, _ = curve_fields(curve_name)
    one = _mont(1, fp)
    table = np.zeros((NUM_WINDOWS, 1 << WINDOW_BITS, 3, LIMBS), np.int32)
    window_base = curve.generator()
    for w in range(NUM_WINDOWS):
        acc = None
        for d in range(1, 1 << WINDOW_BITS):
            acc = curve.add(acc, window_base)
            if acc is not None:
                table[w, d, 0] = _mont(acc[0], fp)
                table[w, d, 1] = _mont(acc[1], fp)
                table[w, d, 2] = one
        for _ in range(WINDOW_BITS):
            window_base = curve.add(window_base, window_base)
    table.setflags(write=False)
    return table


@lru_cache(maxsize=None)
def _gen_table_on(curve_name: str, device: str) -> torch.Tensor:
    return torch.from_numpy(_gen_table_np(curve_name).copy()).to(device)


def gen_table(curve_name: str, device) -> torch.Tensor:
    """The generator's window table on ``device`` (uploaded once a device)."""
    return _gen_table_on(curve_name, str(torch.device(device)))


@lru_cache(maxsize=None)
def _curve_consts(curve_name: str, device: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n // 2 + 1 standard, a and b Montgomery over Fp) as (8,) limbs on
    ``device``, uploaded once a device."""
    cp = CURVES[curve_name]
    fp, _ = curve_fields(curve_name)
    return tuple(torch.from_numpy(v.copy()).to(device)
                 for v in (int_to_limbs32(cp.n // 2 + 1), _mont(cp.a, fp), _mont(cp.b, fp)))


def _sub_once(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a - m where a >= m else a (one conditional subtract)."""
    return torch.where(geq(a, m)[..., None], intops.int_sub(a, m), a)


# ---------------------------------------------------------------------------
# R = u1 G + u2 Q: the kernel and its plain version
# ---------------------------------------------------------------------------


def mul_operands(curve_name: str, u1s, u2s, points):
    """Python ints -> the operands of :func:`ecdsa_mul` on the CPU: u1 and u2
    (B, 8) standard-form limbs of each scalar mod 2^256, Q (3, B, 8) with X =
    x R, Y = y R and Z = R mod p for each affine (x, y) of ``points``."""
    fp, _ = curve_fields(curve_name)
    p, R = fp.modulus, fp.r
    Q = np.stack([fk.ints_to_limbs32([pt[c] * R % p for pt in points]) for c in (0, 1)]
                 + [fk.ints_to_limbs32([R % p] * len(points))])
    return tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in (
        fk.ints_to_limbs32([k % (1 << 256) for k in u1s]),
        fk.ints_to_limbs32([k % (1 << 256) for k in u2s]), Q))


def _check_mul_operands(u1, u2, Q, table) -> int:
    for name, t in (("u1", u1), ("u2", u2), ("Q", Q), ("table", table)):
        if t.dtype != torch.int32 or t.shape[-1] != LIMBS:
            raise TypeError(f"ecdsa_mul: {name} must be int32 limbs, got {tuple(t.shape)} {t.dtype}")
        if t.device != u1.device:
            raise ValueError(f"ecdsa_mul: {name} on another device")
    B = u1.shape[0]
    if u1.shape != (B, LIMBS) or u2.shape != (B, LIMBS) or Q.shape != (3, B, LIMBS):
        raise ValueError(
            f"ecdsa_mul: u1, u2 (B, 8) and Q (3, B, 8), got {tuple(u1.shape)}, "
            f"{tuple(u2.shape)}, {tuple(Q.shape)}")
    if table.shape != (NUM_WINDOWS, 1 << WINDOW_BITS, 3, LIMBS):
        raise ValueError(f"ecdsa_mul: the generator's full window table, got {tuple(table.shape)}")
    return B


def _a_mont_half(curve_name: str, device):
    """The curve's a in Montgomery half-limbs for ``ec.pt_double`` where a =
    -3, None where a = 0."""
    if not _a_minus_3(curve_name):
        return None
    return fk.split_half(_curve_consts(curve_name, str(device))[1])


def _dbl(hf, p, a_mont):
    """2P as ``csrc/ec.cuh::ec_dbl`` gives it: ``ec.pt_double``, P at
    infinity kept as it is, limb for limb."""
    keep = ec.pt_is_inf(p)[..., None]
    return tuple(torch.where(keep, a, d) for a, d in zip(p, ec.pt_double(hf, p, a_mont)))


def pt_madd(hf, p, q, a_mont=None):
    """P + Q for a finite Q with Z = one (R mod p), one field operation at a
    time: ``csrc/ec.cuh::ec_madd`` (madd-2007-bl, 11 products), the same
    X, Y and Z as ``ec.pt_add`` on the same operands, over the half-limbs of
    a ``HalfField``; Q's Z is not read.  P at infinity
    gives Q; P == Q the doubling (on CPU tensors computed only where a lane
    takes it, the same bits); P == -Q has H = 0, so Z3 = 2 Z1 H = 0."""
    x1, y1, z1 = p
    x2, y2 = q[0], q[1]
    Z1Z1 = hf.mont_mul(z1, z1)
    H = hf.sub(hf.mont_mul(x2, Z1Z1), x1)
    Rr = hf.sub(hf.mont_mul(hf.mont_mul(y2, z1), Z1Z1), y1)
    I = hf.add(H, H)
    I = hf.mont_mul(I, I)
    J = hf.mont_mul(H, I)
    r2 = hf.add(Rr, Rr)
    V = hf.mont_mul(x1, I)
    x3 = hf.sub(hf.sub(hf.mont_mul(r2, r2), J), hf.add(V, V))
    Y1J = hf.mont_mul(y1, J)
    y3 = hf.sub(hf.mont_mul(r2, hf.sub(V, x3)), hf.add(Y1J, Y1J))
    z3 = hf.mont_mul(z1, H)
    z3 = hf.add(z3, z3)

    dbl = (hf.is_zero(H) & hf.is_zero(Rr))[..., None]
    if dbl.is_cuda or bool(dbl.any()):
        dx, dy, dz = ec.pt_double(hf, p, a_mont)
        x3, y3, z3 = (torch.where(dbl, d, v) for d, v in ((dx, x3), (dy, y3), (dz, z3)))
    one = hf.one.expand_as(z3)
    p_inf = ec.pt_is_inf(p)[..., None]
    return (torch.where(p_inf, x2, x3), torch.where(p_inf, y2, y3), torch.where(p_inf, one, z3))


LANE_ENTRIES = 8  # the lane's table: 1Q ... 8Q, the magnitudes of a signed 4-bit digit


def signed_windows(u: torch.Tensor) -> torch.Tensor:
    """(B, 8) standard-form scalars -> (B, 65) int64 digits s_0 ... s_64 with
    sum s_i 16^i = u, s_i in [-8, 8) for i < 64 and s_64 in {0, 1}: the
    nibbles of u + 0x888...8 (64 eights) less 8, and the sum's carry, the
    kernel's recoding."""
    v = u.to(torch.int64) & M32
    carry = torch.zeros_like(v[:, 0])
    digits = []
    for limb in range(LIMBS):
        s = v[:, limb] + 0x88888888 + carry
        carry = s >> 32
        digits += [((s >> (4 * k)) & 15) - 8 for k in range(8)]
    return torch.stack(digits + [carry], dim=1)


def _lane_table(hf, base, a_mont):
    """The lane's table (e + 1) Q for e = 0 .. 7 as half-limb triples: Q with
    Z = one, 2Q a doubling, 3Q ... 8Q mixed additions of Q."""
    table = [(base[0], base[1], hf.one.expand_as(base[0]))]
    table.append(_dbl(hf, table[0], a_mont))
    for _ in range(2, LANE_ENTRIES):
        table.append(pt_madd(hf, table[-1], base, a_mont))
    return table


def lane_table_plain(curve_name: str, Q: torch.Tensor) -> torch.Tensor:
    """The table each lane of ``ecdsa_mul`` builds from its Q ((3, B, 8)
    Montgomery, Z = R mod p; the Z plane is not read): (8, 3, B, 8), entry e
    = (e + 1) Q, Jacobian Montgomery."""
    fp, _ = curve_fields(curve_name)
    hf = fk.half_field(fp, Q.device)
    base = fk.split_half(Q)
    table = _lane_table(hf, (base[0], base[1]), _a_mont_half(curve_name, Q.device))
    return torch.stack([fk.join_half(torch.stack(entry)) for entry in table])


def ecdsa_mul_plain(curve_name: str, u1: torch.Tensor, u2: torch.Tensor, Q: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ecdsa_mul` (any device): the kernel's chain one
    field operation at a time over int64 half-limbs.  u1 G as the sum of
    T[w][d_w] over the 64 windows of u1 in order, each a mixed addition
    (:func:`pt_madd`; a zero digit adds nothing); the lane's table of 1Q ...
    8Q; u2 Q from its top digit (Q or infinity) over the 64 signed windows
    (:func:`signed_windows`) MSB first, four doublings (infinity kept as it
    is, limb for limb) and, for a nonzero digit s, ``acc + sign(s) |s| Q``
    (``ec.pt_add``, a negative entry (X, p - Y, Z)); then R = u2 Q + u1 G
    (``ec.pt_add``)."""
    B = _check_mul_operands(u1, u2, Q, table)
    fp, _ = curve_fields(curve_name)
    hf = fk.half_field(fp, u1.device)
    a_mont = _a_mont_half(curve_name, u1.device)
    zero = torch.zeros((B, fk.HALF), dtype=torch.int64, device=u1.device)
    digits = ec._window_digits(u1)  # (B, 64)
    flat = table.reshape(NUM_WINDOWS << WINDOW_BITS, 3, LIMBS)
    g1 = (zero, zero, zero)
    for w in range(NUM_WINDOWS):
        entry = fk.split_half(flat.index_select(0, digits[:, w] + (w << WINDOW_BITS)))
        added = pt_madd(hf, g1, (entry[:, 0], entry[:, 1]), a_mont)
        take = (digits[:, w] != 0)[:, None]
        g1 = tuple(torch.where(take, n, o) for n, o in zip(added, g1))
    base = fk.split_half(Q)
    lane_table = torch.stack([torch.stack(e) for e in _lane_table(hf, (base[0], base[1]), a_mont)])
    lanes = torch.arange(B, device=u1.device)
    s = signed_windows(u2)
    top = (s[:, NUM_WINDOWS] != 0)[:, None]
    acc = tuple(torch.where(top, c, zero) for c in lane_table[0])
    for w in range(NUM_WINDOWS - 1, -1, -1):
        for _ in range(WINDOW_BITS):
            acc = _dbl(hf, acc, a_mont)
        d = s[:, w]
        entry = lane_table[(d.abs() - 1).clamp(min=0), :, lanes]  # (B, 3, 16)
        y = torch.where((d < 0)[:, None], hf.sub(zero, entry[:, 1]), entry[:, 1])
        added = ec.pt_add(hf, acc, (entry[:, 0], y, entry[:, 2]), a_mont)
        take = (d != 0)[:, None]
        acc = tuple(torch.where(take, n, o) for n, o in zip(added, acc))
    return fk.join_half(torch.stack(ec.pt_add(hf, acc, g1, a_mont)))


def ecdsa_mul(curve_name: str, u1: torch.Tensor, u2: torch.Tensor, Q: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
    """R = u1 G + u2 Q for B verifications -> (3, B, 8) Jacobian Montgomery.

    ``u1``, ``u2``: (B, 8) standard-form scalars (all 256 bits used);
    ``Q``: (3, B, 8) Jacobian Montgomery over Fp with Z = R mod p (an affine
    point; its Z plane is not read); ``table``: the generator's
    window table (:func:`gen_table`).  A CUDA tensor launches ``ecdsa_mul``
    once, a CPU tensor runs :func:`ecdsa_mul_plain`; X, Y and Z are the same
    limbs either way."""
    B = _check_mul_operands(u1, u2, Q, table)
    if not u1.is_cuda:
        return ecdsa_mul_plain(curve_name, u1, u2, Q, table)
    fp, _ = curve_fields(curve_name)
    a_minus_3 = _a_minus_3(curve_name)
    u1, u2, Q, table = (t.contiguous() for t in (u1, u2, Q, table))
    out = torch.empty((3, B, LIMBS), dtype=torch.int32, device=u1.device)
    if B:
        build.launch(
            "ecdsa_mul", u1.data_ptr(), u2.data_ptr(), Q.data_ptr(), table.data_ptr(),
            out.data_ptr(), B, int(a_minus_3), fk._host_ptr(fk.field_words(fp)),
            fk._stream(out),
        )
    return out


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


def ecdsa_verify_batched(
    curve_name: str,
    pub_x_bytes: torch.Tensor,  # (B, 32) big-endian bytes
    pub_y_bytes: torch.Tensor,  # (B, 32)
    sig_bytes: torch.Tensor,  # (B, 64)  r || s
    msg_bytes: torch.Tensor,  # (B, 32)  prehashed message
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(valid, err)`` boolean (B,) masks, on the inputs' device.

    ``err`` marks the instances the host verifier raises on (the reference's
    panicking unwraps, ``blackbox_solver/src/lib.rs:110-160``): a coordinate
    >= p, an off-curve public key, r or s zero or >= n, z >= n.  ``valid`` is
    the verification bit (False for high S, a wrong R or infinity), masked
    False where ``err``."""
    cp = CURVES[curve_name]
    device = pub_x_bytes.device
    ctx_p, ctx_n = _curve_ctxs(curve_name, str(device))

    x = ec.bytes_be_to_limbs(pub_x_bytes)
    y = ec.bytes_be_to_limbs(pub_y_bytes)
    r = ec.bytes_be_to_limbs(sig_bytes[:, :32])
    s = ec.bytes_be_to_limbs(sig_bytes[:, 32:])
    z = ec.bytes_be_to_limbs(msg_bytes)

    p_limbs, n_limbs = ctx_p.p_limbs, ctx_n.p_limbs
    is_zero = LimbContext.is_zero
    err = (geq(x, p_limbs) | geq(y, p_limbs) | geq(r, n_limbs) | is_zero(r)
           | geq(s, n_limbs) | is_zero(s) | geq(z, n_limbs))

    # The public key on the curve: y^2 == x^3 + a x + b over Fp.
    xm = ctx_p.to_mont(x)
    ym = ctx_p.to_mont(y)
    half_n_plus_1, a_mont, b_mont = _curve_consts(curve_name, str(device))
    rhs = ctx_p.mont_mul(ctx_p.mont_mul(xm, xm), xm)
    if cp.a % cp.p:
        rhs = ctx_p.add(rhs, ctx_p.mont_mul(xm, a_mont))
    rhs = ctx_p.add(rhs, b_mont.expand_as(xm))
    err = err | ~ctx_p.eq(ctx_p.mont_mul(ym, ym), rhs)

    # The low-S rule: s > n/2 verifies False (lib.rs:137-140).
    high_s = geq(s, half_n_plus_1)

    # u1 = z / s, u2 = r / s mod n.
    s_inv = ctx_n.mont_inv_grouped(ctx_n.to_mont(s))  # s^-1 R
    u1 = ctx_n.from_mont(ctx_n.mont_mul(ctx_n.to_mont(z), s_inv))
    u2 = ctx_n.from_mont(ctx_n.mont_mul(ctx_n.to_mont(r), s_inv))

    # R = u1 G + u2 Q: one kernel launch.
    Q = torch.stack([xm, ym, ctx_p.r_limbs.expand_as(xm)])
    R = ecdsa_mul(curve_name, u1, u2, Q, gen_table(curve_name, device))
    R = ec.point_of(R)

    inf = ec.pt_is_inf(R)
    rx, _ = ec.pt_to_affine(ctx_p, R)
    # R.x mod n: both curves have n <= p < 2n, one conditional subtract.
    rx_mod_n = _sub_once(rx, n_limbs)
    valid = ~high_s & ~inf & ctx_p.eq(rx_mod_n, r) & ~err
    return valid, err
