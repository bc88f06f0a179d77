"""Batched Grumpkin elliptic-curve gadgets on limb tensors.

Device-side replacement for the reference's barretenberg EC gadgets
(``barretenberg_blackbox_solver/src/wasm/{scalar_mul,pedersen,schnorr}.rs``):
Jacobian points over the BN254-Fr limb field
(:mod:`acvm_tpu_torch.fields.torch_ops`), complete addition, and windowed
fixed-base multiplication over host-precomputed tables.  All coordinates are
in Montgomery form; the point at infinity is encoded as Z == 0.

Two forms of a point batch:

* a triple ``(X, Y, Z)`` of (..., 8) int32 tensors, for the op-by-op group
  law (``pt_double`` / ``pt_add``: one field kernel per operation; the route of
  curves with a != 0, which take ``a_mont``);
* a *point panel* ``(N, 3, B, 8)`` int32 — point, coordinate, instance, limb —
  for the a = 0 route of the MSM tree and the variable-base ladder, which run
  the whole complete addition as ONE kernel per round or step
  (:mod:`acvm_tpu_torch.gpu.ec_fused`).  On a CUDA tensor with ``a_mont is
  None`` the tree and the ladder always take that route, at any batch size.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..blackbox.ec import grumpkin
from ..fields.kernels import LIMBS, M32, int_to_limbs32, wrap_i32
from ..fields.params import BN254_FR
from ..fields.torch_ops import LimbContext

WINDOW_BITS = 4
NUM_WINDOWS = 64  # 256 bits / 4


def _mont(value: int, params=BN254_FR) -> np.ndarray:
    """A Python int -> its Montgomery form as (8,) int32 limbs."""
    return int_to_limbs32((value * params.r) % params.modulus)


def pt_infinity(ctx: LimbContext, shape) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    zeros = torch.zeros(tuple(shape) + (LIMBS,), dtype=torch.int32, device=ctx.device)
    return zeros, zeros, zeros


def pt_is_inf(p) -> torch.Tensor:
    return (p[2] == 0).all(dim=-1)


def pt_double(ctx, p, a_mont=None):
    """Jacobian doubling: dbl-2009-l for a = 0 (grumpkin/secp256k1), or
    dbl-2007-bl with the ``a * Z^4`` term for general short-Weierstrass curves
    (secp256r1's a = -3).  ``a_mont`` is the curve coefficient in Montgomery
    limb form."""
    x, y, z = p
    if a_mont is not None:
        XX = ctx.mont_mul(x, x)
        YY = ctx.mont_mul(y, y)
        YYYY = ctx.mont_mul(YY, YY)
        ZZ = ctx.mont_mul(z, z)
        t = ctx.add(x, YY)
        t = ctx.mont_mul(t, t)
        S = ctx.sub(ctx.sub(t, XX), YYYY)
        S = ctx.add(S, S)
        M = ctx.add(ctx.add(XX, XX), XX)
        M = ctx.add(M, ctx.mont_mul(a_mont, ctx.mont_mul(ZZ, ZZ)))
        x3 = ctx.sub(ctx.mont_mul(M, M), ctx.add(S, S))
        Y8 = ctx.add(YYYY, YYYY)
        Y8 = ctx.add(Y8, Y8)
        Y8 = ctx.add(Y8, Y8)
        y3 = ctx.sub(ctx.mont_mul(M, ctx.sub(S, x3)), Y8)
        zy = ctx.add(y, z)
        zy = ctx.mont_mul(zy, zy)
        z3 = ctx.sub(ctx.sub(zy, YY), ZZ)
        return x3, y3, z3
    A = ctx.mont_mul(x, x)
    B = ctx.mont_mul(y, y)
    C = ctx.mont_mul(B, B)
    t = ctx.add(x, B)
    t = ctx.mont_mul(t, t)
    D = ctx.sub(ctx.sub(t, A), C)
    D = ctx.add(D, D)
    E = ctx.add(ctx.add(A, A), A)
    F = ctx.mont_mul(E, E)
    x3 = ctx.sub(F, ctx.add(D, D))
    C8 = ctx.add(C, C)
    C8 = ctx.add(C8, C8)
    C8 = ctx.add(C8, C8)
    y3 = ctx.sub(ctx.mont_mul(E, ctx.sub(D, x3)), C8)
    z3 = ctx.mont_mul(y, z)
    z3 = ctx.add(z3, z3)
    return x3, y3, z3


def pt_add(ctx, p, q, a_mont=None):
    """Branchless complete addition (add-2007-bl with select fallbacks), one
    field operation at a time.  ``ctx`` is a :class:`LimbContext`, or anything
    with its ``mont_mul`` / ``add`` / ``sub`` / ``is_zero`` over another
    element form (the plain version of the fused kernel passes half-limbs)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    Z1Z1 = ctx.mont_mul(z1, z1)
    Z2Z2 = ctx.mont_mul(z2, z2)
    U1 = ctx.mont_mul(x1, Z2Z2)
    U2 = ctx.mont_mul(x2, Z1Z1)
    S1 = ctx.mont_mul(ctx.mont_mul(y1, z2), Z2Z2)
    S2 = ctx.mont_mul(ctx.mont_mul(y2, z1), Z1Z1)
    H = ctx.sub(U2, U1)
    Rr = ctx.sub(S2, S1)

    I = ctx.add(H, H)
    I = ctx.mont_mul(I, I)
    J = ctx.mont_mul(H, I)
    r2 = ctx.add(Rr, Rr)
    V = ctx.mont_mul(U1, I)
    x3 = ctx.sub(ctx.sub(ctx.mont_mul(r2, r2), J), ctx.add(V, V))
    S1J = ctx.mont_mul(S1, J)
    y3 = ctx.sub(ctx.mont_mul(r2, ctx.sub(V, x3)), ctx.add(S1J, S1J))
    zz = ctx.add(z1, z2)
    zz = ctx.mont_mul(zz, zz)
    z3 = ctx.mont_mul(ctx.sub(ctx.sub(zz, Z1Z1), Z2Z2), H)

    dx, dy, dz = pt_double(ctx, p, a_mont)

    h_zero = ctx.is_zero(H)[..., None]
    r_zero = ctx.is_zero(Rr)[..., None]
    p_inf = pt_is_inf(p)[..., None]
    q_inf = pt_is_inf(q)[..., None]

    # same x: either doubling (same y) or infinity (negatives)
    dbl = h_zero & r_zero
    x3 = torch.where(dbl, dx, x3)
    y3 = torch.where(dbl, dy, y3)
    z3 = torch.where(dbl, dz, z3)
    z3 = torch.where(h_zero & ~r_zero, torch.zeros_like(z3), z3)
    # identities
    x3 = torch.where(q_inf, x1, torch.where(p_inf, x2, x3))
    y3 = torch.where(q_inf, y1, torch.where(p_inf, y2, y3))
    z3 = torch.where(q_inf, z1, torch.where(p_inf, z2, z3))
    return x3, y3, z3


def pt_to_affine(ctx: LimbContext, p):
    """Returns standard-form affine (x, y); infinity maps to (0, 0)."""
    x, y, z = p
    zinv = ctx.mont_inv_grouped(z)  # zero stays zero at infinity
    zinv2 = ctx.mont_mul(zinv, zinv)
    zinv3 = ctx.mont_mul(zinv2, zinv)
    ax = ctx.from_mont(ctx.mont_mul(x, zinv2))
    ay = ctx.from_mont(ctx.mont_mul(y, zinv3))
    inf = pt_is_inf(p)[..., None]
    zero = torch.zeros_like(ax)
    return torch.where(inf, zero, ax), torch.where(inf, zero, ay)


def panel_of(p) -> torch.Tensor:
    """A point triple of (..., B, 8) tensors -> the (..., 3, B, 8) panel."""
    return torch.stack(p, dim=-3)


def point_of(panel: torch.Tensor):
    """One point of a panel, (3, B, 8) -> the triple of (B, 8) tensors."""
    return panel[0], panel[1], panel[2]


# ---------------------------------------------------------------------------
# Windowed fixed-base multiplication
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _window_table_np(
    base_point: Tuple[int, int], windows: int = NUM_WINDOWS, native: bool = True
) -> np.ndarray:
    """(windows, 2^WINDOW_BITS, 3, 8) int32 Montgomery-form jacobian
    multiples: table[w][d] = d * 2^(4w) * base.  d = 0 is the infinity entry
    (all zeros).  A truncated table (windows < NUM_WINDOWS) supports scalars
    < 2^(4*windows) only — tests use short tables to keep the host precompute
    down.  The additions run in the host Grumpkin library
    (:mod:`acvm_tpu_torch.native`), as the JAX package's do; ``native=False``
    runs them in the pure-Python curve code, the plain version."""
    if native:
        from .. import native as lib

        add = lib.grumpkin_add
    else:
        add = grumpkin.add
    one = _mont(1)
    table = np.zeros((windows, 1 << WINDOW_BITS, 3, LIMBS), dtype=np.int32)
    window_base = base_point
    for w in range(windows):
        acc = None
        for d in range(1, 1 << WINDOW_BITS):
            acc = add(acc, window_base)
            if acc is not None:
                table[w, d, 0] = _mont(acc[0])
                table[w, d, 1] = _mont(acc[1])
                table[w, d, 2] = one
        # next window base: 2^4 * current
        for _ in range(WINDOW_BITS):
            window_base = add(window_base, window_base)
    table.setflags(write=False)
    return table


def window_table(
    base_point: Tuple[int, int], windows: int = NUM_WINDOWS, device="cuda", native: bool = True
) -> torch.Tensor:
    return torch.from_numpy(_window_table_np(tuple(base_point), windows, native).copy()).to(device)


def _window_digits(scalar_limbs: torch.Tensor) -> torch.Tensor:
    """(.., 8) standard-form scalar -> (.., NUM_WINDOWS) 4-bit digits (int64)."""
    u = scalar_limbs.to(torch.int64) & M32
    # Each 32-bit limb holds 8 windows.
    parts = [
        (u >> (WINDOW_BITS * k)) & ((1 << WINDOW_BITS) - 1)
        for k in range(32 // WINDOW_BITS)
    ]
    stacked = torch.stack(parts, dim=-1)  # (.., 8, 8)
    return stacked.reshape(scalar_limbs.shape[:-1] + (NUM_WINDOWS,))


def _tree_reduce_points(ctx: LimbContext, P: torch.Tensor, a_mont=None):
    """Pairwise tree reduction of a (N, 3, B, 8) point panel over its N axis
    -> the (X, Y, Z) triple of (B, 8) tensors.  Rounds add even/odd pairs and
    halve the panel; an odd panel's last point meets infinity.  The pairing,
    and so every Jacobian coordinate, is that of the reference's tree."""
    if a_mont is None:
        from .ec_fused import tree_reduce_fused

        return tree_reduce_fused(ctx, P)
    N = P.shape[0]
    while N > 1:
        if N % 2:
            P = torch.cat([P, torch.zeros_like(P[:1])], dim=0)
            N += 1
        even, odd = P[0::2], P[1::2]
        P = torch.stack(
            pt_add(ctx, (even[:, 0], even[:, 1], even[:, 2]),
                   (odd[:, 0], odd[:, 1], odd[:, 2]), a_mont),
            dim=1,
        )
        N //= 2
    return point_of(P[0])


def _gather_window_entries(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """table (W, 16, 3, 8) + digits (W, B) -> the entry panel (W, 3, B, 8), a
    view of the gathered (W, B, 3, 8) rows (the addition kernel reads it where
    it lies)."""
    num_windows, B = digits.shape
    flat = table.reshape(num_windows * (1 << WINDOW_BITS), 3, LIMBS)
    idx = (
        torch.arange(num_windows, dtype=torch.int64, device=digits.device)[:, None]
        * (1 << WINDOW_BITS)
        + digits
    )
    entries = flat.index_select(0, idx.reshape(-1))
    return entries.reshape(num_windows, B, 3, LIMBS).permute(0, 2, 1, 3)


def fixed_base_mul(ctx: LimbContext, table: torch.Tensor, scalar_limbs: torch.Tensor, a_mont=None):
    """scalar * base via the precomputed window table.

    scalar_limbs: (B, 8) standard form (the scalar's integer bits).  Returns a
    Montgomery jacobian point batch.  The per-window table entries are gathered
    in one shot and summed by pairwise tree reduction: log2(W) wide rounds.
    A truncated table (fewer than NUM_WINDOWS windows) restricts the scalar
    range to 2^(4*windows); callers guarantee the bound.
    """
    num_windows = table.shape[0]
    digits = _window_digits(scalar_limbs)[..., :num_windows]  # (B, W)
    entries = _gather_window_entries(table, digits.T)  # (W, 3, B, 8)
    return _tree_reduce_points(ctx, entries, a_mont)


def msm_fixed_tables(ctx: LimbContext, tables: torch.Tensor, scalars: torch.Tensor, a_mont=None):
    """Multi-scalar multiplication over fixed bases: sum_i scalars[i] *
    base_i, with base_i's window table tables[i] (n, W, 16, 3, 8).

    All n * W window entries join ONE tree reduction, generator-major — a
    Pedersen commitment over n generators is log2(n * W) wide rounds in total
    (reference semantics: barretenberg pedersen_plookup_commit,
    wasm/pedersen.rs:13-36).  scalars: (n, B, 8) standard form, one row a
    generator (the witness-major order of the solver's panel).  Returns a
    jacobian point batch.
    """
    n_gen, num_windows = tables.shape[0], tables.shape[1]
    B = scalars.shape[1]
    digits = _window_digits(scalars)[..., :num_windows]  # (n, B, W)
    flat = tables.reshape(n_gen * num_windows, 1 << WINDOW_BITS, 3, LIMBS)
    entries = _gather_window_entries(
        flat, digits.permute(0, 2, 1).reshape(n_gen * num_windows, B)
    )
    return _tree_reduce_points(ctx, entries, a_mont)


def pedersen_msm_sharded(ctx: LimbContext, tables: torch.Tensor, scalars: torch.Tensor, mesh,
                         axis_name: str = "data"):
    """:func:`msm_fixed_tables` with the generator axis split over a mesh's
    entries (:mod:`acvm_tpu_torch.parallel`): entry i computes the windowed
    partial sum of its contiguous slice of generators on its own device, the
    partial points go to the first entry (or, under a mesh of ranks, are
    all-gathered: every rank gets every partial), and are reduced there in
    entry order with :func:`pt_add`, from infinity.  Point addition is not
    componentwise, so the partials are gathered whole, as the JAX package's
    ``tpu/ec.py::pedersen_msm_sharded`` all-gathers them.

    tables: (n_gen, W, 16, 3, 8); scalars: (n_gen, B, 8) standard form, a row
    a generator (the port's generator-major layout; the JAX function takes
    (B, n_gen, L)).  Any n_gen: an entry may get no generator.  Returns the
    affine (x, y) standard-form (B, 8) tensors on ``ctx``'s device."""
    from ..parallel.mesh import on_device, shard_bounds

    if axis_name not in mesh.axis_names:
        raise ValueError(f"pedersen_msm_sharded: the mesh has no axis {axis_name!r}")
    n_gen, B = tables.shape[0], scalars.shape[1]
    bounds = shard_bounds(n_gen, mesh.size)

    def partial(i):
        lo, hi = bounds[i]
        d = mesh.devices[i]
        if hi == lo:
            return torch.zeros((3, B, LIMBS), dtype=torch.int32, device=d)
        with on_device(d):
            ctx_d = ctx if d == ctx.device else LimbContext(ctx.params, d)
            return panel_of(msm_fixed_tables(ctx_d, tables[lo:hi].to(d), scalars[lo:hi].to(d)))

    if mesh.distributed:
        import torch.distributed as dist
        from ..parallel.distributed import all_gather_batch

        (entry,) = mesh.local_entries(dist.get_rank())
        local = partial(entry)[None]  # (1, 3, B, 8)
        parts = all_gather_batch(local, [(i, i + 1) for i in range(mesh.size)]).to(ctx.device)
    else:
        parts = torch.stack([partial(i).to(ctx.device) for i in range(mesh.size)])
    total = pt_infinity(ctx, (B,))
    for part in parts:
        total = pt_add(ctx, total, point_of(part))
    return pt_to_affine(ctx, total)


def scalar_bits(scalar_limbs: torch.Tensor) -> torch.Tensor:
    """(B, 8) standard-form scalars -> (256, B) bool, bit i of each."""
    u = scalar_limbs.to(torch.int64) & M32
    shifts = torch.arange(32, dtype=torch.int64, device=u.device)
    bits = ((u[:, :, None] >> shifts) & 1).reshape(u.shape[0], LIMBS * 32)
    return bits.T.to(torch.bool)


def scalar_mul(ctx: LimbContext, point, scalar_limbs: torch.Tensor, a_mont=None):
    """Generic double-and-add for variable bases (MSB-first)."""
    if a_mont is None:
        from .ec_fused import scalar_mul_fused

        return scalar_mul_fused(ctx, point, scalar_limbs)
    acc = pt_infinity(ctx, scalar_limbs.shape[:-1])
    bits = scalar_bits(scalar_limbs)
    for i in range(LIMBS * 32 - 1, -1, -1):
        acc = pt_double(ctx, acc, a_mont)
        added = pt_add(ctx, acc, point, a_mont)
        sel = bits[i][:, None]
        acc = tuple(torch.where(sel, a, b) for a, b in zip(added, acc))
    return acc


# ---------------------------------------------------------------------------
# Schnorr verification pipeline (device)
# ---------------------------------------------------------------------------


def bytes_be_to_limbs(bytes_be: torch.Tensor) -> torch.Tensor:
    """(B, 32) big-endian bytes -> (B, 8) little-endian 32-bit limbs."""
    b = bytes_be.to(torch.int64).flip(-1).reshape(bytes_be.shape[0], LIMBS, 4)
    return wrap_i32(b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24))


def limbs_to_bytes_be(limbs: torch.Tensor) -> torch.Tensor:
    """(B, 8) limbs -> (B, 32) big-endian bytes (int64)."""
    u = limbs.to(torch.int64) & M32
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=u.device)
    return ((u[..., None] >> shifts) & 0xFF).reshape(limbs.shape[0], 32).flip(-1)


def mod_order(limbs: torch.Tensor, order: int) -> torch.Tensor:
    """Reduce a full 256-bit value modulo the grumpkin group order via
    conditional subtraction (2^256 < 8*order, so shifts 2,1,0 suffice)."""
    from . import intops

    r = limbs
    for k in (2, 1, 0):
        if (order << k) >> 256:
            # shifted modulus overflows 256 bits; r < 2^256 is always smaller
            continue
        nk = torch.from_numpy(int_to_limbs32(order << k).copy()).to(limbs.device)
        ge = intops.int_geq(r, nk)
        r = torch.where(ge[..., None], intops.int_sub(r, nk), r)
    return r


def schnorr_verify_batched(
    ctx: LimbContext,
    pub_x: torch.Tensor,  # (B, 8) standard form
    pub_y: torch.Tensor,
    sig_bytes: torch.Tensor,  # (B, 64) bytes, s || e big-endian
    msg_bytes: torch.Tensor,  # (B, M) bytes
    pedersen_tables: torch.Tensor,  # (3, W, 16, 3, 8): generators 0..2, domain 0
    generator_table: torch.Tensor,  # window table of the group generator
) -> torch.Tensor:
    """Batched analogue of blackbox/grumpkin.py::schnorr_verify -> (B,) bool."""
    from .gadgets import blake2s_digest
    from . import intops

    n_order = grumpkin.params.n

    s = mod_order(bytes_be_to_limbs(sig_bytes[:, :32]), n_order)
    e = mod_order(bytes_be_to_limbs(sig_bytes[:, 32:]), n_order)

    # public key on curve: y^2 == x^3 - 17
    xm = ctx.to_mont(pub_x)
    ym = ctx.to_mont(pub_y)
    y2 = ctx.mont_mul(ym, ym)
    x3 = ctx.mont_mul(ctx.mont_mul(xm, xm), xm)
    seventeen = torch.from_numpy(_mont(17, ctx.params).copy()).to(pub_x.device)
    on_curve = ctx.eq(y2, ctx.sub(x3, seventeen))

    s_nonzero = ~intops.is_zero(s)

    # R = s*G + e*P
    sG = fixed_base_mul(ctx, generator_table, s)
    P = (xm, ym, ctx.r_limbs.expand_as(xm))
    eP = scalar_mul(ctx, P, e)
    R = _tree_reduce_points(ctx, torch.stack([panel_of(sG), panel_of(eP)]))
    r_not_inf = ~pt_is_inf(R)
    rx, _ = pt_to_affine(ctx, R)

    # challenge: blake2s(pedersen_compress(Rx, Px, Py).x_be || msg) mod n; the
    # digest is one `blake2s` launch on the card
    acc = msm_fixed_tables(ctx, pedersen_tables, torch.stack([rx, pub_x, pub_y]))
    cx, _ = pt_to_affine(ctx, acc)

    digest = blake2s_digest(
        torch.cat([limbs_to_bytes_be(cx), msg_bytes.to(torch.int64)], dim=1)
    )
    challenge = mod_order(bytes_be_to_limbs(digest), n_order)

    return on_curve & s_nonzero & r_not_inf & ctx.eq(challenge, e)
