"""The fused complete-addition kernel and what runs on it (the MSM tree), and
the variable-base ladder, a kernel of its own over the same group law.

Replaces ``acvm_tpu/tpu/ec_pallas.py``.  The op-by-op group law
(:func:`acvm_tpu_torch.gpu.ec.pt_add`) issues 23 separate Montgomery
multiplies and as many adds and subtracts per complete addition, each a kernel
launch with its own trip through device memory.  ``csrc/pt_add.cu`` runs the
whole formula in one kernel, a thread a (pair, instance), with every
intermediate in registers: one read per operand point, one write per result.
a = 0 curves only (Grumpkin).

Layout: a point panel is ``(N, 3, B, 8)`` int32 — point, coordinate (X, Y, Z
in Montgomery form, Z == 0 encoding infinity), instance, limb.  The kernel
takes each operand as a strided view, so the even/odd halves of one panel (a
tree round), two separate panels (a ladder step) and a panel gathered as
``(N, B, 3, 8)`` are all read where they lie.

``pt_add_panels`` is the wrapper: a CUDA panel launches the kernel or raises,
a CPU panel runs ``pt_add_panels_plain`` beside it.  ``scalar_mul_fused`` is
the ladder's: ``csrc/pt_ladder.cu`` runs all 256 steps in one launch with the
accumulator in registers, where the reference's scan calls the addition kernel
twice a step; ``scalar_mul_fused_plain`` is that scan.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..fields import kernels as fk
from ..fields.kernels import LIMBS
from ..fields.params import FieldParams, BN254_FR
from . import ec


# ---------------------------------------------------------------------------
# The plain version: the group law of ec.pt_add over int64 half-limbs
# ---------------------------------------------------------------------------


def pt_add_panels_plain(
    P: torch.Tensor, Q: torch.Tensor, params: FieldParams = BN254_FR
) -> torch.Tensor:
    """Plain version of :func:`pt_add_panels`: out[c] = P[c] + Q[c], the
    reference's branchless formula (both branches computed, then selected)."""
    hp, hq = fk.split_half(P), fk.split_half(Q)  # (M, 3, B, 16)
    out = ec.pt_add(
        fk.half_field(params, P.device),
        (hp[:, 0], hp[:, 1], hp[:, 2]),
        (hq[:, 0], hq[:, 1], hq[:, 2]),
    )
    return fk.join_half(torch.stack(out, dim=1))


def pt_add_pairs_plain(P: torch.Tensor, params: FieldParams = BN254_FR) -> torch.Tensor:
    """Plain version of :func:`pt_add_pairs`."""
    return pt_add_panels_plain(P[0::2], P[1::2], params)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def _check_panel(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 4 or t.shape[1] != 3 or t.shape[3] != LIMBS:
        raise TypeError(
            f"{name}: expected a (N, 3, B, {LIMBS}) int32 point panel, got "
            f"{tuple(t.shape)} {t.dtype}"
        )


def _view_args(t: torch.Tensor, name: str):
    """(pointer, point stride, coordinate stride, instance stride) of a panel
    view the kernel can read: limbs contiguous, every element 16-byte aligned."""
    sp, sc, sb, sl = t.stride()
    if t.shape[0] == 1:
        sp = 0  # a single point: its stride is never used
    if sl != 1 or any(s % 4 for s in (sp, sc, sb)) or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: limbs must be contiguous and strides multiples of 4 "
            f"words, got strides {t.stride()}"
        )
    return t.data_ptr(), sp, sc, sb


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() == b.data_ptr() and a.stride() == b.stride()


def pt_add_panels(
    P: torch.Tensor, Q: torch.Tensor, params: FieldParams = BN254_FR,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Complete Jacobian addition, a = 0 curves: out[c] = P[c] + Q[c] for two
    (M, 3, B, 8) point panels (strided views allowed) -> (M, 3, B, 8).  Every
    coordinate is bit-identical to :func:`ec.pt_add`.

    ``out`` may be a fresh panel, or exactly ``P`` or exactly ``Q`` (the same
    view): a thread reads its two points before it writes.  Any other overlap
    with an operand is refused."""
    fk.require_narrow(params, "pt_add_panels")
    _check_panel(P, "pt_add_panels P")
    _check_panel(Q, "pt_add_panels Q")
    if P.shape != Q.shape or P.device != Q.device:
        raise ValueError(f"pt_add_panels: operands differ: {tuple(P.shape)} {tuple(Q.shape)}")
    if not P.is_cuda:
        res = pt_add_panels_plain(P, Q, params)
        if out is not None:
            out.copy_(res)
            return out
        return res
    M, _, B, _ = P.shape
    if out is None:
        out = torch.empty((M, 3, B, LIMBS), dtype=torch.int32, device=P.device)
    else:
        _check_panel(out, "pt_add_panels out")
        if out.shape != P.shape or out.device != P.device:
            raise ValueError("pt_add_panels: out must have the operands' shape and device")
        for name, operand in (("P", P), ("Q", Q)):
            shares = out.untyped_storage().data_ptr() == operand.untyped_storage().data_ptr()
            if shares and not _same_view(out, operand):
                raise ValueError(
                    f"pt_add_panels: out overlaps {name} without being the same view"
                )
    if M and B:
        build.launch(
            "pt_add", *_view_args(P, "pt_add_panels P"), *_view_args(Q, "pt_add_panels Q"),
            *_view_args(out, "pt_add_panels out"), M, B,
            fk._host_ptr(fk.field_words(params)), fk._stream(P),
        )
    return out


def pt_add_pairs(P: torch.Tensor, params: FieldParams = BN254_FR) -> torch.Tensor:
    """(N, 3, B, 8) point panel, N even -> (N/2, 3, B, 8) with
    out[c] = P[2c] + P[2c+1]: the even and odd halves go to the kernel as two
    strided views of the one panel."""
    if P.shape[0] % 2:
        raise ValueError("pt_add_pairs: an odd number of points")
    return pt_add_panels(P[0::2], P[1::2], params)


# ---------------------------------------------------------------------------
# The tree and the ladder
# ---------------------------------------------------------------------------


def tree_reduce_fused(ctx, P: torch.Tensor):
    """Pairwise tree reduction of a (N, 3, B, 8) point panel -> the (X, Y, Z)
    triple of (B, 8) tensors.  Rounds shrink the panel (N -> ceil(N/2)), so
    only the active pairs are ever computed.  The last point of an odd panel
    meets infinity, which returns its coordinates unchanged: it is copied."""
    _check_panel(P, "tree_reduce_fused P")
    N = P.shape[0]
    while N > 1:
        half = N // 2
        if N % 2:
            nxt = torch.empty(
                (half + 1, 3, P.shape[2], LIMBS), dtype=torch.int32, device=P.device
            )
            pt_add_panels(P[0 : N - 1 : 2], P[1:N:2], ctx.params, out=nxt[:half])
            nxt[half].copy_(P[N - 1])
            P, N = nxt, half + 1
        else:
            P, N = pt_add_pairs(P, ctx.params), half
    return ec.point_of(P[0])


# The ladder kernel's geometry (csrc/pt_ladder.cu): a team of four threads an
# instance, eight teams a one-warp block.
LADDER_TEAM_THREADS = 4
LADDER_TEAMS = 8


def ladder_geometry(B: int):
    """(blocks, threads a block, masked teams) of one ``pt_ladder`` launch over
    B instances: instance b is team b % 8 of block b // 8, threads 4 (b % 8)
    to 4 (b % 8) + 3; the last block's teams past B are masked."""
    blocks = -(-B // LADDER_TEAMS)
    return blocks, LADDER_TEAMS * LADDER_TEAM_THREADS, blocks * LADDER_TEAMS - B


def scalar_mul_fused_plain(ctx, point, scalar_limbs: torch.Tensor):
    """Plain version of :func:`scalar_mul_fused`: the 256 steps of the
    reference ladder, MSB-first, each ``acc + acc`` (the complete addition's
    equal-points branch), ``+ base`` and a select, through
    :func:`pt_add_panels`."""
    B = scalar_limbs.shape[0]
    base = ec.panel_of(point)[None]  # (1, 3, B, 8)
    acc = torch.zeros((1, 3, B, LIMBS), dtype=torch.int32, device=scalar_limbs.device)
    added = torch.empty_like(acc)
    bits = ec.scalar_bits(scalar_limbs)[:, None, None, :, None]  # (256, 1, 1, B, 1)
    for i in range(LIMBS * 32 - 1, -1, -1):
        pt_add_panels(acc, acc, ctx.params, out=acc)
        pt_add_panels(acc, base, ctx.params, out=added)
        acc = torch.where(bits[i], added, acc)
    return ec.point_of(acc[0])


def scalar_mul_fused(ctx, point, scalar_limbs: torch.Tensor):
    """Variable-base double-and-add ladder, a = 0 curves.

    ``point``: (x, y, z) Montgomery Jacobian (B, 8) tensors; ``scalar_limbs``
    (B, 8) standard form, all 256 bits used as they come.  MSB-first, the group-law semantics of ``ec.scalar_mul``.  On
    CUDA tensors the whole ladder is ONE launch of ``csrc/pt_ladder.cu`` (four
    threads an instance, a step's products in rounds over shared memory:
    :func:`ladder_geometry`); on CPU tensors
    :func:`scalar_mul_fused_plain` runs.  X, Y and Z are the same limbs either
    way."""
    fk.require_narrow(ctx.params, "scalar_mul_fused")
    if scalar_limbs.dtype != torch.int32 or scalar_limbs.dim() != 2 or scalar_limbs.shape[1] != LIMBS:
        raise TypeError(
            f"scalar_mul_fused: scalars must be (B, {LIMBS}) int32, got "
            f"{tuple(scalar_limbs.shape)} {scalar_limbs.dtype}"
        )
    if not scalar_limbs.is_cuda:
        return scalar_mul_fused_plain(ctx, point, scalar_limbs)
    B = scalar_limbs.shape[0]
    base = ec.panel_of(point)[None]  # (1, 3, B, 8)
    _check_panel(base, "scalar_mul_fused base")
    if base.shape[2] != B or base.device != scalar_limbs.device:
        raise ValueError("scalar_mul_fused: base and scalars differ in batch or device")
    scalars = scalar_limbs.contiguous()
    out = torch.empty((3, B, LIMBS), dtype=torch.int32, device=scalars.device)
    if B:
        base_ptr, _, b_coord, b_inst = _view_args(base, "scalar_mul_fused base")
        build.launch(
            "pt_ladder", base_ptr, b_coord, b_inst, scalars.data_ptr(),
            out.data_ptr(), B * LIMBS, LIMBS, B,
            fk._host_ptr(fk.field_words(ctx.params)), fk._stream(out),
        )
    return ec.point_of(out)
