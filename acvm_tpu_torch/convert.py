"""State carried between the JAX package and this one, as numpy arrays.

The JAX package holds a field element as 16 x 16-bit limbs in uint32 and its
witness panel either batch-major ``(B, NW, 16)`` or witness-major
``(NW, 16, S, 128)`` with ``B = S * 128``; its panels may carry one scratch
column past the real witnesses.  Its elliptic-curve points are three
``(B, N, 16)`` coordinate arrays, its window tables ``(W, 16, 3, 16)`` and its
memory blocks ``(B, size, 16)``; here a point panel is ``(N, 3, B, 8)``, a
table ``(W, 16, 3, 8)`` and a memory block ``(size, B, 8)``.  This package
holds 8 x 32-bit limbs as int32 (uint32 bit patterns) and one witness-major
panel ``(NW, B, 8)``.  The values are the same numbers either way (Montgomery
radix 2^256 on both sides), so every function here is a pure relayout;
nothing is rescaled.  That holds for any value below 2^256: the wide fields'
elements (the secp256k1 / secp256r1 base fields and group orders, p > 2^255)
and the ECDSA generator tables (``(64, 16, 3, 16)`` there, ``(64, 16, 3, 8)``
here: ``window_table_from_jax``) carry over as the narrow ones do.

All functions take and return numpy arrays: hand the result to
``torch.from_numpy`` or ``jnp.asarray`` as needed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

L16 = 16  # limbs of the JAX package
L32 = 8  # limbs of this package


# ---------------------------------------------------------------------------
# limb arrays
# ---------------------------------------------------------------------------


def limbs16_to_limbs32(a) -> np.ndarray:
    """(..., 16) 16-bit limbs (any integer dtype) -> (..., 8) int32."""
    a = np.asarray(a).astype(np.uint32)
    if a.shape[-1] != L16:
        raise ValueError(f"expected a trailing axis of {L16} limbs, got {a.shape}")
    return (a[..., 0::2] | (a[..., 1::2] << np.uint32(16))).view(np.int32)


def limbs32_to_limbs16(a) -> np.ndarray:
    """(..., 8) int32/uint32 limbs -> (..., 16) uint32 holding 16-bit limbs."""
    a = np.ascontiguousarray(np.asarray(a)).view(np.uint32)
    if a.shape[-1] != L32:
        raise ValueError(f"expected a trailing axis of {L32} limbs, got {a.shape}")
    out = np.empty(a.shape[:-1] + (L16,), dtype=np.uint32)
    out[..., 0::2] = a & np.uint32(0xFFFF)
    out[..., 1::2] = a >> np.uint32(16)
    return out


# ---------------------------------------------------------------------------
# witness panels
# ---------------------------------------------------------------------------


def panel_from_jax(W, num_witnesses: Optional[int] = None) -> np.ndarray:
    """A JAX-package witness panel in either layout -> (NW, B, 8) int32.

    ``num_witnesses`` drops the columns past it (the JAX panel's scratch
    column)."""
    W = np.asarray(W)
    if W.ndim == 4:  # (NW, 16, S, 128) witness-major rows
        NW, _, S, lanes = W.shape
        rows = W.reshape(NW, L16, S * lanes).transpose(0, 2, 1)  # (NW, B, 16)
    elif W.ndim == 3:  # (B, NW, 16) batch-major
        rows = W.transpose(1, 0, 2)
    else:
        raise ValueError(f"not a witness panel: shape {W.shape}")
    if num_witnesses is not None:
        rows = rows[:num_witnesses]
    return np.ascontiguousarray(limbs16_to_limbs32(rows))


def panel_to_jax(
    W, layout: str = "batch", num_witnesses: Optional[int] = None
) -> np.ndarray:
    """(NW, B, 8) panel -> the JAX package's ``"batch"`` ``(B, NW', 16)`` or
    ``"rows"`` ``(NW', 16, S, 128)`` uint32 layout.  ``num_witnesses`` pads
    zero columns up to NW' (e.g. ``plan.num_witnesses + 1`` for the scratch
    column the JAX solver expects)."""
    rows = limbs32_to_limbs16(W)  # (NW, B, 16)
    NW, B, _ = rows.shape
    if num_witnesses is not None and num_witnesses > NW:
        rows = np.concatenate(
            [rows, np.zeros((num_witnesses - NW, B, L16), np.uint32)], axis=0
        )
        NW = num_witnesses
    if layout == "batch":
        return np.ascontiguousarray(rows.transpose(1, 0, 2))
    if layout == "rows":
        if B % 128:
            raise ValueError("the rows layout needs a batch that is a multiple of 128")
        return np.ascontiguousarray(
            rows.transpose(0, 2, 1).reshape(NW, L16, B // 128, 128)
        )
    raise ValueError(f"unknown layout {layout!r}")


def memory_from_jax(mem) -> Dict[int, np.ndarray]:
    """The JAX package's memory blocks ``{str(block_id): (B, size, 16)}`` ->
    ``{block_id: (size, B, 8) int32}``, this package's slab a block."""
    return {int(k): np.ascontiguousarray(limbs16_to_limbs32(np.asarray(v)).transpose(1, 0, 2))
            for k, v in mem.items()}


def memory_to_jax(mem) -> Dict[str, np.ndarray]:
    """``{block_id: (size, B, 8)}`` -> the JAX package's ``{str(block_id):
    (B, size, 16) uint32}``."""
    return {str(k): np.ascontiguousarray(limbs32_to_limbs16(np.asarray(v)).transpose(1, 0, 2))
            for k, v in mem.items()}


# ---------------------------------------------------------------------------
# point panels and window tables
# ---------------------------------------------------------------------------


def points_from_jax(X, Y, Z) -> np.ndarray:
    """A JAX-package Jacobian point panel, three ``(B, N, 16)`` coordinate
    arrays (or ``(B, 16)`` for one point a lane) -> this package's point
    panel ``(N, 3, B, 8)`` int32."""
    coords = np.stack([np.asarray(c) for c in (X, Y, Z)], axis=0)  # (3, B, [N,] 16)
    if coords.ndim == 3:
        coords = coords[:, :, None, :]
    return np.ascontiguousarray(limbs16_to_limbs32(coords.transpose(2, 0, 1, 3)))


def points_to_jax(P):
    """This package's point panel ``(N, 3, B, 8)`` -> the JAX package's three
    ``(B, N, 16)`` uint32 coordinate arrays."""
    rows = limbs32_to_limbs16(P).transpose(1, 2, 0, 3)  # (3, B, N, 16)
    return tuple(np.ascontiguousarray(rows[i]) for i in range(3))


def window_table_from_jax(table) -> np.ndarray:
    """A JAX-package window table ``(W, 16, 3, 16)`` (16-bit limbs) -> this
    package's ``(W, 16, 3, 8)`` int32."""
    return np.ascontiguousarray(limbs16_to_limbs32(table))


def window_table_to_jax(table) -> np.ndarray:
    return limbs32_to_limbs16(table)


# ---------------------------------------------------------------------------
# expression packs and level descriptors
# ---------------------------------------------------------------------------

_COEFF_KEYS = ("lin_coeff", "mul_coeff", "qc")


def pack_from_jax(pack: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A JAX ``pack_exprs`` buffer (16-bit coefficient limbs) -> this
    package's (8 x 32-bit int32 limbs); index arrays pass through."""
    return {
        k: limbs16_to_limbs32(v) if k in _COEFF_KEYS else np.asarray(v)
        for k, v in pack.items()
    }


def pack_to_jax(pack: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {
        k: limbs32_to_limbs16(v) if k in _COEFF_KEYS else np.asarray(v)
        for k, v in pack.items()
    }


def _desc_split(t1: int, t2: int, limbs: int):
    n_idx = t1 + 2 * t2 + 1
    return n_idx, n_idx + limbs * (t1 + t2 + 1)


def level_desc_from_jax(desc, t1: int, t2: int) -> np.ndarray:
    """The JAX level descriptor ``(DW16, E)`` (gate axis minor, 16-bit
    coefficient limbs) -> this package's ``(E, DW8)`` int32, one row a gate."""
    d = np.asarray(desc).T  # (E, DW16)
    n_idx, dw = _desc_split(t1, t2, L16)
    if d.shape[1] != dw:
        raise ValueError(f"descriptor width {d.shape[1]} != {dw} for t1={t1}, t2={t2}")
    E = d.shape[0]
    coeff = limbs16_to_limbs32(d[:, n_idx:].reshape(E, t1 + t2 + 1, L16))
    return np.ascontiguousarray(
        np.concatenate([d[:, :n_idx].astype(np.int32), coeff.reshape(E, -1)], axis=1)
    )


def level_desc_to_jax(desc, t1: int, t2: int) -> np.ndarray:
    """This package's ``(E, DW8)`` descriptor -> the JAX ``(DW16, E)`` int32."""
    d = np.asarray(desc)
    n_idx, dw = _desc_split(t1, t2, L32)
    if d.shape[1] != dw:
        raise ValueError(f"descriptor width {d.shape[1]} != {dw} for t1={t1}, t2={t2}")
    E = d.shape[0]
    coeff = limbs32_to_limbs16(
        np.ascontiguousarray(d[:, n_idx:]).reshape(E, t1 + t2 + 1, L32)
    ).astype(np.int32)
    return np.ascontiguousarray(
        np.concatenate([d[:, :n_idx], coeff.reshape(E, -1)], axis=1).T
    )
