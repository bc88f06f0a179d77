"""Fused arith-static level: gather -> Montgomery chain -> scatter, one launch.

The witness panel is stored *witness-major*,

    W : (NW, B, 8) int32,

so one witness's batch column is a contiguous (B, 8) block: a warp of
instances reads and writes contiguous memory whichever row its gate names.
A level is one in-place program over that panel:

    W[out_idx[g], b] = qc[g] + sum_t lc[g, t] * W[lin_idx[g, t], b]
                     + sum_k mc[g, k] * (W[m1[g, k], b] * W[m2[g, k], b])

with the constant divisor of the arithmetic gate (-1/den) folded into the
packed coefficients at plan time.  Levelization guarantees a level's reads
never overlap its writes (the planner solves each witness exactly once, before
any use), which is what makes the in-place update safe in any gate order.

This replaces ``tpu/fused_level.py::_make_level_kernel`` of the JAX package.
On an H100 one (gate, instance) moves 32 bytes per operand and 32 bytes out
against 136 32-bit multiply-adds per product; at the usual 2-3 terms the two
bounds are close, and the kernel keeps every intermediate in registers so the
panel rows are the only device-memory traffic.

Reference semantics: the arithmetic-gate solve of acvm/src/pwg/
arithmetic.rs:27-127 (single unknown, constant divisor), batched over instances.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import build
from ..fields import kernels as fk
from ..fields.kernels import HALF, LIMBS
from ..fields.params import FieldParams, BN254_FR

L = LIMBS


def desc_width(t1: int, t2: int) -> int:
    """int32 words per gate: [lin_idx t1 | mul_idx 2*t2 | out_idx |
    lin_coeff t1*8 | mul_coeff t2*8 | qc 8]."""
    return t1 + 2 * t2 + 1 + L * (t1 + t2 + 1)


def pack_level_desc(buf: dict) -> np.ndarray:
    """Pack one arith_static level buffer (``num`` expression pack with 8-limb
    coefficients + ``u_idx``) into the (E, DW) int32 descriptor table the level
    call reads, one row per gate."""
    num = buf["num"]
    u_idx = buf["u_idx"]
    E = u_idx.shape[0]
    t1 = num["lin_idx"].shape[1]
    t2 = num["mul_idx"].shape[1]
    desc = np.zeros((E, desc_width(t1, t2)), dtype=np.int32)
    o = 0
    desc[:, o : o + t1] = num["lin_idx"]
    o += t1
    desc[:, o : o + 2 * t2] = num["mul_idx"].reshape(E, 2 * t2)
    o += 2 * t2
    desc[:, o] = u_idx
    o += 1
    desc[:, o : o + t1 * L] = num["lin_coeff"].reshape(E, t1 * L)
    o += t1 * L
    desc[:, o : o + t2 * L] = num["mul_coeff"].reshape(E, t2 * L)
    o += t2 * L
    desc[:, o : o + L] = num["qc"]
    return desc


def _offsets(t1: int, t2: int):
    off_mul = t1
    off_out = t1 + 2 * t2
    off_lc = off_out + 1
    off_mc = off_lc + t1 * L
    off_qc = off_mc + t2 * L
    return off_mul, off_out, off_lc, off_mc, off_qc


def fused_level_plain(
    W: torch.Tensor,
    desc: torch.Tensor,
    params: FieldParams = BN254_FR,
    t1: int = 0,
    t2: int = 0,
    gate_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of :func:`fused_level_call`: gather, evaluate op by op,
    scatter — same descriptor, same results, in place on ``W``.  ``gate_chunk``
    bounds the gathered operands' memory; chunking is exact because a level's
    reads never alias its writes."""
    E, dw = desc.shape
    if dw != desc_width(t1, t2):
        raise ValueError(f"descriptor width {dw} != {desc_width(t1, t2)} for t1={t1}, t2={t2}")
    B = W.shape[1]
    off_mul, off_out, off_lc, off_mc, off_qc = _offsets(t1, t2)
    hf = fk.half_field(params, W.device)
    step = gate_chunk or max(E, 1)
    for lo in range(0, E, step):
        d = desc[lo : lo + step]
        idx = d.to(torch.int64)

        def rows_of(col):  # -> (e, B, 16) half-limbs
            return fk.split_half(W.index_select(0, idx[:, col]))

        def coeff_of(off, t):  # -> (e, 1, 16)
            return fk.split_half(d[:, off + t * L : off + (t + 1) * L])[:, None, :]

        acc = coeff_of(off_qc, 0).expand(d.shape[0], B, HALF)
        for t in range(t1):
            acc = hf.add(acc, hf.mont_mul(coeff_of(off_lc, t), rows_of(t)))
        for t in range(t2):
            prod = hf.mont_mul(rows_of(off_mul + 2 * t), rows_of(off_mul + 2 * t + 1))
            acc = hf.add(acc, hf.mont_mul(coeff_of(off_mc, t), prod))
        W.index_copy_(0, idx[:, off_out], fk.join_half(acc))
    return W


def fused_level_call(
    W: torch.Tensor,
    desc: torch.Tensor,
    params: FieldParams = BN254_FR,
    t1: int = 0,
    t2: int = 0,
) -> torch.Tensor:
    """Solve one arith-static level in place on the witness-major panel.

    W: (NW, B, 8) int32, contiguous; desc: (E, DW) int32 on the same device
    (see :func:`pack_level_desc`).  Returns ``W`` (updated in place).  A CUDA
    panel launches the level kernel; a CPU panel runs the plain version."""
    fk.require_narrow(params, "fused_level_call")
    if W.dtype != torch.int32 or W.dim() != 3 or W.shape[2] != L:
        raise TypeError(f"fused_level_call: panel must be (NW, B, 8) int32, got {tuple(W.shape)} {W.dtype}")
    if desc.dtype != torch.int32 or desc.dim() != 2 or desc.shape[1] != desc_width(t1, t2):
        raise TypeError(
            f"fused_level_call: descriptor must be (E, {desc_width(t1, t2)}) int32, "
            f"got {tuple(desc.shape)} {desc.dtype}"
        )
    if desc.device != W.device:
        raise ValueError("fused_level_call: panel and descriptor on different devices")
    if not W.is_cuda:
        return fused_level_plain(W, desc, params, t1, t2)
    if not W.is_contiguous():
        raise ValueError("fused_level_call: the panel is updated in place and must be contiguous")
    desc = desc.contiguous()
    E, B = desc.shape[0], W.shape[1]
    if E and B:
        build.launch(
            "level", W.data_ptr(), desc.data_ptr(), E, B, t1, t2,
            fk._host_ptr(fk.field_words(params)), fk._stream(W),
        )
    return W
