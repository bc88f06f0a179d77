"""Batched witness solver: executes a `Plan` over N circuit instances.

State per batch:

* ``W``    — (num_witnesses, B, 8) int32: the witness-major panel of
  standard-form values, 8 x 32-bit limbs each (uint32 bit patterns);
* ``ok``   — (B,) bool, per-instance satisfiability flag (the data-parallel
  analogue of the reference's UnsatisfiedConstrain errors — a failing instance
  flips its flag instead of aborting the batch);
* ``fail`` — (B,) int32, the smallest failing opcode index (``FAIL_NONE`` when
  satisfied).

Every level kind works on the one panel layout.  Arith-static levels run the
fused level kernel in place; dynamic-denominator solves and assert-zero checks
gather their operands and run the expression-dot, multiply and power kernels;
the Grumpkin gadgets (fixed-base scalar multiplication, Pedersen commitments,
Schnorr verification) gather their scalars and bytes and run the MSM tree and
the variable-base ladder over the fused point-addition kernel
(:mod:`acvm_tpu_torch.gpu.ec`).  Range checks, AND/XOR and the radix digits
of a power-of-two ToLeRadix are masks and shifts over the gathered limbs;
the Quotient directive divides with the ``divmod`` kernel
(:func:`acvm_tpu_torch.gpu.intops.long_divmod`); recursive-aggregation outputs
are zeroed.  Straight-line Brillig blocks run as batched limb operations
(:mod:`acvm_tpu_torch.gpu.brillig_trace`), one trace for every group of a
level's blocks that share their bytecode.  Memory blocks (``MemoryInit`` /
``MemoryOp``) are state beside the panel: a ``(size, B, 8)`` slab a block,
the slabs of one size stacked as ``(K, size, B, 8)``, so a level's opcodes on
several blocks of one size gather and scatter together.  PyTorch runs
eagerly, so a solve is a Python loop over the plan's levels.

The plan's levels form *segments*: a level with host stages closes one.  The
host stages (a ToLeRadix of another radix, PermutationSort, Brillig blocks the
trace does not run, foreign calls, hooked Schnorr, hash gadgets the device
does not run) read their witnesses off the panel in one gather and one copy,
run on the host (batched over the instances as object arrays where
:mod:`acvm_tpu_torch.gpu.host_batch` has a route, else instance by instance
through the sequential solvers of :mod:`acvm_tpu_torch.pwg`) and write back
in one scatter.  A branchy Brillig block (jumps, calls, memory, traps) runs
on the device Brillig VM (:mod:`acvm_tpu_torch.gpu.brillig_vm_device`): one
``brillig_vm`` launch a block over the whole batch.

The hash gadgets (SHA-256, BLAKE2s, Keccak-256 of a static or a runtime
length, hash-to-field) run a level's gates of one kind and message length as
one launch of their kernel (:func:`acvm_tpu_torch.gpu.gadgets.hash_rows`):
the bytes read off the panel, the digest written back as canonical rows.

ECDSA verifications (secp256k1, secp256r1) run a level's gates of one curve
together: the bytes read off the panel, the scalars and the key's checks in
the wide field ops of :mod:`acvm_tpu_torch.gpu.ecdsa`, R = u1 G + u2 Q as one
``ecdsa_mul`` launch, the valid bit written back.

A batch whose state does not fit one pass (``BatchSolver.max_batch_per_pass``)
is streamed: passes of that many instances, one panel on the device at a
time, the next pass's inputs packed on a host thread and uploaded on a
second stream while the current pass solves (``BatchSolver.solve``,
``BatchSolver.solve_chunks``).

``BatchSolver(plan, mesh=...)`` shards the batch over a mesh
(:mod:`acvm_tpu_torch.parallel`): contiguous slices of the instances, one an
entry, each solved by a solver of its entry's device (entries may repeat a
device), every shard's device levels queued before any shard's readback; the
result (:class:`ShardedBatchResult`) reads in global instance order.  Under a
mesh of ``torch.distributed`` ranks each process solves its own slice and the
results are gathered.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import brillig as br
from ..acir import opcodes as ops
from ..acir.witness import Witness, WitnessMap
from ..blackbox import BlackBoxFunctionSolver, GrumpkinSolver
from ..convert import limbs32_to_limbs16
from ..fields.field import FieldElement
from ..blackbox.ec import grumpkin
from ..blackbox.grumpkin import derive_generator, schnorr_challenge_hook
from ..fields.kernels import (
    LIMBS,
    int_to_limbs32,
    ints_to_limbs32,
    limbs32_to_ints,
    mont_dot,
    mont_dot_v1,
    mont_mul_v1,
    wrap_i32,
)
from ..fields.mxu_ops import mont_dot_mxu, mxu_ok
from ..fields.params import BN254_FR
from ..fields.torch_ops import LimbContext, geq
from ..parallel.mesh import on_device
from ..pwg import blackbox as bb_dispatch
from ..pwg.brillig_solver import BrilligSolver
from ..pwg.directives import solve_directives
from ..pwg.errors import OpcodeResolutionError
from ..utils.logging import get_logger
from ..utils.profiling import SolveStats, Timer
from . import ec, ecdsa, gadgets, host_batch, intops
from .brillig_trace import BrilligTraceError, resolve_brillig, trace_brillig
from .brillig_vm_device import program_for, run_brillig_vm_batch
from .fused_level import fused_level_call, pack_level_desc
from .planner import ExprPlan, HostStage, Level, MemoryInitStage, Plan

# Per-instance first-failure sentinel: "no failure yet".  The batch path's
# analogue of the reference's located errors (acvm/src/pwg/mod.rs:282-299):
# every kernel that can flip an instance's ok flag also records the smallest
# failing opcode index, which BatchResult resolves to an OpcodeLocation +
# assert message.
FAIL_NONE = np.int32(2**31 - 1)

# Gates per chunk of a level's batch inversion: one `batch_inv` launch, a
# thread a chunk of one instance (a lane), a Fermat chain a block of lanes
# (`fields/kernels.py::batch_inv_plan`).  A level of E gates over B instances
# has E * B / g lanes, each 3(g - 1) products; every lane's prefixes wait in
# the output through one chain period.  Small g makes more lanes than the card
# holds at once (a second wave, a second chain period); large g lengthens a
# lane's dependent depth of ~3g products.  On an H100 at E = B = 2,048
# (`chip_smoke.py`, `ms_by_chunk`): g = 32 0.60 ms, 64 0.43, 128 0.45, 256
# 0.60.  Any chunking gives the same bits.
_DYN_INV_CHUNK = 64

# What one step of a solve (the inputs' upload, a device level, or a
# segment's host stages) allocates beside the state, in rows of one
# instance's limbs (32 bytes an instance), for each unit of its work
# (:meth:`BatchSolver.step_units`): an input witness (uploaded, then
# transposed), a gate, a digit of a ToLeRadix, an input of a Pedersen hash, a
# memory opcode, an entry of the largest memory block a level initializes,
# a traced Brillig block and a binary op of its bytecode (the trace's int
# ops over 16-bit halves in int64), a column a host stage reads or writes
# or a row of a device VM block's registers and memory.  Each is the most a
# unit took in any step of the paths of ``chip_smoke.py --step-peaks`` on
# an H100 80GB HBM3 (700 W), rounded up: a static level 0 (the fused kernel
# writes the panel in place), a dyn gate 6.08-6.11 (batch_inv's prefixes),
# a Quotient 6.03, an AND/XOR 4.0, an ECDSA gadget 80-83, a fixed-base or
# Schnorr gadget at 64-128 instances, where its tables' fixed bytes count
# per instance.  STEP_BASE_ROWS covers a step's few flags and index
# tensors.
TEMP_ROWS_PER_UNIT = {
    "inputs": 2.0, "arith_static": 0.0, "arith_dyn": 6.25, "arith_check": 4.0, "range": 2.25,
    "logic": 4.0, "quotient": 6.25, "to_le_radix": 3.25, "hashes": 2.0,
    "ec_fixed_base": 360.0, "ec_pedersen": 180.0, "schnorr": 1100.0, "ecdsa": 84.0,
    "memory": 5.5, "memory_init": 1.0, "brillig": 1.0, "brillig_ops": 10.0, "host": 1.25,
}
STEP_BASE_ROWS = 16.0

# One pass's peak device allocation over :meth:`BatchSolver.pass_bytes`:
# the default pass is the largest batch whose ``pass_bytes`` times this fits
# the memory free for the solve; ``chip_smoke.py`` fails if a path's first
# solve peaks past this (``pass_peaks``; the readings are in PERF.md).
PASS_PEAK_OVER_ESTIMATE = 1.1

# The packed host arrays of a pass (:meth:`BatchSolver._pack_host`) that a
# streamed solve copies to the card ahead of the pass: the values and the
# indices they are scattered to.  Their size is the inputs', never a panel's.
_UPLOADED = ("vals", "narrow", "cols", "at")


def note_failures(fail: torch.Tensor, bad: torch.Tensor, op_idx: torch.Tensor) -> torch.Tensor:
    """Fold per-gate failure flags into the per-instance first-failure index.

    fail: (B,) int32; bad: (G, B) bool; op_idx: (G,) int32 opcode indices."""
    none = torch.full((), int(FAIL_NONE), dtype=torch.int32, device=fail.device)
    cand = torch.where(bad, op_idx[:, None], none)
    return torch.minimum(fail, cand.min(dim=0).values)


# ---------------------------------------------------------------------------
# Packing (host, numpy)
# ---------------------------------------------------------------------------


def pack_exprs(exprs: List[ExprPlan]) -> Dict[str, np.ndarray]:
    """Dense index / coefficient arrays of E expressions, padded to the widest:
    lin_idx (E, n), lin_coeff (E, n, 8), mul_idx (E, m, 2), mul_coeff
    (E, m, 8), qc (E, 8); coefficients as int32 limbs.  Padding terms carry a
    zero coefficient and index 0."""
    E = len(exprs)
    n = max((len(e.lin_idx) for e in exprs), default=0)
    m = max((len(e.mul_idx) for e in exprs), default=0)
    lin_idx = np.zeros((E, n), dtype=np.int32)
    lin_c = np.zeros((E, n), dtype=object)
    mul_idx = np.zeros((E, m, 2), dtype=np.int32)
    mul_c = np.zeros((E, m), dtype=object)
    for i, e in enumerate(exprs):
        k = len(e.lin_idx)
        lin_idx[i, :k] = e.lin_idx
        lin_c[i, :k] = e.lin_coeff_r
        k = len(e.mul_idx)
        if k:
            mul_idx[i, :k] = e.mul_idx
            mul_c[i, :k] = e.mul_coeff_r2
    return dict(
        lin_idx=lin_idx,
        lin_coeff=ints_to_limbs32(lin_c.reshape(-1)).reshape(E, n, LIMBS),
        mul_idx=mul_idx,
        mul_coeff=ints_to_limbs32(mul_c.reshape(-1)).reshape(E, m, LIMBS),
        qc=ints_to_limbs32(e.qc for e in exprs).reshape(E, LIMBS),
    )


def _range_zero_mask(num_bits: int) -> np.ndarray:
    """Bits that must be zero for a value < 2^num_bits, as (8,) int32 limb
    masks (uint32 bit patterns: 0xFFFFFFFF is -1)."""
    return int_to_limbs32(((1 << 256) - 1) ^ ((1 << min(num_bits, 256)) - 1))


def _allow_mask(num_bits: int) -> np.ndarray:
    """Bits below 2^num_bits, as (8,) int32 limb masks."""
    return ~_range_zero_mask(num_bits)


def _pack_to_device(pack: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Expression pack -> tensors: int64 gather indices, int32 coefficients."""
    out = {}
    for key, arr in pack.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if key.endswith("_idx"):
            t = t.to(torch.int64)
        out[key] = t.to(device)
    return out


def _widen_narrow(t: torch.Tensor) -> torch.Tensor:
    """A uint8 or uint16 tensor -> int32 of the same values, on its device.
    torch's uint16 has few operations (none but copies on CUDA), so it is
    reinterpreted as int16 and masked."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


# A foreign-call handler's answer -> the VM's ForeignCallResult (the JAX
# package's api.py:86-105; this package's api module is not ported yet).
ForeignCallHandler = Callable[[str, List[List[FieldElement]]], Sequence[object]]


def _to_field(value) -> FieldElement:
    if isinstance(value, FieldElement):
        return value
    if isinstance(value, int):
        return FieldElement(value)
    if isinstance(value, str):
        f = FieldElement.from_hex(value)
        if f is None:
            raise ValueError(f"invalid hex field element: {value!r}")
        return f
    raise TypeError(f"cannot convert {value!r} to a field element")


def _decode_foreign_call_result(outputs: Sequence[object]) -> br.ForeignCallResult:
    values = []
    for output in outputs:
        if isinstance(output, (list, tuple)):
            values.append(br.FcArray(tuple(br.Value(_to_field(v)) for v in output)))
        else:
            values.append(br.FcSingle(br.Value(_to_field(output))))
    return br.ForeignCallResult(tuple(values))


# ---------------------------------------------------------------------------
# Level kinds (operate on tensors of the solver's device)
# ---------------------------------------------------------------------------


DOT_KERNELS = ("v2", "v1", "mxu")


def eval_exprs(
    ctx: LimbContext, W: torch.Tensor, pack, scale=None, dot_kernel: str = "v2"
) -> torch.Tensor:
    """Evaluate E packed expressions for every instance: (E, B, 8).

    The witness gathers are plain tensor ops.  Under ``dot_kernel="v2"`` the
    whole per-gate chain — operand multiplies, the witness*witness
    pre-multiply of quadratic terms, the modular-add fold, q_c and the
    optional final ``scale`` multiply — is ONE call of
    :func:`acvm_tpu_torch.fields.kernels.mont_dot` (the fused dot kernel for a
    CUDA panel, the op-by-op plain version for a CPU panel).  Under ``"v1"``
    the quadratic operands are multiplied first (``mont_mul_v1``), the
    products join the linear operands as one panel, and the first-generation
    dot (``mont_dot_v1``) folds it.  Under ``"mxu"`` a panel that
    :func:`~acvm_tpu_torch.fields.mxu_ops.mxu_ok` takes (BN254, 1-8 terms, no
    ``scale``) has its quadratic operands multiplied first (``mont_mul``) and
    the whole linear combination folded by ONE tensor-core launch
    (:func:`~acvm_tpu_torch.fields.mxu_ops.mont_dot_mxu`, ``qc`` in Montgomery
    form), as the JAX package's MXU route does; any other panel takes the
    ``"v2"`` dot, the JAX package's routing rule.  All three give the same
    bits.

    ``scale`` (E, 8 limbs, Montgomery form) multiplies the accumulated value.
    """
    B = W.shape[1]
    E = pack["qc"].shape[0]
    n = pack["lin_idx"].shape[1]
    m = pack["mul_idx"].shape[1]
    if not (n or m):
        # Constant-only panel: nothing to gather or multiply.
        acc = pack["qc"][:, None, :].expand(E, B, LIMBS).contiguous()
        if scale is not None:
            acc = ctx.mont_mul(scale[:, None, :], acc)
        return acc
    vals = v1 = v2 = None
    if n:
        vals = W.index_select(0, pack["lin_idx"].reshape(-1)).reshape(E, n, B, LIMBS)
    if m:
        v1 = W.index_select(0, pack["mul_idx"][:, :, 0].reshape(-1)).reshape(E, m, B, LIMBS)
        v2 = W.index_select(0, pack["mul_idx"][:, :, 1].reshape(-1)).reshape(E, m, B, LIMBS)
    if dot_kernel == "mxu" and scale is None and mxu_ok(ctx.params, n + m):
        panels = [vals] if n else []
        coeffs = [pack["lin_coeff"]] if n else []
        if m:
            panels.append(ctx.mont_mul(v1, v2))  # w1*w2*R^-1
            coeffs.append(pack["mul_coeff"])
        panel = panels[0] if len(panels) == 1 else torch.cat(panels, dim=1)
        coeff = coeffs[0] if len(coeffs) == 1 else torch.cat(coeffs, dim=1)
        return mont_dot_mxu(panel, coeff, ctx.to_mont(pack["qc"]), ctx.params)
    if dot_kernel == "v1":
        panels, coeffs = [], []
        if n:
            panels.append(vals)
            coeffs.append(pack["lin_coeff"])
        if m:
            panels.append(mont_mul_v1(v1, v2))  # w1*w2*R^-1
            coeffs.append(pack["mul_coeff"])
        panel = panels[0] if len(panels) == 1 else torch.cat(panels, dim=1)
        coeff = coeffs[0] if len(coeffs) == 1 else torch.cat(coeffs, dim=1)
        return mont_dot_v1(panel, coeff, pack["qc"], scale, ctx.params)
    return mont_dot(
        vals, pack["lin_coeff"] if n else None,
        v1, v2, pack["mul_coeff"] if m else None,
        pack["qc"], scale, ctx.params,
    )


def run_arith_solve_static(ctx, W, ok, buf):
    # -num / den_const, with the division folded into the packed coefficients
    # at pack time (see _pack_level): one fused in-place level call.
    W = fused_level_call(W, buf["desc"], ctx.params, buf["t1"], buf["t2"])
    return W, ok


def run_arith_solve_dyn(ctx, W, ok, fail, buf, dot_kernel="v2"):
    # -num comes out of the dot itself: its final scale multiply by -1 (in
    # Montgomery form) negates in the kernel, where a separate neg would be a
    # chain of elementwise passes over the (E, B) panel.
    neg_num = eval_exprs(ctx, W, buf["num"], buf["minus_one"], dot_kernel)  # (E, B, 8)
    den = eval_exprs(ctx, W, buf["den"], dot_kernel=dot_kernel)
    den_zero = ctx.is_zero(den)
    num_zero = ctx.is_zero(neg_num)
    # One Fermat chain amortized over the level's gate axis (Montgomery's
    # trick) instead of a 254-squaring chain per gate.
    inv_m = ctx.mont_batch_inv(  # den^-1 * R
        ctx.to_mont(den), axis=0, max_scan=_DYN_INV_CHUNK
    )
    val = ctx.mont_mul(neg_num, inv_m)  # -num/den
    val = torch.where(den_zero[..., None], torch.zeros_like(val), val)
    # den == 0 & num != 0 -> unsatisfied (arithmetic.rs:46-54).
    bad = den_zero & ~num_zero
    ok = ok & ~bad.any(dim=0)
    fail = note_failures(fail, bad, buf["op_idx"])
    W.index_copy_(0, buf["u_idx"], val)
    return W, ok, fail


def run_arith_check(ctx, W, ok, fail, buf, dot_kernel="v2"):
    val = eval_exprs(ctx, W, buf["expr"], dot_kernel=dot_kernel)
    bad = ~ctx.is_zero(val)
    fail = note_failures(fail, bad, buf["op_idx"])
    return W, ok & ~bad.any(dim=0), fail


def run_range(ctx, W, ok, fail, buf):
    vals = W.index_select(0, buf["w_idx"])  # (G, B, 8)
    bad = ((vals & buf["zero_mask"][:, None, :]) != 0).any(dim=-1)  # (G, B)
    fail = note_failures(fail, bad, buf["op_idx"])
    return W, ok & ~bad.any(dim=0), fail


def run_logic(ctx, W, ok, buf, is_xor):
    a = W.index_select(0, buf["lhs"])
    b = W.index_select(0, buf["rhs"])
    res = ((a ^ b) if is_xor else (a & b)) & buf["allow_mask"][:, None, :]
    if buf["reduce"]:
        # XOR of two values below 2^num_bits reaches p where 2^num_bits > p;
        # the sequential engine reduces it (FieldElement), so reduce once.
        res = torch.where(geq(res, ctx.p_limbs)[..., None], intops.int_sub(res, ctx.p_limbs), res)
    W.index_copy_(0, buf["out"], res)
    return W, ok


def run_quotient(ctx, W, ok, buf, dot_kernel="v2"):
    a = eval_exprs(ctx, W, buf["a"], dot_kernel=dot_kernel)  # (G, B, 8)
    b = eval_exprs(ctx, W, buf["b"], dot_kernel=dot_kernel)
    q, r = intops.long_divmod(a, b, num_bits=256)  # b = 0 gives q = r = 0
    active = ~ctx.is_zero(eval_exprs(ctx, W, buf["pred"], dot_kernel=dot_kernel))[..., None]
    q = torch.where(active, q, torch.zeros_like(q))
    r = torch.where(active, r, torch.zeros_like(r))
    W.index_copy_(0, buf["q_idx"], q)
    W.index_copy_(0, buf["r_idx"], r)
    return W, ok


def run_to_le_radix(ctx, W, ok, fail, buf, dot_kernel="v2"):
    vals = eval_exprs(ctx, W, buf["value"], dot_kernel=dot_kernel)  # (G, B, 8)
    # Capacity check: the value must fit the digits it is given
    # (directives/mod.rs:67-71).  The digits are written either way.
    bad = ((vals & buf["overflow_mask"][:, None, :]) != 0).any(dim=-1)  # (G, B)
    fail = note_failures(fail, bad, buf["op_idx"])
    ok = ok & ~bad.any(dim=0)
    # Digit d is bits [off, off + k) of the 64-bit word made of limbs d_limb and
    # d_limb + 1 (k <= 32, off <= 31), in int64 from the unsigned limbs; two
    # zero limbs past the top stand for the bits at or past 2^256.  Only the
    # word's bits below 63 are read, so its high limb keeps 31 bits and the
    # word stays positive.
    u = F.pad(vals.to(torch.int64) & 0xFFFFFFFF, (0, 2))  # (G, B, 10)
    lo = u[buf["d_gate"], :, buf["d_limb"]]  # (D, B)
    hi = u[buf["d_gate"], :, buf["d_limb"] + 1] & 0x7FFFFFFF
    digits = ((lo | (hi << 32)) >> buf["d_bitoff"][:, None]) & buf["d_mask"][:, None]
    out = torch.zeros(digits.shape + (LIMBS,), dtype=torch.int32, device=W.device)
    out[..., 0] = wrap_i32(digits)
    W.index_copy_(0, buf["out_idx"], out)
    return W, ok, fail


def run_hashes(ctx, W, ok, fail, buf):
    """One group of hash gadgets: a kind and a message length, one launch.

    A variable-length Keccak's size is read as ``pwg.ACVM`` reads it, by its
    low 128 bits (``FieldElement.to_u128``): the instance fails where that
    exceeds the M message bytes (limbs 1-3 non-zero, or limb 0 above M) and
    the bits above 128 are ignored.  A failing instance hashes min(limb 0, M)
    bytes, as the JAX ``BatchSolver`` does."""
    length = None
    if buf["kind"] == "keccak_var":
        M = buf["src_w"].shape[1]
        size = W.index_select(0, buf["size_w"])  # (G, B, 8)
        low = size[..., 0].to(torch.int64) & 0xFFFFFFFF
        bad = (size[..., 1:4] != 0).any(dim=-1) | (low > M)
        ok = ok & ~bad.any(dim=0)
        fail = note_failures(fail, bad, buf["op_idx"])
        length = low.clamp(max=M).to(torch.int32)
    modulus = ctx.params.modulus if buf["kind"] == "hash_to_field" else None
    W = gadgets.hash_rows(buf["kind"], W, buf["src_w"], buf["src_limb"], buf["src_shift"],
                          buf["out_idx"], length=length, modulus=modulus)
    return W, ok, fail


def run_ec_fixed_base(ctx, W, ok, fail, buf):
    """Batched windowed fixed-base Grumpkin scalar multiplication."""
    low = W.index_select(0, buf["low_idx"])  # (G, B, 8)
    high = W.index_select(0, buf["high_idx"])
    G, B, _ = low.shape
    # u128-limb validation (scalar_mul.rs:25-52): top limbs must be zero and
    # the combined scalar must be below the grumpkin group order.
    fits = (low[..., 4:] == 0).all(dim=-1) & (high[..., 4:] == 0).all(dim=-1)
    scalar = torch.cat([low[..., :4], high[..., :4]], dim=-1)
    valid = fits & ~geq(scalar, buf["order_limbs"])  # (G, B)
    ok = ok & valid.all(dim=0)
    fail = note_failures(fail, ~valid, buf["op_idx"])

    point = ec.fixed_base_mul(ctx, buf["table"], scalar.reshape(G * B, LIMBS))
    ax, ay = ec.pt_to_affine(ctx, point)
    keep = valid.reshape(G * B, 1)
    zero = torch.zeros_like(ax)
    W.index_copy_(0, buf["out_x"], torch.where(keep, ax, zero).reshape(G, B, LIMBS))
    W.index_copy_(0, buf["out_y"], torch.where(keep, ay, zero).reshape(G, B, LIMBS))
    return W, ok, fail


def run_ec_pedersen(ctx, W, ok, gate_buf):
    """One Pedersen commitment gate: windowed MSM over fixed generators, all
    generators' window entries summed in one tree reduction."""
    scalars = W.index_select(0, gate_buf["input_idx"])  # (n, B, 8)
    acc = ec.msm_fixed_tables(ctx, gate_buf["tables"], scalars)
    ax, ay = ec.pt_to_affine(ctx, acc)
    W[gate_buf["out_x"]] = ax
    W[gate_buf["out_y"]] = ay
    return W, ok


def _bytes_of(W, idx):
    """(G, n) witness indices -> (G * B, n) bytes, gate-major: to_u8_vec
    semantics, the last BE byte of each witness == the low byte of limb 0."""
    G, B = idx.shape[0], W.shape[1]
    low = W.index_select(0, idx.reshape(-1))[..., 0] & 0xFF  # (G * n, B)
    return low.reshape(G, -1, B).permute(0, 2, 1).reshape(G * B, -1)


def run_schnorr(ctx, W, ok, buf):
    """Grouped Schnorr verifications with identical message length."""
    B = W.shape[1]
    G = buf["pub_x"].shape[0]
    pub_x = W.index_select(0, buf["pub_x"]).reshape(G * B, LIMBS)
    pub_y = W.index_select(0, buf["pub_y"]).reshape(G * B, LIMBS)
    sig = _bytes_of(W, buf["sig_idx"])
    if buf["msg_idx"].numel():
        msg = _bytes_of(W, buf["msg_idx"])
    else:
        msg = torch.zeros((G * B, 0), dtype=torch.int32, device=W.device)
    valid = ec.schnorr_verify_batched(
        ctx, pub_x, pub_y, sig, msg, buf["pedersen_tables"], buf["gen_table"]
    ).reshape(G, B)
    out = torch.zeros((G, B, LIMBS), dtype=torch.int32, device=W.device)
    out[..., 0] = valid
    W.index_copy_(0, buf["out_idx"], out)
    return W, ok


def run_ecdsa(W, ok, fail, buf):
    """Grouped ECDSA verifications on one curve: one ``ecdsa_mul`` launch.

    Each input witness gives one byte, the low byte of limb 0 (the reference's
    ``to_u8_vec``, signature/mod.rs:5-18).  An instance the host verifier
    would raise on (a coordinate >= p, an off-curve key, r or s zero or >= n,
    z >= n) fails at the gate's opcode; the output is the valid bit in limb
    0, 0 where the instance errs."""
    B = W.shape[1]
    G = buf["op_idx"].shape[0]
    valid, err = ecdsa.ecdsa_verify_batched(
        buf["curve"], *(_bytes_of(W, buf[k]) for k in ("pub_x", "pub_y", "sig", "msg")))
    err = err.reshape(G, B)
    ok = ok & ~err.any(dim=0)
    fail = note_failures(fail, err, buf["op_idx"])
    out = torch.zeros((G, B, LIMBS), dtype=torch.int32, device=W.device)
    out[..., 0] = valid.reshape(G, B)
    W.index_copy_(0, buf["out_idx"], out)
    return W, ok, fail


def run_memory_init(W, blocks, buf):
    """MemoryInit: the block's first entries from the init witnesses."""
    blocks[buf["k"], : buf["init_idx"].shape[0]] = W.index_select(0, buf["init_idx"])


def run_memory_ops(ctx, W, ok, fail, blocks, buf, dot_kernel="v2"):
    """G memory opcodes on G distinct blocks of one size at once, over the
    batch (memory_op.rs:47-123 semantics, as ``pwg.ACVM`` solves them).

    ``blocks`` is the ``(K, size, B, 8)`` stack of that size; ``buf["k"]``
    picks each opcode's block.  The index is limb 0 of its value; a value of
    2^64 or more fails the instance whatever the predicate (``try_to_u64``),
    one past the block fails it where the predicate holds.  Each instance acts
    as a read where the operation selector is zero and as a write elsewhere.
    An inactive read gives 0 and an inactive write is skipped.  A read with no
    witness to assign (``read_w`` None: the value was already known) fails,
    as does an active write whose value is the unknown witness (``value``
    None)."""
    size = buf["size"]
    B = W.shape[1]
    idx_val = eval_exprs(ctx, W, buf["index"], dot_kernel=dot_kernel)  # (G, B, 8)
    too_big = (idx_val[..., 2:] != 0).any(dim=-1)
    idx = idx_val[..., 0].to(torch.int64) & 0xFFFFFFFF
    in_bounds = (idx_val[..., 1] == 0) & ~too_big & (idx < size)
    active = ~ctx.is_zero(eval_exprs(ctx, W, buf["pred"], dot_kernel=dot_kernel))  # (G, B)
    if buf["sel"] is None:
        is_read = torch.full_like(active, buf["is_read"])
    else:
        is_read = ctx.is_zero(eval_exprs(ctx, W, buf["sel"], dot_kernel=dot_kernel))
    bad = too_big | (~in_bounds & active)
    at = (buf["k"][:, None], torch.where(in_bounds, idx, 0),
          torch.arange(B, device=W.device))
    cur = blocks[at]  # (G, B, 8)

    if buf["read_w"] is None:
        bad = bad | is_read
    else:
        read = torch.where((active & in_bounds)[..., None], cur, torch.zeros_like(cur))
        if buf["sel"] is not None:
            read = torch.where(is_read[..., None], read, W.index_select(0, buf["read_w"]))
        W.index_copy_(0, buf["read_w"], read)

    if buf["may_write"]:
        if buf["value"] is None:
            wval = torch.zeros_like(cur)
            bad = bad | (~is_read & active)
        else:
            wval = eval_exprs(ctx, W, buf["value"], dot_kernel=dot_kernel)
        blocks[at] = torch.where((~is_read & active & in_bounds)[..., None], wval, cur)
    fail = note_failures(fail, bad, buf["op_idx"])
    return W, ok & ~bad.any(dim=0), fail


def run_brillig(ctx, W, ok, buf, dot_kernel="v2"):
    """G straight-line Brillig blocks of one bytecode, traced once over
    ``(G, B, 8)`` registers.  Where the predicate is zero the outputs are
    zero (pwg/brillig.rs)."""
    inputs = [eval_exprs(ctx, W, pack, dot_kernel=dot_kernel) for pack in buf["inputs"]]
    outputs = trace_brillig(ctx, buf["program"], inputs)
    G, B = buf["out_idx"][0].shape[0], W.shape[1]
    active = None
    if buf["pred"] is not None:
        active = ~ctx.is_zero(eval_exprs(ctx, W, buf["pred"], dot_kernel=dot_kernel))
    for val, out_idx in zip(outputs, buf["out_idx"]):
        val = val.expand(G, B, LIMBS)
        if active is not None:
            val = torch.where(active[..., None], val, torch.zeros_like(val))
        W.index_copy_(0, out_idx, val)
    return W, ok


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


@dataclass
class _Segment:
    levels: List[dict]  # packed device buffers per level
    host_stages: List[HostStage]  # run after the device levels
    # Work of each device level, then of the host stages (step_units).
    units: List[Counter]


def level_units(level: Level) -> Counter:
    """A device level's work by kind, in the units of :data:`TEMP_ROWS_PER_UNIT`."""
    static = sum(g.neg_inv_den_r is not None for g in level.arith_solve)
    return +Counter({
        "arith_static": static,
        "arith_dyn": len(level.arith_solve) - static,
        "arith_check": len(level.arith_check),
        "range": len(level.range_checks),
        "logic": len(level.logic),
        "quotient": len(level.quotient),
        "to_le_radix": sum(len(g.outputs) for g in level.to_le_radix),
        "hashes": len(level.hashes),
        "ec_fixed_base": len(level.ec_fixed_base),
        "ec_pedersen": sum(len(g.inputs) for g in level.ec_pedersen),
        "schnorr": len(level.schnorr),
        "ecdsa": len(level.ecdsa),
        "memory": sum(not isinstance(m, MemoryInitStage) for m in level.memory),
        "memory_init": max((len(m.init) for m in level.memory if isinstance(m, MemoryInitStage)),
                           default=0),
        "brillig": len(level.brillig),
        "brillig_ops": sum(isinstance(op, (br.OpBinaryIntOp, br.OpBinaryFieldOp))
                           for st in level.brillig for op in st.bytecode),
    })


def host_units(stages: List[HostStage], circuit, p: int) -> Counter:
    """A segment's host stages' work: the columns they read and write (one
    gather, one scatter) and the largest device VM block's registers and
    memory, as :func:`.brillig_vm_device.initial_state` sizes them."""
    reads, writes, vm_rows = set(), set(), 0
    for stage in stages:
        reads.update(stage.reads if stage.reads else stage.known_before)
        writes.update(stage.writes)
        for i in stage.opcode_indices:
            opcode = circuit.opcodes[i]
            if isinstance(opcode, ops.OpcodeBrillig) and host_batch.device_vm_eligible(opcode.brillig):
                brillig = opcode.brillig
                words = sum(len(x.exprs) for x in brillig.inputs
                            if isinstance(x, ops.BrilligInputArray))
                regs = max(program_for(brillig, p).max_reg + 1, len(brillig.inputs),
                           len(brillig.outputs), 1)
                vm_rows = max(vm_rows, regs + max(32, 2 * words + 32))
    return Counter({"host": len(reads) + len(writes) + vm_rows})


class BatchSolver:
    """``backend`` solves the host stages' backend-dependent black-box calls
    (Schnorr, Pedersen, fixed-base multiplication; default
    :class:`GrumpkinSolver`); ``foreign_call_handler(name, inputs)`` answers
    the foreign calls of a host stage's Brillig blocks, instance by instance
    (without one, an instance that reaches a foreign call fails at that
    opcode).

    ``dot_kernel`` picks the expression-evaluation route of the
    dynamic-denominator and assert-zero levels: ``"v2"`` (the fused dot, the
    default), ``"v1"`` (the first-generation multiply and dot, BN254 only) or
    ``"mxu"`` (the tensor-core dot where ``mxu_ok`` takes the panel, else
    ``"v2"``; the JAX package's opt-in ``ACVM_TPU_MXU``).  All give the same
    bits.

    ``group_stages`` (the default) runs a level's Brillig blocks of one
    bytecode as one trace and its memory opcodes on blocks of one size as one
    gather and scatter; ``False`` runs each block and each opcode alone, as
    the JAX package does: the same bits in more launches.

    ``host_batch`` (the default) runs a host stage batched over the instances
    where it has a route (straight-line Brillig, a general ToLeRadix and
    PermutationSort in :mod:`.host_batch`; a branchy Brillig block on the
    device Brillig VM); ``False`` runs every host stage instance by instance
    through the sequential solvers: the same bits, slower (the JAX package's
    ``ACVM_TPU_NO_HOST_BATCH``).

    ``mesh`` (:class:`~acvm_tpu_torch.parallel.Mesh`) shards each batch over
    the mesh's entries (:meth:`_solve_mesh`); the solver's ``device`` is then
    its first entry here (a ``device`` given beside a mesh must be that one),
    and each other device of the mesh gets a solver of its own.  A mesh of
    ``torch.distributed`` ranks (``parallel.distributed.global_mesh``) has
    each process solve its own entry's slice.

    ``max_batch_per_pass`` fixes the instances of one pass, and
    ``pass_budget_bytes`` the device bytes a pass may take (the JAX package's
    ``ACVM_TPU_MAX_BATCH_PER_PASS`` and ``ACVM_TPU_HBM_BUDGET_GB``); by
    default a CUDA solver sizes a pass by the device memory free when it
    solves, and a CPU solver runs every batch in one pass."""

    def __init__(
        self,
        plan: Plan,
        backend: Optional[BlackBoxFunctionSolver] = None,
        foreign_call_handler: Optional[ForeignCallHandler] = None,
        mesh=None,
        device=None,
        dot_kernel: str = "v2",
        group_stages: bool = True,
        host_batch: bool = True,
        max_batch_per_pass: Optional[int] = None,
        pass_budget_bytes: Optional[int] = None,
    ):
        self.mesh = mesh
        if mesh is not None:
            device = self._mesh_device(mesh, device)
        elif device is None:
            device = "cuda"
        if dot_kernel not in DOT_KERNELS:
            raise ValueError(f"BatchSolver: dot_kernel must be one of {DOT_KERNELS}")
        if dot_kernel == "v1" and plan.params != BN254_FR:
            raise ValueError(
                "BatchSolver: dot_kernel='v1' multiplies with the first-generation "
                f"kernel, which knows BN254 only, not {plan.params.name}"
            )
        self.plan = plan
        self.backend = backend or GrumpkinSolver()
        self.foreign_call_handler = foreign_call_handler
        self.device = torch.device(device)
        self.dot_kernel = dot_kernel
        self.group_stages = group_stages
        self.host_batch = host_batch
        if max_batch_per_pass is not None and max_batch_per_pass < 1:
            raise ValueError("BatchSolver: max_batch_per_pass must be at least 1")
        self._pass_limit = max_batch_per_pass
        self.pass_budget_bytes = pass_budget_bytes
        self.ctx = LimbContext(plan.params, self.device)  # raises without a card
        # (domain, index) -> the Pedersen generator each device table was
        # built from, and whether a Schnorr gate was packed: solve() checks
        # both against what the host code would use now.
        self._generators: Dict[tuple, tuple] = {}
        self._has_schnorr = False
        # Memory block id -> (size, slot): the slab of the block is
        # mem[size][slot] in a state (W, ok, fail, mem).
        self.memory_slots: Dict[int, tuple] = {}
        self._memory_counts: Counter = Counter()  # size -> blocks of that size
        for block_id, size in sorted(plan.memory_block_sizes.items()):
            self.memory_slots[block_id] = (size, self._memory_counts[size])
            self._memory_counts[size] += 1
        self.segments = self._build_segments()
        # The solver of each mesh entry this process solves: this one on its
        # own device, one more for each other device (repeated entries share).
        self._entry_solvers: Dict[int, "BatchSolver"] = {}
        if mesh is not None:
            by_device = {self.device: self}
            for i in self._local_entries():
                d = mesh.devices[i]
                if d not in by_device:
                    by_device[d] = BatchSolver(
                        plan, backend, foreign_call_handler, device=d, dot_kernel=dot_kernel,
                        group_stages=group_stages, host_batch=host_batch,
                        max_batch_per_pass=max_batch_per_pass,
                        pass_budget_bytes=pass_budget_bytes)
                self._entry_solvers[i] = by_device[d]
        self._log = get_logger("batch_solver")
        self._log.info(
            "plan: %d opcodes, %d witnesses, %d levels in %d segments "
            "(%d host stages), device %s",
            len(plan.circuit.opcodes), plan.num_witnesses, len(plan.levels),
            len(self.segments), sum(len(s.host_stages) for s in self.segments),
            self.device,
        )

    # -- mesh ---------------------------------------------------------------
    def _local_entries(self) -> List[int]:
        if self.mesh.distributed:
            import torch.distributed as dist

            return self.mesh.local_entries(dist.get_rank())
        return self.mesh.local_entries()

    def _mesh_device(self, mesh, device) -> torch.device:
        """The device of this process's first mesh entry: this solver's own.
        A mesh of ranks needs its ``torch.distributed`` job, one entry a rank;
        a ``device`` given beside a mesh must be that entry's."""
        from ..parallel.mesh import as_device

        if mesh.distributed:
            import torch.distributed as dist

            if not dist.is_initialized() or dist.get_world_size() != mesh.size:
                raise ValueError("BatchSolver: a mesh of ranks needs its torch.distributed "
                                 "job, with one entry a rank (distributed.initialize)")
        entries = self._local_entries()
        if len(entries) != 1 and mesh.distributed or not entries:
            raise ValueError("BatchSolver: this process owns no entry of the mesh, or "
                             "more than one entry of a mesh of ranks")
        own = mesh.devices[entries[0]]
        if device is not None and as_device(device) != own:
            raise ValueError(f"BatchSolver: device {device} beside a mesh whose entry here "
                             f"is {own}")
        return own

    # -- packing ------------------------------------------------------------
    def _pack_level(self, level: Level) -> dict:
        dev = self.device
        packed: dict = {"kinds": []}

        def idx_tensor(values, dtype):
            return torch.tensor(list(values), dtype=dtype, device=dev)

        def limb_rows(rows):  # (8,) int32 masks -> a (G, 8) tensor
            return torch.from_numpy(np.stack(list(rows))).to(dev)

        static_gates = [g for g in level.arith_solve if g.neg_inv_den_r is not None]
        dyn_gates = [g for g in level.arith_solve if g.neg_inv_den_r is None]
        if static_gates:
            packed["kinds"].append("arith_static")
            # Fold the static -1/den scale into the packed coefficients (host
            # ints), so the device evaluates plain `qc' + sum c'_i v_i` with no
            # per-gate scale multiply chain in the hot kernel.
            p = self.plan.params.modulus
            r_inv = pow(self.plan.params.r % p, p - 2, p)
            folded = []
            for g in static_gates:
                s = g.neg_inv_den_r * r_inv % p  # -1/den (standard form)
                e = g.num
                folded.append(
                    ExprPlan(
                        lin_idx=e.lin_idx,
                        lin_coeff_r=[c * s % p for c in e.lin_coeff_r],
                        mul_idx=e.mul_idx,
                        mul_coeff_r2=[c * s % p for c in e.mul_coeff_r2],
                        qc=e.qc * s % p,
                    )
                )
            num = pack_exprs(folded)
            desc = pack_level_desc(
                dict(num=num, u_idx=np.asarray([g.unknown for g in static_gates], np.int32))
            )
            packed["arith_static"] = dict(
                desc=torch.from_numpy(desc).to(dev),
                t1=num["lin_idx"].shape[1],
                t2=num["mul_idx"].shape[1],
            )
        if dyn_gates:
            packed["kinds"].append("arith_dyn")
            # The denominator is itself an expression panel: qc = den_const,
            # linear terms = the mul-term partners.
            den = pack_exprs(
                [
                    ExprPlan(g.den_dyn_idx, g.den_dyn_coeff_r, [], [], g.den_const)
                    for g in dyn_gates
                ]
            )
            packed["arith_dyn"] = dict(
                num=_pack_to_device(pack_exprs([g.num for g in dyn_gates]), dev),
                den=_pack_to_device(den, dev),
                u_idx=idx_tensor((g.unknown for g in dyn_gates), torch.int64),
                op_idx=idx_tensor((g.opcode_index for g in dyn_gates), torch.int32),
                # -1 in Montgomery form, one row a gate: the dot's scale
                minus_one=self.ctx.neg(self.ctx.r_limbs).expand(len(dyn_gates), LIMBS).contiguous(),
            )
        if level.arith_check:
            packed["kinds"].append("arith_check")
            packed["arith_check"] = dict(
                expr=_pack_to_device(
                    pack_exprs([g.expr for g in level.arith_check]), dev
                ),
                op_idx=idx_tensor(
                    (g.opcode_index for g in level.arith_check), torch.int32
                ),
            )
        if level.range_checks:
            gates = level.range_checks
            packed["kinds"].append("range")
            packed["range"] = dict(
                w_idx=idx_tensor((g.witness for g in gates), torch.int64),
                zero_mask=limb_rows(_range_zero_mask(g.num_bits) for g in gates),
                op_idx=idx_tensor((g.opcode_index for g in gates), torch.int32),
            )
        p_bits = self.plan.params.modulus.bit_length()
        for is_xor, name in ((False, "and"), (True, "xor")):
            gates = [g for g in level.logic if g.is_xor == is_xor]
            if gates:
                packed["kinds"].append(name)
                packed[name] = dict(
                    lhs=idx_tensor((g.lhs for g in gates), torch.int64),
                    rhs=idx_tensor((g.rhs for g in gates), torch.int64),
                    out=idx_tensor((g.output for g in gates), torch.int64),
                    allow_mask=limb_rows(_allow_mask(g.num_bits) for g in gates),
                    reduce=is_xor and max(g.num_bits for g in gates) >= p_bits,
                )
        if level.quotient:
            gates = level.quotient
            packed["kinds"].append("quotient")
            one = ExprPlan([], [], [], [], 1)  # a missing predicate is 1
            packed["quotient"] = dict(
                a=_pack_to_device(pack_exprs([g.a for g in gates]), dev),
                b=_pack_to_device(pack_exprs([g.b for g in gates]), dev),
                pred=_pack_to_device(pack_exprs([g.predicate or one for g in gates]), dev),
                q_idx=idx_tensor((g.q for g in gates), torch.int64),
                r_idx=idx_tensor((g.r for g in gates), torch.int64),
            )
        if level.to_le_radix:
            gates = level.to_le_radix
            packed["kinds"].append("to_le_radix")
            d_gate, d_limb, d_bitoff, d_mask, out_idx, overflow = [], [], [], [], [], []
            for gi, g in enumerate(gates):
                bits = g.radix.bit_length() - 1
                if bits > 32:
                    raise NotImplementedError(
                        f"BatchSolver: to-le-radix with radix 2^{bits}: digits of "
                        "more than 32 bits are not ported (ACIR's radix is a u32)"
                    )
                for di, w in enumerate(g.outputs):
                    shift = di * bits
                    d_gate.append(gi)
                    d_limb.append(min(shift // 32, LIMBS))  # LIMBS: a zero limb
                    d_bitoff.append(shift % 32)
                    d_mask.append(g.radix - 1)
                    out_idx.append(w)
                overflow.append(_range_zero_mask(bits * len(g.outputs)))
            packed["to_le_radix"] = dict(
                value=_pack_to_device(pack_exprs([g.a for g in gates]), dev),
                op_idx=idx_tensor((g.opcode_index for g in gates), torch.int32),
                d_gate=idx_tensor(d_gate, torch.int64),
                d_limb=idx_tensor(d_limb, torch.int64),
                d_bitoff=idx_tensor(d_bitoff, torch.int64),
                d_mask=idx_tensor(d_mask, torch.int64),
                out_idx=idx_tensor(out_idx, torch.int64),
                overflow_mask=limb_rows(overflow),
            )
        if level.hashes:
            packed["kinds"].append("hashes")
            packed["hashes"] = self._pack_hashes(level.hashes)
        if level.ec_fixed_base or level.ec_pedersen or level.schnorr:
            if self.plan.params != BN254_FR:
                raise NotImplementedError(
                    "BatchSolver: the Grumpkin gadgets live over BN254 Fr, not "
                    f"{self.plan.params.name}"
                )
        if level.ec_fixed_base:
            gates = level.ec_fixed_base
            packed["kinds"].append("ec_fixed_base")
            packed["ec_fixed_base"] = dict(
                low_idx=idx_tensor((g.low for g in gates), torch.int64),
                high_idx=idx_tensor((g.high for g in gates), torch.int64),
                out_x=idx_tensor((g.out_x for g in gates), torch.int64),
                out_y=idx_tensor((g.out_y for g in gates), torch.int64),
                op_idx=idx_tensor((g.opcode_index for g in gates), torch.int32),
                order_limbs=torch.from_numpy(int_to_limbs32(grumpkin.params.n).copy()).to(dev),
                table=ec.window_table(grumpkin.generator(), device=dev),
            )
        if level.ec_pedersen:
            packed["kinds"].append("ec_pedersen")
            packed["ec_pedersen"] = [
                dict(
                    input_idx=idx_tensor(gate.inputs, torch.int64),
                    tables=self._pedersen_tables(gate.domain_separator, len(gate.inputs)),
                    out_x=gate.out_x,
                    out_y=gate.out_y,
                )
                for gate in level.ec_pedersen
            ]
        if level.schnorr:
            self._has_schnorr = True
            groups: Dict[int, list] = {}
            for gate in level.schnorr:
                groups.setdefault(len(gate.message), []).append(gate)
            packed["kinds"].append("schnorr")
            packed["schnorr"] = [
                dict(
                    pub_x=idx_tensor((g.pub_x for g in gates), torch.int64),
                    pub_y=idx_tensor((g.pub_y for g in gates), torch.int64),
                    sig_idx=torch.tensor([g.signature for g in gates], dtype=torch.int64, device=dev),
                    msg_idx=torch.tensor([g.message for g in gates], dtype=torch.int64, device=dev),
                    out_idx=idx_tensor((g.output for g in gates), torch.int64),
                    pedersen_tables=self._pedersen_tables(0, 3),
                    gen_table=ec.window_table(grumpkin.generator(), device=dev),
                )
                for gates in groups.values()
            ]
        if level.ecdsa:
            groups: Dict[str, list] = {}
            for gate in level.ecdsa:
                groups.setdefault(gate.curve, []).append(gate)
            packed["kinds"].append("ecdsa")
            packed["ecdsa"] = [
                dict(
                    curve=curve,
                    op_idx=idx_tensor((g.opcode_index for g in gates), torch.int32),
                    pub_x=torch.tensor([g.pub_x for g in gates], dtype=torch.int64, device=dev),
                    pub_y=torch.tensor([g.pub_y for g in gates], dtype=torch.int64, device=dev),
                    sig=torch.tensor([g.signature for g in gates], dtype=torch.int64, device=dev),
                    msg=torch.tensor([g.hashed_msg for g in gates], dtype=torch.int64, device=dev),
                    out_idx=idx_tensor((g.output for g in gates), torch.int64),
                )
                for curve, gates in groups.items()
            ]
        if level.zero_out:
            packed["kinds"].append("zero_out")
            packed["zero_out"] = idx_tensor(level.zero_out, torch.int64)
        if level.memory:
            packed["kinds"].append("memory")
            packed["memory"] = self._pack_memory(level.memory)
        if level.brillig:
            packed["kinds"].append("brillig")
            packed["brillig"] = self._pack_brillig(level.brillig)
        return packed

    def _pack_hashes(self, gates) -> List[dict]:
        """A level's hash gadgets grouped by (kind, message length): each
        group is one launch, its message bytes the planner's (witness, limb,
        shift) tables."""
        groups: Dict[tuple, list] = {}
        for gate in gates:
            groups.setdefault((gate.kind, len(gate.byte_src)), []).append(gate)
        dev = self.device

        def as_tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

        packs = []
        for (kind, M), group in groups.items():
            src = np.asarray([gate.byte_src for gate in group], dtype=np.int64).reshape(len(group), M, 3)
            packs.append(dict(
                kind=kind,
                src_w=as_tensor(src[..., 0]),
                src_limb=as_tensor(src[..., 1]),
                src_shift=as_tensor(src[..., 2]),
                out_idx=as_tensor([gate.outputs for gate in group]),
                size_w=torch.tensor([0 if gate.size_witness is None else gate.size_witness
                                     for gate in group], dtype=torch.int64, device=dev),
                op_idx=torch.tensor([gate.opcode_index for gate in group], dtype=torch.int32,
                                    device=dev),
            ))
        return packs

    def _pack_memory(self, stages) -> List[dict]:
        """A level's memory stages: each MemoryInit alone, the opcodes in
        groups that share a block size, whether they have a witness to read
        into and whether they have a value to write.  The planner puts at most
        one opcode a block in a level (`mem_level`), so a group's opcodes
        touch distinct blocks and may run in any order."""
        dev = self.device
        one = ExprPlan([], [], [], [], 1)  # a missing predicate is 1
        packs, groups = [], {}
        for st in stages:
            size, k = self.memory_slots[st.block_id]
            if isinstance(st, MemoryInitStage):
                packs.append(dict(kind="init", size=size, k=k, init_idx=torch.tensor(
                    st.init, dtype=torch.int64, device=dev)))
                continue
            key = (size, st.read_into is None, st.write_value is None)
            groups.setdefault(key if self.group_stages else key + (st.opcode_index,), []).append(st)
        for (size, no_read, no_value, *_), ops_ in groups.items():
            static = {op.is_read for op in ops_ if op.op_sel is None}
            runtime = any(op.op_sel is not None for op in ops_)
            sel = None
            if runtime or len(static) > 1:
                # 0 reads, anything else writes; a static opcode's selector is
                # the constant its operation was.
                sel = _pack_to_device(pack_exprs([
                    op.op_sel if op.op_sel is not None else ExprPlan([], [], [], [], int(not op.is_read))
                    for op in ops_]), dev)
            packs.append(dict(
                kind="op", size=size,
                k=torch.tensor([self.memory_slots[op.block_id][1] for op in ops_],
                               dtype=torch.int64, device=dev),
                index=_pack_to_device(pack_exprs([op.index for op in ops_]), dev),
                pred=_pack_to_device(pack_exprs([op.predicate or one for op in ops_]), dev),
                sel=sel, is_read=sel is None and static == {True},
                read_w=None if no_read else torch.tensor(
                    [op.read_into for op in ops_], dtype=torch.int64, device=dev),
                value=None if no_value else _pack_to_device(
                    pack_exprs([op.write_value for op in ops_]), dev),
                may_write=runtime or False in static,
                op_idx=torch.tensor([op.opcode_index for op in ops_], dtype=torch.int32, device=dev),
            ))
        return packs

    def _pack_brillig(self, stages) -> List[dict]:
        """A level's Brillig blocks, grouped by bytecode, input kinds, output
        registers and the presence of a predicate: each group is traced once
        (its Const values are the bytecode's, the same for every block)."""
        dev = self.device
        groups: Dict[tuple, list] = {}
        for st in stages:
            if st.output_array or any(kind != "single" for kind, _ in st.inputs):
                raise NotImplementedError(
                    f"BatchSolver: the Brillig block at opcode {st.opcode_index} has "
                    "array inputs or outputs, which the trace does not run (the JAX "
                    "package's trace leaves its array outputs unwritten); plan with "
                    "device_brillig_trace=False to run it as a host stage on the "
                    "device Brillig VM"
                )
            key = (tuple(st.bytecode), len(st.inputs),
                   tuple(reg for reg, _ in st.output_simple), st.predicate is not None)
            groups.setdefault(key if self.group_stages else key + (st.opcode_index,), []).append(st)
        packs = []
        for (bytecode, n_inputs, out_regs, has_pred, *_), members in groups.items():
            try:
                program = resolve_brillig(self.ctx, bytecode, n_inputs, out_regs)
            except BrilligTraceError as err:
                raise NotImplementedError(
                    f"BatchSolver: the Brillig block at opcode {members[0].opcode_index} "
                    f"cannot be traced ({err}); plan with device_brillig_trace=False "
                    "to run it as a host stage"
                ) from None
            packs.append(dict(
                program=program,
                inputs=[_pack_to_device(pack_exprs([st.inputs[j][1] for st in members]), dev)
                        for j in range(n_inputs)],
                pred=_pack_to_device(pack_exprs([st.predicate for st in members]), dev)
                if has_pred else None,
                out_idx=[torch.tensor([st.output_simple[o][1] for st in members],
                                      dtype=torch.int64, device=dev)
                         for o in range(len(out_regs))],
            ))
        return packs

    def _pedersen_tables(self, domain: int, count: int) -> torch.Tensor:
        """(count, W, 16, 3, 8) window tables of generators 0..count-1 of a
        domain, on the device; the points they were built from are kept for
        :meth:`_check_generators`."""
        points = [derive_generator(domain, i) for i in range(count)]
        for i, point in enumerate(points):
            self._generators[(domain, i)] = tuple(point)
        return torch.stack([ec.window_table(pt, device=self.device) for pt in points])

    def _check_generators(self) -> None:
        """The device tables are baked at construction.  If the host code
        would now use other generators (``set_external_generators``) or a
        challenge hook, this solver's results would silently differ from it:
        refuse instead."""
        stale = [key for key, point in self._generators.items()
                 if tuple(derive_generator(*key)) != point]
        if stale:
            raise RuntimeError(
                f"BatchSolver: the Pedersen generators {sorted(stale)} (domain, "
                "index) changed after this solver built its device tables; "
                "rebuild the plan and the solver"
            )
        if self._has_schnorr and schnorr_challenge_hook() is not None:
            raise RuntimeError(
                "BatchSolver: a Schnorr challenge hook was set after this solver "
                "planned its SchnorrVerify gates for the device; rebuild the plan "
                "and the solver"
            )

    def _build_segments(self) -> List[_Segment]:
        """A level with host stages closes a segment: its device levels run,
        then its host stages.  (The JAX package also closes a segment every
        ``max_levels_per_segment`` levels, to bound the size of a jitted
        program; eager PyTorch compiles nothing, so there is no such bound
        here.)"""
        segments: List[_Segment] = []
        current = _Segment(levels=[], host_stages=[], units=[])
        for level in self.plan.levels:
            current.levels.append(self._pack_level(level))
            current.units.append(level_units(level))
            if level.host:
                current.host_stages = list(level.host)
                current.units.append(host_units(current.host_stages, self.plan.circuit,
                                                self.plan.params.modulus))
                segments.append(current)
                current = _Segment(levels=[], host_stages=[], units=[])
        if current.levels:
            segments.append(current)
        return segments

    def step_units(self) -> List[Counter]:
        """The work of each step of a solve, in the order it runs them: the
        inputs' upload (:meth:`initial_state`), then each segment's device
        levels and its host stages (:meth:`run_segments`)."""
        return [Counter({"inputs": len(self.plan.input_witnesses)})] + [
            u for segment in self.segments for u in segment.units]

    def temp_rows(self) -> float:
        """Rows of one instance's limbs (32 bytes an instance) that the
        largest step of a solve allocates beside the state
        (:data:`TEMP_ROWS_PER_UNIT`, :data:`STEP_BASE_ROWS`)."""
        return STEP_BASE_ROWS + max(sum(TEMP_ROWS_PER_UNIT[k] * n for k, n in u.items())
                                    for u in self.step_units())

    def pass_bytes(self, B: int) -> int:
        """Device bytes of a pass of B instances at its peak: the state
        (:meth:`panel_bytes`) and the largest step's temporaries."""
        return self.panel_bytes(B) + int(self.temp_rows() * B * LIMBS * 4)

    # -- device execution ---------------------------------------------------
    def _run_level(self, W, ok, fail, mem, packed):
        ctx = self.ctx
        for kind in packed["kinds"]:
            if kind == "arith_static":
                W, ok = run_arith_solve_static(ctx, W, ok, packed[kind])
            elif kind == "arith_dyn":
                W, ok, fail = run_arith_solve_dyn(ctx, W, ok, fail, packed[kind], self.dot_kernel)
            elif kind == "arith_check":
                W, ok, fail = run_arith_check(ctx, W, ok, fail, packed[kind], self.dot_kernel)
            elif kind == "range":
                W, ok, fail = run_range(ctx, W, ok, fail, packed[kind])
            elif kind in ("and", "xor"):
                W, ok = run_logic(ctx, W, ok, packed[kind], kind == "xor")
            elif kind == "quotient":
                W, ok = run_quotient(ctx, W, ok, packed[kind], self.dot_kernel)
            elif kind == "to_le_radix":
                W, ok, fail = run_to_le_radix(ctx, W, ok, fail, packed[kind], self.dot_kernel)
            elif kind == "hashes":
                for group_buf in packed[kind]:
                    W, ok, fail = run_hashes(ctx, W, ok, fail, group_buf)
            elif kind == "ec_fixed_base":
                W, ok, fail = run_ec_fixed_base(ctx, W, ok, fail, packed[kind])
            elif kind == "ec_pedersen":
                for gate_buf in packed[kind]:
                    W, ok = run_ec_pedersen(ctx, W, ok, gate_buf)
            elif kind == "schnorr":
                for group_buf in packed[kind]:
                    W, ok = run_schnorr(ctx, W, ok, group_buf)
            elif kind == "ecdsa":
                for group_buf in packed[kind]:
                    W, ok, fail = run_ecdsa(W, ok, fail, group_buf)
            elif kind == "zero_out":
                W.index_fill_(0, packed[kind], 0)
            elif kind == "memory":
                for buf in packed[kind]:
                    if buf["kind"] == "init":
                        run_memory_init(W, mem[buf["size"]], buf)
                    else:
                        W, ok, fail = run_memory_ops(ctx, W, ok, fail, mem[buf["size"]], buf,
                                                     self.dot_kernel)
            elif kind == "brillig":
                for buf in packed[kind]:
                    W, ok = run_brillig(ctx, W, ok, buf, self.dot_kernel)
            else:
                raise AssertionError(kind)
        return W, ok, fail

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_segments(self, state, stats: Optional[SolveStats] = None):
        """Run every segment over a device state ``(W, ok, fail, mem)``: its
        device levels, then its host stages.  The panel and the memory blocks
        are updated in place.  Only a host stage waits for the device (it
        reads witnesses); with ``stats`` each segment's device levels also end
        in a synchronize, so that their time is the device's."""
        for segment in self.segments:
            state = self._run_segment_levels(segment, state, stats)
            state = self._run_segment_host(segment, state, stats)
        return state

    def _run_segment_levels(self, segment: _Segment, state, stats: Optional[SolveStats] = None):
        W, ok, fail, mem = state
        if segment.levels:
            with Timer() as t_seg:
                for packed in segment.levels:
                    W, ok, fail = self._run_level(W, ok, fail, mem, packed)
                if stats is not None:
                    self._sync()
            if stats is not None:
                stats.segment_seconds.append(t_seg.elapsed)
        return W, ok, fail, mem

    def _run_segment_host(self, segment: _Segment, state, stats: Optional[SolveStats] = None):
        W, ok, fail, mem = state
        if segment.host_stages:
            with Timer() as t_host:
                W, ok, fail = self._run_host_stages(W, ok, fail, segment.host_stages, stats)
            if stats is not None:
                stats.host_stage_seconds.append(t_host.elapsed)
        return W, ok, fail, mem

    # -- host stages ---------------------------------------------------------
    def _run_host_stages(self, W, ok, fail, stages: List[HostStage],
                         stats: Optional[SolveStats] = None):
        """Run one segment's host stages over the ``(NW, B, 8)`` panel.

        The columns the stages read (``stage.reads``, else ``known_before``)
        come off the device in one ``index_select`` and one copy and become
        (B,) object arrays of Python ints, shared by the stages in order (a
        later stage reads an earlier one's writes).  Each opcode runs batched
        over the instances where :mod:`.host_batch` has a route, else
        instance by instance through the sequential solvers; the writes go
        back in one ``index_copy_``, with ``ok`` and ``fail``."""
        dev = W.device
        B = W.shape[1]
        p = self.plan.params.modulus
        ok_np = ok.cpu().numpy().copy()
        fail_np = fail.cpu().numpy().copy()

        # Only the witnesses the stages' opcodes read: known_before (every
        # witness known at earlier levels) can be nearly the whole panel.
        needed, writes = set(), set()
        for stage in stages:
            needed.update(stage.reads if stage.reads else stage.known_before)
            writes.update(stage.writes)
        cols = sorted(needed)
        sel = W.index_select(0, torch.tensor(cols, dtype=torch.int64, device=dev))
        ints = host_batch.limb_cols_to_object(sel.cpu().numpy())
        col_arrays: Dict[int, np.ndarray] = {w: ints[:, i] for i, w in enumerate(cols)}

        def get_col(w: int) -> np.ndarray:
            return col_arrays[int(w)]

        write_cols = sorted(writes)
        wpos = {w: i for i, w in enumerate(write_cols)}
        out_vals = np.zeros((B, len(write_cols)), dtype=object)

        def store_writes(values: Dict[int, np.ndarray]) -> None:
            for w, arr in values.items():
                col_arrays[w] = arr
                out_vals[:, wpos[w]] = arr

        def run_batched(opcode, op_index: int) -> bool:
            """The opcode over every instance at once, if host_batch has a
            route for it; False where it has none."""
            if isinstance(opcode, ops.OpcodeBrillig):
                if host_batch.brillig_batchable(opcode.brillig):
                    store_writes(host_batch.run_brillig_batch(opcode.brillig, get_col, B, p))
                    return True
                if not host_batch.device_vm_eligible(opcode.brillig):
                    return False
                values, trapped = run_brillig_vm_batch(opcode.brillig, get_col, B, p, dev)
                store_writes(values)
                ok_np[trapped] = False
                fail_np[trapped] = np.minimum(fail_np[trapped], np.int32(op_index))
                return True
            if isinstance(opcode, ops.OpcodeDirective):
                directive = opcode.directive
                if isinstance(directive, ops.DirPermutationSort):
                    store_writes(host_batch.run_permutation_sort_batch(directive, get_col, B, p))
                    return True
                if isinstance(directive, ops.DirToLeRadix):
                    values, bad = host_batch.run_to_le_radix_batch(directive, get_col, B, p)
                    store_writes(values)
                    ok_np[bad] = False
                    fail_np[bad] = np.minimum(fail_np[bad], np.int32(op_index))
                    return True
            return False

        for stage in stages:
            for op_index in stage.opcode_indices:
                opcode = self.plan.circuit.opcodes[op_index]
                if self.host_batch:
                    try:
                        if run_batched(opcode, op_index):
                            continue
                    except host_batch.HostBatchFallback:
                        pass
                self._run_stage_per_instance(stage, op_index, opcode, col_arrays, out_vals,
                                             wpos, ok_np, fail_np)
                if stats is not None:
                    stats.host_per_instance_stages += 1

        if write_cols:
            limbs = torch.from_numpy(host_batch.cols_to_limbs(out_vals.T, p)).to(dev)
            W.index_copy_(0, torch.tensor(write_cols, dtype=torch.int64, device=dev), limbs)
        return W, torch.from_numpy(ok_np).to(dev), torch.from_numpy(fail_np).to(dev)

    def _run_stage_per_instance(self, stage, op_index, opcode, col_arrays, out_vals, wpos,
                                ok_np, fail_np) -> None:
        """One host-stage opcode through the sequential solvers, instance by
        instance (bit-exact with ``pwg.ACVM``).  An instance whose opcode
        cannot be solved fails at it and gets zeros for what it did not
        write."""
        B = out_vals.shape[0]
        # Reads only: pre-inserting a write column would turn the solver's
        # own output insert into a spurious UnsatisfiedConstrain conflict.
        stage_cols = sorted(
            set(stage.reads if stage.reads else stage.known_before) - set(stage.writes)
        )
        for b in range(B):
            wm = WitnessMap()
            for w in stage_cols:
                if w in col_arrays:
                    wm.insert(Witness(w), FieldElement(int(col_arrays[w][b])))
            try:
                if isinstance(opcode, ops.OpcodeBlackBoxFuncCall):
                    bb_dispatch.solve(self.backend, wm, opcode.call)
                elif isinstance(opcode, ops.OpcodeDirective):
                    solve_directives(wm, opcode.directive)
                elif isinstance(opcode, ops.OpcodeBrillig):
                    self._solve_brillig_instance(wm, opcode.brillig, op_index)
                else:
                    raise AssertionError(opcode)
            except OpcodeResolutionError:
                ok_np[b] = False
                fail_np[b] = min(fail_np[b], op_index)
            for w in stage.writes:
                value = wm.get(Witness(w))
                v = int(value) if value is not None else 0
                out_vals[b, wpos[w]] = v
                if w not in col_arrays:
                    col_arrays[w] = np.zeros(B, dtype=object)
                col_arrays[w][b] = v

    def _solve_brillig_instance(self, wm: WitnessMap, brillig, op_index: int) -> None:
        """One instance of a Brillig block, answering its foreign calls with
        the handler.  The replay list is the instance's own: results of one
        instance must not leak into the next (the reference consumes opcodes
        per execution, pwg/mod.rs:139-152)."""
        replay = list(brillig.foreign_call_results)
        wait = BrilligSolver.solve(wm, brillig, self.backend, op_index, replay)
        while wait is not None:
            if self.foreign_call_handler is None:
                raise OpcodeResolutionError("foreign call requires a handler in batched mode")
            inputs = [[v.to_field() for v in group] for group in wait.inputs]
            replay.append(_decode_foreign_call_result(
                self.foreign_call_handler(wait.function, inputs)))
            wait = BrilligSolver.solve(wm, brillig, self.backend, op_index, replay)

    # -- public API ----------------------------------------------------------
    def initial_state(self, input_values):
        """Build (W, ok, fail, mem) from any input form :meth:`solve` takes.
        ``fail`` starts at the FAIL_NONE sentinel and tracks the first failing
        opcode index per instance; ``mem`` maps a block size to the zeroed
        ``(K, size, B, 8)`` stack of the K memory blocks of that size."""
        B, kwargs = self._pack_host(input_values)
        return self._finish_initial_state(B, **kwargs)

    def _pack_host(self, input_values):
        """The pure-host half of :meth:`initial_state`: normalize the inputs
        into dense numpy buffers WITHOUT touching the device.  Returns
        (B, kwargs-for-_finish_initial_state).  The two narrow forms (the
        packed matrix, and byte or 16-bit columns already on the device) are
        only checked and sorted here: their values go to limb 0 of the panel
        in :meth:`_finish_initial_state`."""
        p = self.plan.params.modulus
        if isinstance(input_values, tuple) and len(input_values) == 2:
            # Packed-matrix form: (witness_indices, (B, K) uint8/uint16
            # matrix), a numpy array or a tensor on the solver's device.
            # Column k assigns witness_indices[k].  Each value is written
            # whole into limb 0, so wider dtypes (or duplicate columns, whose
            # scatter order would be undefined) are refused, not corrupted.
            cols_list, vals2d = input_values
            if isinstance(vals2d, torch.Tensor):
                self._check_on_device(vals2d, "packed-matrix inputs")
                narrow_dtype = vals2d.dtype in (torch.uint8, torch.uint16)
            else:
                vals2d = np.asarray(vals2d)
                narrow_dtype = vals2d.dtype in (np.dtype(np.uint8), np.dtype(np.uint16))
            if not narrow_dtype:
                raise ValueError(
                    "packed-matrix inputs must be uint8/uint16 (values are "
                    f"written to a single limb); got {vals2d.dtype}"
                )
            if isinstance(vals2d, torch.Tensor):
                vals2d = _widen_narrow(vals2d)
            cols_arr = np.fromiter((int(w) for w in cols_list), np.int64, len(cols_list))
            if vals2d.ndim != 2 or vals2d.shape[1] != len(cols_arr):
                raise ValueError(
                    f"packed-matrix inputs: a ({len(cols_arr)} columns) matrix "
                    f"is needed, got shape {tuple(vals2d.shape)}"
                )
            if len(np.unique(cols_arr)) != len(cols_arr):
                raise ValueError("packed-matrix inputs contain duplicate witness indices")
            order = np.argsort(cols_arr, kind="stable")
            if not (order == np.arange(len(order))).all():
                cols_arr = cols_arr[order]
                if isinstance(vals2d, torch.Tensor):
                    vals2d = vals2d[:, torch.from_numpy(order).to(vals2d.device)]
                else:
                    vals2d = vals2d[:, order]
            return int(vals2d.shape[0]), dict(cols=cols_arr, narrow=vals2d)
        if isinstance(input_values, dict):
            # Columnar form: {witness_index: (B,) array-like}.  Numeric arrays
            # must hold values < 2^64 (reduced); object arrays take the
            # arbitrary-precision path.  Tensors on the solver's device
            # (produced by an upstream pipeline there): uint8/uint16 columns
            # are stacked and scattered on the device with no host round
            # trip; other dtypes come to the host and take the columnar path.
            tensors = [a for a in input_values.values() if isinstance(a, torch.Tensor)]
            for a in tensors:
                self._check_on_device(a, "tensor input columns")
            if tensors and len(tensors) == len(input_values) and all(
                    a.dtype in (torch.uint8, torch.uint16) for a in tensors):
                items = sorted((int(w), a) for w, a in input_values.items())
                B = int(items[0][1].shape[0])
                for w, a in items:
                    if tuple(a.shape) != (B,):
                        raise ValueError(f"columnar input {w}: shape {tuple(a.shape)} != ({B},)")
                vals2d = torch.stack([_widen_narrow(a) for _, a in items], dim=1)
                cols_arr = np.fromiter((w for w, _ in items), np.int64, len(items))
                return B, dict(cols=cols_arr, narrow=vals2d)
            items = sorted(
                (int(w), a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
                for w, a in input_values.items()
            )
            B = len(items[0][1]) if items else 0
            cols = np.asarray([w for w, _ in items], np.int64)
            vals = np.zeros((B, len(items), LIMBS), dtype=np.uint32)
            for k, (w, arr) in enumerate(items):
                if arr.shape != (B,):
                    raise ValueError(
                        f"columnar input {w}: shape {arr.shape} != ({B},)"
                    )
                if arr.dtype == object or (
                    arr.dtype.kind == "i" and (arr < 0).any()
                ):
                    # Arbitrary precision, and negatives reduce mod p.
                    vals[:, k, :] = ints_to_limbs32(int(v) % p for v in arr).view(
                        np.uint32
                    )
                else:
                    v64 = arr.astype(np.uint64)
                    vals[:, k, 0] = v64 & np.uint64(0xFFFFFFFF)
                    vals[:, k, 1] = v64 >> np.uint64(32)
            return B, dict(cols=cols, vals=vals)
        B = len(input_values)
        keys0 = tuple(sorted(input_values[0])) if B else ()
        uniform = all(tuple(sorted(d)) == keys0 for d in input_values)
        if B and keys0 and uniform:
            cols = np.fromiter((int(k) for k in keys0), np.int64, len(keys0))
            vals = ints_to_limbs32(
                int(d[k]) % p for d in input_values for k in keys0
            ).view(np.uint32).reshape(B, len(keys0), LIMBS)
            return B, dict(cols=cols, vals=vals)
        # Non-uniform dicts: each (witness, instance) pair given and its
        # value, scattered into a zero panel on the device, so the upload is
        # the inputs' size, not the panel's.
        pairs = [(int(w), b, v) for b, d in enumerate(input_values) for w, v in d.items()]
        at = np.asarray([(w, b) for w, b, _ in pairs], np.int64).reshape(len(pairs), 2)
        if len(at) and not 0 <= at[:, 0].min() <= at[:, 0].max() < self.plan.num_witnesses:
            raise IndexError(
                f"input witness out of range: the circuit has {self.plan.num_witnesses} witnesses")
        vals = ints_to_limbs32(int(v) % p for _, _, v in pairs).view(np.uint32).reshape(
            len(pairs), LIMBS)
        return B, dict(at=at, vals=vals)

    def panel_bytes(self, B: int) -> int:
        """Device bytes of a batch's state: the witness panel and the memory
        blocks."""
        rows = self.plan.num_witnesses + sum(max(size, 1) * k for size, k in self._memory_counts.items())
        return rows * B * LIMBS * 4

    def _check_on_device(self, t: torch.Tensor, what: str) -> None:
        want = self.device
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        if t.device != want:
            raise ValueError(
                f"BatchSolver: {what} must lie on the solver's device "
                f"({self.device}), not {t.device}"
            )

    def _finish_initial_state(self, B: int, cols=None, vals=None, narrow=None, at=None):
        """Assemble the device state.  Input columns (cols, vals) and
        per-pair values (at, vals: (witness, instance) rows) are uploaded as
        they are and scattered into a zero panel ON DEVICE, so the upload is
        the inputs' size, not the panel's; a narrow (B, K) matrix
        (uint8/uint16 values, numpy or on the device) is uploaded in its own
        dtype and scattered into limb 0.  Each array may already lie on the
        device (:meth:`_upload`)."""
        dev = self.device
        nw = self.plan.num_witnesses
        Wd = torch.zeros((nw, B, LIMBS), dtype=torch.int32, device=dev)
        if at is not None:
            if len(at):
                idx = self._to_device(at)
                Wd[idx[:, 0], idx[:, 1]] = self._to_device(vals)
        elif narrow is not None:
            if len(cols):
                v = _widen_narrow(self._to_device(narrow))  # (B, K) int32
                Wd[:, :, 0].index_copy_(0, self._to_device(cols), v.t())
        elif cols is not None and len(cols):
            v = self._to_device(vals)
            Wd.index_copy_(0, self._to_device(cols), v.permute(1, 0, 2).contiguous())
        ok = torch.ones((B,), dtype=torch.bool, device=dev)
        fail = torch.full((B,), int(FAIL_NONE), dtype=torch.int32, device=dev)
        # A block of size 0 keeps one row, so that its gathers have a target.
        mem = {size: torch.zeros((k, max(size, 1), B, LIMBS), dtype=torch.int32, device=dev)
               for size, k in self._memory_counts.items()}
        return Wd, ok, fail, mem

    def _to_device(self, a) -> torch.Tensor:
        """A packed host array (uint32 limbs are read as int32; uint8 and
        uint16 keep their dtype) or a tensor, on the solver's device."""
        if isinstance(a, np.ndarray):
            a = np.ascontiguousarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            a = torch.from_numpy(a)
        return a.to(self.device)

    def _pack_pinned(self, input_values):
        """:meth:`_pack_host`, its packed host arrays (values and the indices
        they are scattered to) then copied into pinned host memory (on the prefetch thread, beside the pass being solved),
        ready for :meth:`_upload`."""
        B, kwargs = self._pack_host(input_values)
        for key in _UPLOADED:
            a = kwargs.get(key)
            if isinstance(a, np.ndarray):
                a = np.ascontiguousarray(a)
                kwargs[key] = torch.from_numpy(
                    a.view(np.int32) if a.dtype == np.uint32 else a).pin_memory()
        return B, kwargs

    def _upload(self, kwargs: dict, stream) -> dict:
        """Start the upload of a pass's pinned host tensors
        (:meth:`_pack_pinned`) on ``stream`` with ``non_blocking`` copies,
        so that they ride beside the pass the default stream is solving.  The
        caller makes its stream wait for ``stream`` before they are read."""
        out = dict(kwargs)
        for key in _UPLOADED:
            host = out.get(key)
            if not (isinstance(host, torch.Tensor) and host.is_pinned()):
                continue
            with torch.cuda.stream(stream):
                d = host.to(self.device, non_blocking=True)
            # Read on the default stream: the allocator must not hand its
            # block to the copy stream again before those reads are done.
            d.record_stream(torch.cuda.current_stream(self.device))
            out[key] = d
        return out

    def _free_device_bytes(self) -> int:
        """Device bytes a new allocation can take: the memory CUDA reports free
        and what the caching allocator holds unused."""
        free, _ = torch.cuda.mem_get_info(self.device)
        return free + torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)

    def max_batch_per_pass(self) -> Optional[int]:
        """The most instances one pass solves (None: no limit).  The
        constructor's ``max_batch_per_pass`` when given; else the largest
        batch whose ``pass_bytes`` times :data:`PASS_PEAK_OVER_ESTIMATE` fits
        ``pass_budget_bytes``, or on a CUDA device the memory free for the
        solve, rounded down to a multiple of 1,024 from 2,048 on.  A larger
        batch is streamed through passes of this size (:meth:`solve`)."""
        if self._pass_limit is not None:
            return self._pass_limit
        budget = self.pass_budget_bytes
        if budget is None:
            if self.device.type != "cuda":
                return None
            budget = self._free_device_bytes()
        limit = int(budget / (PASS_PEAK_OVER_ESTIMATE * max(1, self.pass_bytes(1))))
        if limit >= 2048:
            limit -= limit % 1024
        return max(1, limit)

    @staticmethod
    def _slice_inputs(input_values, lo: int, hi: int):
        if isinstance(input_values, tuple) and len(input_values) == 2:
            return (input_values[0], input_values[1][lo:hi])
        if isinstance(input_values, dict):
            return {w: a[lo:hi] for w, a in input_values.items()}
        return input_values[lo:hi]

    @staticmethod
    def _batch_len(input_values) -> int:
        if isinstance(input_values, tuple) and len(input_values) == 2:
            return int(input_values[1].shape[0])
        if isinstance(input_values, dict):
            if not input_values:
                return 0
            return len(next(iter(input_values.values())))
        return len(input_values)

    def solve_chunks(self, input_values, chunk: Optional[int] = None,
                     stats: Optional[SolveStats] = None):
        """Solve a batch pass by pass, yielding one :class:`BatchResult` a
        pass of ``chunk`` instances (default :meth:`max_batch_per_pass`),
        each with its panel.  A caller that reads each result's panel before
        taking the next keeps one pass's panel on the device; instances are
        independent, so the passes give the bits of one pass."""
        B = self._batch_len(input_values)
        chunk = chunk or self.max_batch_per_pass() or max(B, 1)
        for lo in range(0, B, chunk):
            yield self.solve(self._slice_inputs(input_values, lo, min(lo + chunk, B)),
                             stats=stats)

    def solve(self, input_values, stats: Optional[SolveStats] = None):
        """Solve a batch.  ``input_values`` is one of:

        * a sequence of per-instance ``{witness_index: int}`` dicts;
        * the columnar form ``{witness_index: (B,) array}`` (numpy arrays, or
          tensors on the solver's device: uint8/uint16 ones are scattered on
          the device, others come to the host);
        * the packed-matrix form ``(witness_indices, (B, K) uint8/uint16
          matrix)``, a numpy array or a tensor on the solver's device.

        A batch larger than :meth:`max_batch_per_pass` is streamed through
        passes of that size; the result then carries every instance's ok /
        fail and no panel (:meth:`solve_chunks` yields each pass's panel).
        With ``stats`` (a :class:`SolveStats`) the solve records its passes,
        their packing, each segment's device time and each segment's host
        stages.  Under a mesh the batch is sharded (:meth:`_solve_mesh`).
        Raises ``RuntimeError`` if the Pedersen generators or the Schnorr
        hook changed since construction."""
        self._check_generators()
        if self.mesh is not None:
            return self._solve_mesh(input_values, stats)
        B = self._batch_len(input_values)
        if stats is not None:
            stats.batch = B
            stats.total_ops = self.plan.total_ops()
        limit = self.max_batch_per_pass()
        if limit is not None and B > limit:
            return self._solve_streamed(input_values, B, limit, stats)
        if stats is not None:
            stats.passes += 1
        with Timer() as t_pack:
            state = self.initial_state(input_values)
            if stats is not None:
                self._sync()
        if stats is not None:
            stats.pack_seconds += t_pack.elapsed
        W, ok, fail, mem = self.run_segments(state, stats)
        # ok/fail are tiny (B,) tensors: materialize them now so the solve is
        # synced (and errors surface here); the big W panel stays on device
        # until a caller actually reads witnesses (lazy BatchResult.W).
        return BatchResult(self, W, ok.cpu().numpy(), fail.cpu().numpy(), mem)

    def _solve_mesh(self, input_values, stats: Optional[SolveStats]):
        """A batch sharded over the mesh: entry i takes the contiguous slice
        ``shard_bounds(B, mesh.size)[i]``, packed and solved by the solver of
        its device.  Every shard's inputs are uploaded and its segment's
        device levels queued before any shard's host stages or flags are read
        back, segment by segment; a shard past its solver's
        ``max_batch_per_pass`` is streamed on its own.  A shard of no
        instances solves nothing.  Under a mesh of ranks this process solves
        its own entry's slice and the flags are gathered."""
        from ..parallel.mesh import shard_bounds

        B = self._batch_len(input_values)
        bounds = shard_bounds(B, self.mesh.size)
        if stats is not None:
            stats.batch = B
            stats.total_ops = self.plan.total_ops()
        states, streamed = {}, []
        for i, sub in self._entry_solvers.items():
            lo, hi = bounds[i]
            if hi == lo:
                continue
            part = self._slice_inputs(input_values, lo, hi)
            limit = sub.max_batch_per_pass()
            if limit is not None and hi - lo > limit:
                streamed.append((i, part, hi - lo, limit))
                continue
            with on_device(sub.device), Timer() as t_pack:
                states[i] = sub.initial_state(part)
            if stats is not None:
                stats.passes += 1
                stats.pack_seconds += t_pack.elapsed
        for s in range(len(self.segments)):
            for step in ("_run_segment_levels", "_run_segment_host"):
                for i, state in states.items():
                    sub = self._entry_solvers[i]
                    with on_device(sub.device):
                        states[i] = getattr(sub, step)(sub.segments[s], state, stats)
        results = {}
        for i, part, n, limit in streamed:
            sub = self._entry_solvers[i]
            with on_device(sub.device):
                results[i] = sub._solve_streamed(part, n, limit, stats)
        for i, (W, ok, fail, mem) in states.items():
            results[i] = BatchResult(self._entry_solvers[i], W, ok.cpu().numpy(),
                                     fail.cpu().numpy(), mem)
        return ShardedBatchResult(self, bounds, results)

    def _solve_streamed(self, input_values, B: int, limit: int,
                        stats: Optional[SolveStats]):
        """A batch of more than one pass, as the JAX package streams it:
        pass k + 1's host packing (into pinned memory on a card) runs on a
        prefetch thread while pass k solves, its upload of the packed inputs
        on a second stream once pass k's levels are queued, and pass k's ok /
        fail are read only after pass k + 1's device work is queued behind
        it, so the device does not wait for the host between passes.  One
        panel is live at a time: a pass's state is dropped before the next
        pass allocates its own, which the allocator then builds in the same
        memory, in stream order; the uploads are the inputs' size, whatever
        their form."""
        from concurrent.futures import ThreadPoolExecutor

        bounds = [(lo, min(lo + limit, B)) for lo in range(0, B, limit)]
        n = len(bounds)
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        oks, fails = [], []
        inflight = None  # (ok, fail) of the pass on the device
        with ThreadPoolExecutor(max_workers=1) as pool:
            packs = {}

            def prefetch(k: int) -> None:
                if k < n and k not in packs:
                    packs[k] = pool.submit(
                        self._pack_pinned if cuda else self._pack_host,
                        self._slice_inputs(input_values, *bounds[k]))

            def stage(k: int):
                """Wait for pass k's packing, start pass k + 1's, and start
                pass k's upload."""
                Bk, kwargs = packs.pop(k).result()
                prefetch(k + 1)
                if cuda:
                    kwargs = self._upload(kwargs, copy_stream)
                return Bk, kwargs

            prefetch(0)
            with Timer() as t_pack:
                staged = stage(0)
            if stats is not None:
                stats.pack_seconds += t_pack.elapsed
            for k in range(n):
                Bk, kwargs = staged
                if cuda:
                    torch.cuda.current_stream(self.device).wait_stream(copy_stream)
                state = self._finish_initial_state(Bk, **kwargs)
                del staged, kwargs
                W, ok, fail, mem = self.run_segments(state, stats)
                del state, W, mem  # this pass's panel goes back to the allocator
                if stats is not None:
                    stats.passes += 1
                if k + 1 < n:
                    with Timer() as t_pack:
                        staged = stage(k + 1)
                    if stats is not None:
                        stats.pack_seconds += t_pack.elapsed
                if inflight is not None:
                    oks.append(inflight[0].cpu().numpy())
                    fails.append(inflight[1].cpu().numpy())
                inflight = (ok, fail)
                self._log.debug("pass %d of %d: instances %d-%d queued", k + 1, n, *bounds[k])
            oks.append(inflight[0].cpu().numpy())
            fails.append(inflight[1].cpu().numpy())
        return BatchResult(self, None, np.concatenate(oks), np.concatenate(fails))


class BatchResult:
    """Solve result.  The witness panel stays on device until first use:
    ``.W`` materializes a host copy lazily, so callers that only check flags
    (or read a few witnesses) never pay a full-panel device->host transfer."""

    def __init__(self, solver: BatchSolver, W, ok, fail=None, mem=None):
        self.solver = solver
        self._W = W  # (NW, B, 8) int32 tensor
        self._W_host: Optional[np.ndarray] = None
        self._ok = ok
        # First failing opcode index per instance (FAIL_NONE when satisfied).
        self._fail = fail
        self._mem = mem or {}

    def release(self) -> None:
        """Free the witness panel (device and host copies) and the memory
        blocks."""
        self._W = None
        self._W_host = None
        self._mem = {}

    def memory_blocks(self) -> Dict[int, torch.Tensor]:
        """Each memory block's final state: block id -> its ``(size, B, 8)``
        slab on the solver's device."""
        return {block_id: self._mem[size][k, :size]
                for block_id, (size, k) in self.solver.memory_slots.items()}

    @property
    def panel(self) -> torch.Tensor:
        """The (num_witnesses, B, 8) int32 panel on the solver's device."""
        if self._W is None:
            raise RuntimeError(
                "witness panel not retained: released, or a streamed solve, which "
                "keeps only ok / fail (solve_chunks yields each pass's panel)"
            )
        return self._W

    @property
    def W(self) -> np.ndarray:
        """Host copy in the batch-major (B, num_witnesses, 16) uint32 layout
        of 16-bit limbs — the layout the JAX package's result exposes."""
        if self._W_host is None:
            rows = limbs32_to_limbs16(self.panel.cpu().numpy())  # (NW, B, 16)
            self._W_host = np.ascontiguousarray(rows.transpose(1, 0, 2))
        return self._W_host

    @property
    def ok(self) -> np.ndarray:
        return self._ok

    @property
    def fail(self) -> np.ndarray:
        if self._fail is None:
            self._fail = np.where(self.ok, FAIL_NONE, 0).astype(np.int32)
        return self._fail

    def error_location(self, instance: int):
        """OpcodeLocation of the first failing opcode for one instance, or
        None if it solved — mirrors the reference's located errors
        (acvm/src/pwg/mod.rs:282-299)."""
        from ..acir.circuit import OpcodeLocation

        index = int(self.fail[instance])
        if index == int(FAIL_NONE):
            return None
        return OpcodeLocation.acir(index)

    def error_message(self, instance: int) -> Optional[str]:
        """Circuit-embedded assert message for the failing opcode, if any."""
        location = self.error_location(instance)
        if location is None:
            return None
        return self.solver.plan.circuit.get_assert_message(location)

    def witness_ints(self, witness_index: int) -> List[int]:
        # Read ONE witness row off the device instead of the whole panel.
        return limbs32_to_ints(self.panel[witness_index].cpu().numpy())  # (B, 8) row

    def instance_ints(self, instance: int) -> List[int]:
        """Every witness of ONE instance as Python ints (one strided column
        read off the device, not the whole panel)."""
        return limbs32_to_ints(self.panel[:, instance].cpu().numpy())  # (NW, 8) column

    def witness_maps(self) -> List[WitnessMap]:
        """Full per-instance witness maps (for conformance checks)."""
        NW, B, _ = self.panel.shape
        ints = limbs32_to_ints(self._W.cpu().numpy())  # flat, witness-major
        out = []
        for b in range(B):
            wm = WitnessMap()
            for w in range(NW):
                wm.insert(Witness(w), FieldElement(ints[w * B + b]))
            out.append(wm)
        return out


class ShardedBatchResult(BatchResult):
    """The result of a solve over a mesh, read in global instance order.

    ``parts`` maps each mesh entry this process solved to its shard's
    :class:`BatchResult` (entries of no instances have none); ``bounds`` are
    the entries' instance slices.  ``ok`` / ``fail`` are the whole batch's.
    A witness row or an instance column is read from the shards that hold
    it; ``panel`` (and ``W``, ``witness_maps``) joins the shards' panels on
    the solver's device.  Under a mesh of ranks each of these reads is a
    collective over the job (the flags are gathered at construction): every
    rank makes the same reads in the same order, and gets the whole batch's."""

    def __init__(self, solver: BatchSolver, bounds, parts: Dict[int, BatchResult]):
        self.bounds = list(bounds)
        self.parts = parts
        self._distributed = solver.mesh.distributed
        if self._distributed:
            from ..parallel.distributed import all_gather_batch

            (self._entry,) = solver._entry_solvers
            local = parts.get(self._entry)
            ok = torch.from_numpy(local.ok) if local else torch.zeros(0, dtype=torch.bool)
            fail = torch.from_numpy(local.fail) if local else torch.zeros(0, dtype=torch.int32)
            ok = all_gather_batch(ok, self.bounds).cpu().numpy()
            fail = all_gather_batch(fail, self.bounds).cpu().numpy()
        else:
            ordered = [parts[i] for i in sorted(parts)]
            ok = np.concatenate([r.ok for r in ordered]) if ordered else np.zeros(0, bool)
            fail = (np.concatenate([r.fail for r in ordered]) if ordered
                    else np.zeros(0, np.int32))
        super().__init__(solver, None, ok, fail)

    def _local_rows(self, read, empty_shape) -> torch.Tensor:
        """This rank's shard read by ``read`` (an empty tensor of
        ``empty_shape`` where the shard has no instances)."""
        local = self.parts.get(self._entry)
        if local is None:
            return torch.zeros(empty_shape, dtype=torch.int32)
        return read(local)

    def _owner(self, instance: int):
        for i, (lo, hi) in enumerate(self.bounds):
            if lo <= instance < hi:
                return i, instance - lo
        raise IndexError(f"instance {instance} outside the batch of {self.bounds[-1][1]}")

    def release(self) -> None:
        for part in self.parts.values():
            part.release()
        super().release()

    @property
    def panel(self) -> torch.Tensor:
        """The (num_witnesses, B, 8) panel of the whole batch on the solver's
        device: the shards' panels joined (a copy)."""
        if self._W is None:
            NW = self.solver.plan.num_witnesses
            if self._distributed:
                from ..parallel.distributed import all_gather_batch

                local = self._local_rows(lambda r: r.panel, (NW, 0, LIMBS))
                self._W = all_gather_batch(local, self.bounds, dim=1).to(self.solver.device)
            elif self.parts:
                self._W = torch.cat([self.parts[i].panel.to(self.solver.device)
                                     for i in sorted(self.parts)], dim=1)
            else:
                self._W = torch.zeros((NW, 0, LIMBS), dtype=torch.int32, device=self.solver.device)
        return self._W

    def memory_blocks(self) -> Dict[int, torch.Tensor]:
        if self._distributed:
            from ..parallel.distributed import all_gather_batch

            out = {}
            for block_id, (size, _) in sorted(self.solver.memory_slots.items()):
                local = self._local_rows(lambda r: r.memory_blocks()[block_id], (size, 0, LIMBS))
                out[block_id] = all_gather_batch(local, self.bounds, dim=1).to(self.solver.device)
            return out
        blocks = [self.parts[i].memory_blocks() for i in sorted(self.parts)]
        return {block_id: torch.cat([b[block_id].to(self.solver.device) for b in blocks], dim=1)
                for block_id in self.solver.memory_slots} if blocks else {}

    def witness_ints(self, witness_index: int) -> List[int]:
        if self._distributed:
            from ..parallel.distributed import all_gather_batch

            local = self._local_rows(lambda r: r.panel[witness_index], (0, LIMBS))
            return limbs32_to_ints(all_gather_batch(local, self.bounds).cpu().numpy())
        return [v for i in sorted(self.parts) for v in self.parts[i].witness_ints(witness_index)]

    def instance_ints(self, instance: int) -> List[int]:
        entry, k = self._owner(instance)
        if self._distributed:
            from ..parallel.distributed import broadcast_from

            mine = self.parts[entry].panel[:, k] if entry == self._entry else None
            col = broadcast_from(mine, (self.solver.plan.num_witnesses, LIMBS), torch.int32,
                                 self.solver.mesh.ranks[entry])
            return limbs32_to_ints(col.cpu().numpy())
        return self.parts[entry].instance_ints(k)
