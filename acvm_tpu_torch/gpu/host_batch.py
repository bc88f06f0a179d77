"""Vectorized host-stage execution across instances.

Host stages (`planner.HostStage`) cover opcodes whose semantics are
data-dependent on the host side: branchy Brillig, general-radix ToLeRadix,
permutation sorts, foreign calls.  The baseline executor replays the bit-exact
sequential solvers (:mod:`acvm_tpu_torch.pwg`) per instance — a 10k-instance
batch hitting one Brillig hint means 10k interpreter runs.

This module batches the dominant stage kinds across the whole instance axis
using NumPy *object* arrays of exact Python ints (one vectorized C-level loop
per VM instruction instead of a full interpreter per instance):

* **straight-line Brillig** — bytecode restricted to Const / Mov /
  BinaryFieldOp / BinaryIntOp / Stop with Single inputs and Simple outputs
  (the stdlib hint-block shape, stdlib/src/blackbox_fallbacks/uint.rs):
  registers become (B,) object arrays; semantics mirror
  `brillig_vm.vm.evaluate_binary_{field,int}_op` exactly (two's-complement
  signed div, shift clamping, zero-maps-to-zero field inverse).
* **general-radix ToLeRadix** — digit extraction as vectorized divmods with
  the reference's too-many-digits failure per instance
  (acvm/src/pwg/directives/mod.rs:60-87).
* **PermutationSort** — tuple-expression evaluation batched as object-array
  ops; the stable sort + routing network run per instance on plain ints
  (acvm/src/pwg/directives/mod.rs:88-120).

Branchy bytecode of the 13 control and data opcodes (:func:`device_vm_eligible`)
runs on the batched device VM (:mod:`acvm_tpu_torch.gpu.brillig_vm_device`).
Anything else (foreign calls, black-box ops inside Brillig, every stage that
raises :class:`HostBatchFallback`) runs on the per-instance sequential solvers
in `BatchSolver._run_host_stages`; ``BatchSolver(..., host_batch=False)`` sends
every stage there (conformance bisection).  The two column bridges between the
``(C, B, 8)`` limb panel and (B,) object columns live here too.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import brillig as br
from ..acir import opcodes as ops
from ..acir.expression import Expression
from ..fields.kernels import LIMBS, ints_to_limbs32, limbs32_to_ints

_BATCH_OPS = (
    br.OpConst,
    br.OpMov,
    br.OpBinaryFieldOp,
    br.OpBinaryIntOp,
    br.OpStop,
)


class HostBatchFallback(Exception):
    """Raised when a stage must run on the per-instance path after all
    (e.g. an unsigned division hit a zero divisor in some instance)."""


def brillig_batchable(brillig: ops.Brillig) -> bool:
    """Straight-line hint blocks we can execute across the batch at once."""
    if brillig.foreign_call_results:
        return False
    if not all(isinstance(o, _BATCH_OPS) for o in brillig.bytecode):
        return False
    if not all(isinstance(i, ops.BrilligInputSingle) for i in brillig.inputs):
        return False
    return all(
        isinstance(o, ops.BrilligOutputSimple) for o in brillig.outputs
    )


# The opcodes the batched device VM runs (Brillig's control and data opcodes:
# no ForeignCall, whose replay needs the host, and no BlackBox), and its static
# bound on register indices (`brillig_vm_device.MAX_REGISTERS`).
_DEVICE_VM_OPS = (
    br.OpBinaryFieldOp,
    br.OpBinaryIntOp,
    br.OpJump,
    br.OpJumpIf,
    br.OpJumpIfNot,
    br.OpCall,
    br.OpReturn,
    br.OpConst,
    br.OpMov,
    br.OpLoad,
    br.OpStore,
    br.OpTrap,
    br.OpStop,
)
DEVICE_VM_MAX_REGISTERS = 512


def device_vm_eligible(brillig: ops.Brillig) -> bool:
    """Bytecode the batched device VM runs: the 13 control/data opcodes (no
    ForeignCall and no BlackBox), with statically-bounded register usage."""
    if brillig.foreign_call_results:
        return False
    max_reg = 0
    for op in brillig.bytecode:
        if not isinstance(op, _DEVICE_VM_OPS):
            return False
        for attr in ("destination", "lhs", "rhs", "source", "condition",
                     "source_pointer", "destination_pointer"):
            reg = getattr(op, attr, None)
            if reg is not None:
                max_reg = max(max_reg, int(reg))
    return max_reg + len(brillig.inputs) + len(brillig.outputs) < DEVICE_VM_MAX_REGISTERS


GetCol = Callable[[int], np.ndarray]  # witness index -> (B,) object ints


def limb_cols_to_object(sel: np.ndarray) -> np.ndarray:
    """(C, B, 8) int32 limb columns -> (B, C) object Python ints.

    Host stages do arbitrary-precision math on object arrays.  Columns below
    2^64 (limbs 2-7 zero: the byte and integer hint inputs, the common case)
    compose in vectorized uint64 and box once; a wider column converts through
    bytes, one ``int.from_bytes`` an element, with no loop over its limbs."""
    C, B, _ = sel.shape
    ints = np.zeros((B, C), dtype=object)
    if C == 0:
        return ints
    u = sel.view(np.uint32)
    wide = u[:, :, 2:].any(axis=(1, 2))  # (C,)
    narrow = np.nonzero(~wide)[0]
    if narrow.size:
        v = u[narrow, :, 0].astype(np.uint64) | (u[narrow, :, 1].astype(np.uint64) << np.uint64(32))
        ints[:, narrow] = v.T.astype(object)
    for c in np.nonzero(wide)[0]:
        ints[:, c] = limbs32_to_ints(sel[c])
    return ints


def cols_to_limbs(cols: Sequence[np.ndarray], p: int) -> np.ndarray:
    """(B,) integer columns -> (C, B, 8) int32 limbs of their values mod p
    (p > 2^64).  A column of an unsigned dtype, or an object column whose
    values all lie in [0, 2^64), splits as uint64 (vectorized); any other
    column (a signed dtype, negative or wider values) goes through
    ``int(v) % p`` element by element, so no value wraps."""
    cols = list(cols)
    batch = len(cols[0]) if cols else 0
    limbs = np.zeros((len(cols), batch, LIMBS), dtype=np.uint32)
    for c, col in enumerate(cols):
        v64 = None
        if col.dtype.kind == "u":
            v64 = col.astype(np.uint64)
        elif col.dtype == object and (batch == 0 or min(col) >= 0):
            # numpy may cast a negative int to uint64 by wrapping it, so the
            # fast path takes only non-negative values (and fails above 2^64)
            try:
                v64 = col.astype(np.uint64)
            except (OverflowError, TypeError):
                pass
        if v64 is None:
            limbs[c] = ints_to_limbs32([int(v) % p for v in col]).view(np.uint32)
            continue
        limbs[c, :, 0] = v64 & np.uint64(0xFFFFFFFF)
        limbs[c, :, 1] = v64 >> np.uint64(32)
    return limbs.view(np.int32)


def eval_expr_batch(
    expr: Expression, get_col: GetCol, batch: int, p: int
) -> np.ndarray:
    """(B,) object-int values of a degree-<=2 expression, all terms known."""
    acc = None

    def add(term):
        nonlocal acc
        acc = term if acc is None else acc + term

    for c, wl, wr in expr.mul_terms:
        add(int(c) * get_col(int(wl)) * get_col(int(wr)))
    for c, w in expr.linear_combinations:
        add(int(c) * get_col(int(w)))
    qc = int(expr.q_c)
    if acc is None:
        return np.full(batch, qc % p, dtype=object)
    if qc:
        acc = acc + qc
    return acc % p


def _obj_pow_inv(vals: np.ndarray, p: int) -> np.ndarray:
    """Elementwise modular inverse with 0 -> 0 (generic_ark.rs:242-245)."""
    return np.array(
        [pow(int(v), -1, p) if v else 0 for v in vals], dtype=object
    )


def _binary_field_batch(op: br.BinaryFieldOp, a, b, p: int):
    a = _to_wide(a)
    b = _to_wide(b)
    if op == br.BinaryFieldOp.Add:
        return (a + b) % p
    if op == br.BinaryFieldOp.Sub:
        return (a - b) % p
    if op == br.BinaryFieldOp.Mul:
        return (a * b) % p
    if op == br.BinaryFieldOp.Div:
        return (a * _obj_pow_inv(b, p)) % p
    if op == br.BinaryFieldOp.Equals:
        return (a == b).astype(object) * 1
    raise ValueError(op)


def _minimum_int(arr: np.ndarray, cap: int) -> np.ndarray:
    return np.array([v if v < cap else cap for v in arr], dtype=object)


# --- dual register representation -----------------------------------------
#
# Registers are either (B,) object arrays of exact Python ints ("wide": raw
# field values) or (B,) uint64 arrays ("narrow").  A register is converted
# to narrow only when every instance's value is PROVABLY < 2^32, so a
# narrow array always holds true values, not masked ones — the sequential
# semantics apply raw (unmasked) operands in several places (Shr, SignedDiv,
# _to_signed), so masked conversion would diverge.  Narrow ops run as
# native numpy vector code — that's where the 10x+ over per-instance
# interpretation comes from; the stdlib uint hint blocks are bit_size<=32
# except the 127-bit add/sub staging ops, which take the object path.

_NARROW_BOUND = 1 << 32


def _try_narrow(x: np.ndarray):
    """uint64 view holding the exact values, or None if any >= 2^32."""
    if x.dtype == np.uint64:
        return x
    if bool((x < _NARROW_BOUND).all()):
        return x.astype(np.uint64)
    return None


def _to_wide(x: np.ndarray) -> np.ndarray:
    """uint64 -> object ints (for field ops / output extraction)."""
    if x.dtype == object:
        return x
    return np.array([int(v) for v in x], dtype=object)


def _binary_int_narrow(op: br.BinaryIntOp, a, b, bit_size: int):
    """bit_size <= 32 semantics on uint64 arrays of TRUE values (< 2^32).
    Each line mirrors `evaluate_binary_int_op`'s masking exactly; uint64
    wraparound is harmless for +/-/* because 2^bit_size divides 2^64."""
    modulo = 1 << bit_size
    m = np.uint64(modulo)
    if op == br.BinaryIntOp.Add:
        return (a + b) % m
    if op == br.BinaryIntOp.Sub:
        return (m + a - b) % m
    if op == br.BinaryIntOp.Mul:
        return (a * b) % m  # both < 2^32: product exact in uint64
    if op == br.BinaryIntOp.UnsignedDiv:
        bm = b % m
        if not bm.all():
            raise HostBatchFallback("unsigned division by zero")
        return (a % m) // bm
    if op == br.BinaryIntOp.SignedDiv:
        half = np.uint64(modulo >> 1)
        sa = np.where(a < half, a.astype(np.int64), a.astype(np.int64) - modulo)
        sb = np.where(b < half, b.astype(np.int64), b.astype(np.int64) - modulo)
        aq = np.abs(sa) // np.where(sb == 0, 1, np.abs(sb))  # trunc toward 0
        q = np.where(sb == 0, 0, np.where((sa < 0) != (sb < 0), -aq, aq))
        return (q % modulo).astype(np.uint64)
    if op == br.BinaryIntOp.Equals:
        return ((a % m) == (b % m)).astype(np.uint64)
    if op == br.BinaryIntOp.LessThan:
        return ((a % m) < (b % m)).astype(np.uint64)
    if op == br.BinaryIntOp.LessThanEquals:
        return ((a % m) <= (b % m)).astype(np.uint64)
    if op == br.BinaryIntOp.And:
        return (a & b) % m
    if op == br.BinaryIntOp.Or:
        return (a | b) % m
    if op == br.BinaryIntOp.Xor:
        return (a ^ b) % m
    if op == br.BinaryIntOp.Shl:
        # b >= bit_size always yields 0 mod 2^bit_size, so the clamp is
        # semantics-preserving; a < 2^32 and b <= 32 keep a<<b inside uint64.
        return (a << np.minimum(b, np.uint64(bit_size))) % m
    if op == br.BinaryIntOp.Shr:
        # a < 2^32: any b >= 32 yields 0, so clamping at 63 is exact.
        return (a >> np.minimum(b, np.uint64(63))) % m
    raise ValueError(op)


def _binary_int_batch(op: br.BinaryIntOp, a, b, bit_size: int):
    """Vectorized twin of `evaluate_binary_int_op`
    (brillig_vm/src/arithmetic.rs:23-99).  When both operands provably fit
    32 bits and so does the op, runs the native uint64 path; otherwise
    object ints."""
    if bit_size <= 32:
        na, nb = _try_narrow(a), _try_narrow(b)
        if na is not None and nb is not None:
            return _binary_int_narrow(op, na, nb, bit_size)
    a = _to_wide(a)
    b = _to_wide(b)
    modulo = 1 << bit_size
    if op == br.BinaryIntOp.Add:
        return (a + b) % modulo
    if op == br.BinaryIntOp.Sub:
        return (modulo + a - b) % modulo
    if op == br.BinaryIntOp.Mul:
        return (a * b) % modulo
    if op == br.BinaryIntOp.UnsignedDiv:
        bm = b % modulo
        if any(v == 0 for v in bm):
            raise HostBatchFallback("unsigned division by zero")
        return (a % modulo) // bm
    if op == br.BinaryIntOp.SignedDiv:
        half = modulo >> 1
        out = np.empty(len(a), dtype=object)
        for i in range(len(a)):
            sa = int(a[i]) if a[i] < half else int(a[i]) - modulo
            sb = int(b[i]) if b[i] < half else int(b[i]) - modulo
            q = abs(sa) // abs(sb) if sb != 0 else 0
            if (sa < 0) != (sb < 0):
                q = -q
            out[i] = q % modulo
        return out
    if op == br.BinaryIntOp.Equals:
        return ((a % modulo) == (b % modulo)).astype(object) * 1
    if op == br.BinaryIntOp.LessThan:
        return ((a % modulo) < (b % modulo)).astype(object) * 1
    if op == br.BinaryIntOp.LessThanEquals:
        return ((a % modulo) <= (b % modulo)).astype(object) * 1
    if op == br.BinaryIntOp.And:
        return (a & b) % modulo
    if op == br.BinaryIntOp.Or:
        return (a | b) % modulo
    if op == br.BinaryIntOp.Xor:
        return (a ^ b) % modulo
    if op == br.BinaryIntOp.Shl:
        # (a << b) mod 2^bit_size: any b >= bit_size yields 0 whatever a is,
        # so clamping also guards garbage operands in predicate-masked
        # instances (a huge b would otherwise materialize a huge int).
        return (a << _minimum_int(b, bit_size)) % modulo
    if op == br.BinaryIntOp.Shr:
        # Registers may hold raw field values >= 2^bit_size, so the shift
        # cannot be clamped at bit_size; 260 > 256-bit field width keeps
        # a >> b == 0 for every larger b.
        return (a >> _minimum_int(b, 260)) % modulo
    raise ValueError(op)


def run_brillig_batch(
    brillig: ops.Brillig,
    get_col: GetCol,
    batch: int,
    p: int,
) -> Dict[int, np.ndarray]:
    """Execute a batchable Brillig block for every instance at once.

    Returns {witness: (B,) object ints}.  Semantics mirror
    `BrilligSolver.solve` (acvm/src/pwg/brillig.rs:20-130): predicate == 0
    zeroes the outputs; register file grows on write, reads past the end
    are 0.
    """
    pred = None
    if brillig.predicate is not None:
        pred = eval_expr_batch(brillig.predicate, get_col, batch, p)
        if not any(pred):  # every instance masked: all outputs zero
            return {
                int(out.witness): np.zeros(batch, dtype=object)
                for out in brillig.outputs
            }

    regs: Dict[int, np.ndarray] = {}
    for i, inp in enumerate(brillig.inputs):
        regs[i] = eval_expr_batch(inp.expr, get_col, batch, p)

    zero = np.zeros(batch, dtype=object)

    def get(idx) -> np.ndarray:
        return regs.get(int(idx), zero)

    for op in brillig.bytecode:
        if isinstance(op, br.OpStop):
            break
        if isinstance(op, br.OpConst):
            regs[int(op.destination)] = np.full(
                batch, int(op.value.to_field()), dtype=object
            )
        elif isinstance(op, br.OpMov):
            regs[int(op.destination)] = get(op.source)
        elif isinstance(op, br.OpBinaryFieldOp):
            regs[int(op.destination)] = _binary_field_batch(
                op.op, get(op.lhs), get(op.rhs), p
            )
        elif isinstance(op, br.OpBinaryIntOp):
            val = _binary_int_batch(op.op, get(op.lhs), get(op.rhs), op.bit_size)
            if 1 << op.bit_size > p:
                # The VM stores the result as a field element: at 254 and
                # 256 bits a result at or above p is reduced.
                val = _to_wide(val) % p
            regs[int(op.destination)] = val
        else:  # pragma: no cover - guarded by brillig_batchable
            raise HostBatchFallback(f"unexpected opcode {op!r}")

    out: Dict[int, np.ndarray] = {}
    for i, output in enumerate(brillig.outputs):
        vals = _to_wide(get(i))  # column store holds exact object ints
        if pred is not None:
            mask = np.array([1 if v else 0 for v in pred], dtype=object)
            vals = vals * mask
        out[int(output.witness)] = vals
    return out


def run_permutation_sort_batch(
    directive: ops.DirPermutationSort,
    get_col: GetCol,
    batch: int,
    p: int,
) -> Dict[int, np.ndarray]:
    """PermutationSort control bits for every instance at once.

    The reference solves per instance: evaluate each tuple, stable-sort by
    the ``sort_by`` columns, then compute AS-Waksman routing bits
    (acvm/src/pwg/directives/mod.rs:88-120).  Here the tuple-expression
    evaluations — the per-instance bottleneck (n * tuple_size WitnessMap
    evaluations each) — run once across the whole batch as object-array
    ops; the stable argsort and the (tiny, data-dependent) routing network
    then run per instance on plain ints.
    """
    from ..fields.field import FieldElement
    from ..pwg.sorting import route

    n = len(directive.inputs)
    sort_by = [int(j) for j in directive.sort_by]
    # vals[i][j] = (B,) object ints of tuple i, column j; the reference
    # appends the row index as a trailing column (directives/mod.rs:95-99),
    # so sort_by may legally reference it.
    vals = [
        [eval_expr_batch(e, get_col, batch, p) for e in tup]
        + [np.full(batch, i, dtype=object)]
        for i, tup in enumerate(directive.inputs)
    ]
    base = [FieldElement(i) for i in range(n)]
    bits_out = np.zeros((batch, len(directive.bits)), dtype=object)
    for b in range(batch):
        order = sorted(
            range(n),
            key=lambda i: tuple(int(vals[i][j][b]) for j in sort_by),
        )
        control = route(base, [base[i] for i in order])
        for k, bit in enumerate(control):
            bits_out[b, k] = 1 if bit else 0
    return {
        int(w): bits_out[:, k] for k, w in enumerate(directive.bits)
    }


def run_to_le_radix_batch(
    directive: ops.DirToLeRadix,
    get_col: GetCol,
    batch: int,
    p: int,
) -> Tuple[Dict[int, np.ndarray], np.ndarray]:
    """General-radix digit decomposition for every instance at once.

    Returns ({witness: digits}, bad_mask) where bad_mask flags instances
    whose value needs more digits than provided
    (acvm/src/pwg/directives/mod.rs:67-71 -> UnsatisfiedConstrain).
    """
    v = eval_expr_batch(directive.a, get_col, batch, p).copy()
    radix = directive.radix
    out: Dict[int, np.ndarray] = {}
    for w in directive.b:
        out[int(w)] = v % radix
        v = v // radix
    bad = np.array([x != 0 for x in v], dtype=bool)
    return out, bad
