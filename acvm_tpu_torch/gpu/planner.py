"""Host-side circuit planner: levelize an ACIR circuit into a static batched
schedule for the batched GPU solver.

The reference engine is a sequential interpreter over one instance
(``ACVM::solve``, acvm/src/pwg/mod.rs:236-303): witness values live in a map
and each opcode solves at most one unknown.  For a *fixed* circuit, which
witness each opcode solves — and therefore the whole dataflow — is input
independent (exactly the property the reference's CSat ``solvable_witness``
tracking proves, compiler/transformers/csat.rs:18-57).  So we split the solve:

* here (host, once per circuit): replay the solvability analysis symbolically,
  classify every opcode, and pack each dependency level into dense index /
  coefficient tensors;
* on device (per batch): each level is a handful of vectorized gather →
  limb-arithmetic → scatter kernels over the whole instance batch
  (`acvm_tpu_torch.gpu.batch_solver`).

Static coefficients are pre-scaled on the host: linear coefficients by the
Montgomery radix R (so one mont_mul with a standard-form witness yields the
standard-form product) and mul-term coefficients by R^2 (absorbing the extra
R^-1 from the witness-witness mont_mul).

Opcodes whose semantics are inherently host-side (data-dependent permutation
routing, EC gadgets until their limb kernels land, Brillig bytecode with
data-dependent control flow) are planned as *host stages*: the executor pulls
the needed witnesses to the host, runs the bit-exact sequential solvers per
instance, and pushes results back.  This keeps the batched path complete on
every circuit while the device kernel set grows.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..acir.circuit import Circuit
from ..acir.expression import Expression
from ..acir.witness import Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from ..fields.params import FieldParams, BN254_FR, LIMB_BITS, NUM_LIMBS
from ..fields.limbs import int_to_limbs
from .. import brillig as br


class PlanError(Exception):
    pass


def _expr_witnesses(expr: Expression) -> List[int]:
    """Every witness an expression reads (linear and mul terms)."""
    out = [int(w) for _, w in expr.linear_combinations]
    for _, wl, wr in expr.mul_terms:
        out.append(int(wl))
        out.append(int(wr))
    return out


# ---------------------------------------------------------------------------
# Plan IR
# ---------------------------------------------------------------------------


@dataclass
class ExprPlan:
    """A fully-known expression evaluation: value = sum(lin) + sum(mul) + qc."""

    lin_idx: List[int]
    lin_coeff_r: List[int]  # coeff * R mod p
    mul_idx: List[Tuple[int, int]]
    mul_coeff_r2: List[int]  # coeff * R^2 mod p
    qc: int


@dataclass
class ArithSolveGate:
    """Solve `num + den * W[u] = 0` for W[u].

    num is an ExprPlan over known terms.  den = den_const + sum of dynamic
    terms coeff * W[partner] (from mul terms pairing the unknown with a known
    witness).  When den is a non-zero constant the planner bakes
    -(den_const)^-1 into `neg_inv_den_r` and the executor takes the cheap
    multiply path; otherwise the executor computes a batched inverse.
    """

    unknown: int
    num: ExprPlan
    den_const: int
    den_dyn_idx: List[int]
    den_dyn_coeff_r: List[int]
    neg_inv_den_r: Optional[int]  # -(den_const)^-1 * R, when den is static
    opcode_index: int


@dataclass
class ArithCheckGate:
    expr: ExprPlan
    opcode_index: int


@dataclass
class RangeCheck:
    witness: int
    num_bits: int
    opcode_index: int


@dataclass
class LogicGate:  # AND / XOR
    is_xor: bool
    lhs: int
    rhs: int
    output: int
    num_bits: int
    opcode_index: int


@dataclass
class QuotientGate:
    a: ExprPlan
    b: ExprPlan
    q: int
    r: int
    predicate: Optional[ExprPlan]
    opcode_index: int


@dataclass
class ToLeRadixGate:
    a: ExprPlan
    outputs: List[int]
    radix: int  # power of two on the device path
    opcode_index: int


def _input_bytes(num_bits: int) -> int:
    """The message bytes a hash input read at ``num_bits`` gives: whole bytes,
    at most the 32 of a field element, as ``fetch_nearest_bytes`` takes them
    (``pwg.ACVM``).  The JAX planner does not stop at 32 (its byte 32 names a
    16-bit limb past the element's 16)."""
    return min((num_bits + 7) // 8, 32)


@dataclass
class HashGate:
    """A device-batched 256-bit hash gadget (sha256 / blake2s / keccak256).

    ``byte_src`` is the static message byte layout resolved from each input's
    ``fetch_nearest_bytes(num_bits)`` truncation: per message byte, the source
    witness, its 32-bit limb index ``j // 4`` and the in-limb shift
    ``8 (j % 4)`` (the JAX planner's are 16-bit limbs).  ``hash_to_field``
    gates have one output, the field element."""

    kind: str  # "sha256" | "blake2s" | "keccak256" | "keccak_var" | "hash_to_field"
    byte_src: List[Tuple[int, int, int]]  # (witness, limb, shift)
    outputs: List[int]
    opcode_index: int
    size_witness: Optional[int] = None  # keccak_var: per-instance byte count


@dataclass
class EcFixedBaseGate:
    """Fixed-base Grumpkin scalar mul: (low + high*2^128) * G."""

    low: int
    high: int
    out_x: int
    out_y: int
    opcode_index: int


@dataclass
class SchnorrGate:
    """Grumpkin Schnorr verification (device pipeline: fixed-base +
    variable-base scalar mul, pedersen-compress challenge, blake2s)."""

    pub_x: int
    pub_y: int
    signature: List[int]  # 64 witnesses, one byte each
    message: List[int]
    output: int
    opcode_index: int


@dataclass
class EcdsaGate:
    """Batched device ECDSA verification (secp256k1 / secp256r1); inputs use
    the reference's to_u8_vec semantics (last byte of each witness,
    signature/mod.rs:5-18)."""

    curve: str  # "secp256k1" | "secp256r1"
    pub_x: List[int]  # 32 witnesses
    pub_y: List[int]  # 32
    signature: List[int]  # 64
    hashed_msg: List[int]  # 32
    output: int
    opcode_index: int


@dataclass
class EcPedersenGate:
    """Pedersen commitment: sum_i W[input_i] * G_i(domain)."""

    inputs: List[int]
    domain_separator: int
    out_x: int
    out_y: int
    opcode_index: int


@dataclass
class MemoryInitStage:
    block_id: int
    init: List[int]
    opcode_index: int


@dataclass
class MemoryOpStage:
    block_id: int
    is_read: bool
    index: ExprPlan
    # read: witness to write into; write: expression whose value is stored
    read_into: Optional[int]
    write_value: Optional[ExprPlan]
    predicate: Optional[ExprPlan]
    opcode_index: int
    # Runtime operation selector (memory_operation.rs:5-31: 0 = read, else
    # write, evaluated per instance at solve time).  None = the selector is
    # the compile-time constant captured in ``is_read`` (the common case).
    # Read semantics with ``read_into is None``: the reference PANICS when a
    # read's value expression does not partial-evaluate to an unassigned
    # witness (memory_op.rs:94-96 ``.expect``) — the batched analogue flips
    # the instance's fail flag.
    op_sel: Optional[ExprPlan] = None


@dataclass
class BrilligTraceStage:
    """Straight-line Brillig block batched by symbolic execution at trace time."""

    inputs: List[Tuple[str, object]]  # ("single", ExprPlan) | ("array", [ExprPlan])
    output_simple: List[Tuple[int, int]]  # (register, witness)
    output_array: List[Tuple[int, List[int]]]  # (register, witnesses)
    bytecode: List[br.BrilligOpcode]
    predicate: Optional[ExprPlan]
    opcode_index: int


@dataclass
class HostStage:
    """Fallback: run these opcode indices through the sequential solvers on the
    host, per instance.  ``known_before`` is the set of witnesses known at
    strictly earlier levels (filled in after levelization) — the values the
    host-side solvers may read."""

    opcode_indices: List[int]
    reads: List[int]
    writes: List[int]
    known_before: List[int] = dc_field(default_factory=list)


@dataclass
class Level:
    arith_solve: List[ArithSolveGate] = dc_field(default_factory=list)
    arith_check: List[ArithCheckGate] = dc_field(default_factory=list)
    range_checks: List[RangeCheck] = dc_field(default_factory=list)
    logic: List[LogicGate] = dc_field(default_factory=list)
    quotient: List[QuotientGate] = dc_field(default_factory=list)
    to_le_radix: List[ToLeRadixGate] = dc_field(default_factory=list)
    hashes: List[HashGate] = dc_field(default_factory=list)
    ec_fixed_base: List[EcFixedBaseGate] = dc_field(default_factory=list)
    ec_pedersen: List[EcPedersenGate] = dc_field(default_factory=list)
    schnorr: List[SchnorrGate] = dc_field(default_factory=list)
    ecdsa: List[EcdsaGate] = dc_field(default_factory=list)
    # Witnesses force-set to zero (RecursiveAggregation outputs —
    # blackbox/mod.rs:154-161).
    zero_out: List[int] = dc_field(default_factory=list)
    memory: List[object] = dc_field(default_factory=list)  # init/op stages, ordered
    brillig: List[BrilligTraceStage] = dc_field(default_factory=list)
    host: List[HostStage] = dc_field(default_factory=list)

    def op_count(self) -> int:
        return (
            len(self.arith_solve)
            + len(self.arith_check)
            + len(self.range_checks)
            + len(self.logic)
            + len(self.quotient)
            + len(self.to_le_radix)
            + len(self.hashes)
            + len(self.ec_fixed_base)
            + len(self.ec_pedersen)
            + len(self.schnorr)
            + len(self.ecdsa)
            + (1 if self.zero_out else 0)
            + len(self.memory)
            + len(self.brillig)
            + sum(len(h.opcode_indices) for h in self.host)
        )


@dataclass
class Plan:
    circuit: Circuit
    params: FieldParams
    num_witnesses: int
    input_witnesses: List[int]
    levels: List[Level]
    memory_block_sizes: Dict[int, int]

    def total_ops(self) -> int:
        return sum(level.op_count() for level in self.levels)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

_DEVICE_BRILLIG_OPS = (
    br.OpBinaryFieldOp,
    br.OpBinaryIntOp,
    br.OpConst,
    br.OpMov,
    br.OpStop,
)


class _Planner:
    def __init__(
        self,
        circuit: Circuit,
        known: Set[int],
        params: FieldParams,
        device_hash_kernels: bool = True,
        device_brillig_trace: bool = True,
    ):
        self.circuit = circuit
        self.params = params
        # EngineConfig kernel toggles: route hashes / straight-line Brillig to
        # the host-stage path instead of device kernels (conformance bisection).
        self.device_hash_kernels = device_hash_kernels
        self.device_brillig_trace = device_brillig_trace
        self.p = params.modulus
        self.r = params.r
        self.r2 = params.r2
        self.known_level: Dict[int, int] = {w: 0 for w in known}
        self.levels: List[Level] = []
        self.memory_block_sizes: Dict[int, int] = {}
        # Memory ops on a block must stay ordered: track the level of the last
        # op per block so the next one lands strictly after it.
        self.mem_level: Dict[int, int] = {}

    # -- helpers ------------------------------------------------------------
    def _level(self, idx: int) -> Level:
        while len(self.levels) <= idx:
            self.levels.append(Level())
        return self.levels[idx]

    def _witness_level(self, w: int) -> int:
        try:
            return self.known_level[w]
        except KeyError:
            raise PlanError(f"missing assignment for witness index {w}")

    def _mark_known(self, w: int, level: int):
        if w not in self.known_level:
            self.known_level[w] = level

    def _plan_expr(self, expr: Expression) -> Tuple[ExprPlan, int]:
        """Plan the evaluation of a fully-known expression; returns the plan
        and the earliest level at which it can run."""
        level = 0
        lin_idx, lin_coeff = [], []
        mul_idx, mul_coeff = [], []
        for c, w in expr.linear_combinations:
            if c.is_zero():
                continue
            level = max(level, self._witness_level(int(w)))
            lin_idx.append(int(w))
            lin_coeff.append((c.value * self.r) % self.p)
        for c, wl, wr in expr.mul_terms:
            if c.is_zero():
                continue
            level = max(
                level, self._witness_level(int(wl)), self._witness_level(int(wr))
            )
            mul_idx.append((int(wl), int(wr)))
            mul_coeff.append((c.value * self.r2) % self.p)
        return (
            ExprPlan(lin_idx, lin_coeff, mul_idx, mul_coeff, expr.q_c.value),
            level,
        )

    def _plan_opt_expr(self, expr: Optional[Expression]):
        if expr is None:
            return None, 0
        return self._plan_expr(expr)

    # -- arithmetic ---------------------------------------------------------
    def _plan_arithmetic(self, opcode_index: int, expr: Expression):
        known = self.known_level
        unknown_slots = []  # ("lin", c, w) | ("mul", c, w_unknown, w_partner)
        num_lin, num_lin_coeff = [], []
        num_mul, num_mul_coeff = [], []
        dep_level = 0

        for c, w in expr.linear_combinations:
            if c.is_zero():
                continue
            if int(w) in known:
                dep_level = max(dep_level, known[int(w)])
                num_lin.append(int(w))
                num_lin_coeff.append((c.value * self.r) % self.p)
            else:
                unknown_slots.append(("lin", c, int(w)))

        for c, wl, wr in expr.mul_terms:
            if c.is_zero():
                continue
            l_known = int(wl) in known
            r_known = int(wr) in known
            if l_known and r_known:
                dep_level = max(dep_level, known[int(wl)], known[int(wr)])
                num_mul.append((int(wl), int(wr)))
                num_mul_coeff.append((c.value * self.r2) % self.p)
            elif l_known:
                dep_level = max(dep_level, known[int(wl)])
                unknown_slots.append(("mul", c, int(wr), int(wl)))
            elif r_known:
                dep_level = max(dep_level, known[int(wr)])
                unknown_slots.append(("mul", c, int(wl), int(wr)))
            else:
                raise PlanError(
                    f"opcode {opcode_index}: expression has too many unknowns "
                    "(mul term with two unknown witnesses)"
                )

        num = ExprPlan(num_lin, num_lin_coeff, num_mul, num_mul_coeff, expr.q_c.value)
        level_idx = dep_level + 1

        if not unknown_slots:
            self._level(level_idx).arith_check.append(
                ArithCheckGate(num, opcode_index)
            )
            return

        if len(unknown_slots) > 1:
            # The reference counts unknown *terms*; two terms referencing even
            # the same unknown witness are unsolvable (arithmetic.rs:176-209).
            raise PlanError(
                f"opcode {opcode_index}: expression has too many unknowns"
            )

        slot = unknown_slots[0]
        if slot[0] == "lin":
            _, c, w = slot
            den_const = c.value
            den_dyn_idx: List[int] = []
            den_dyn_coeff: List[int] = []
        else:
            _, c, w, partner = slot
            den_const = 0
            den_dyn_idx = [partner]
            den_dyn_coeff = [(c.value * self.r) % self.p]

        neg_inv = None
        if not den_dyn_idx:
            if den_const == 0:
                raise PlanError(
                    f"opcode {opcode_index}: zero-coefficient unknown"
                )
            neg_inv = ((-pow(den_const, -1, self.p)) * self.r) % self.p

        gate = ArithSolveGate(
            unknown=w,
            num=num,
            den_const=den_const,
            den_dyn_idx=den_dyn_idx,
            den_dyn_coeff_r=den_dyn_coeff,
            neg_inv_den_r=neg_inv,
            opcode_index=opcode_index,
        )
        self._level(level_idx).arith_solve.append(gate)
        self._mark_known(w, level_idx)

    # -- black box ----------------------------------------------------------
    def _plan_blackbox(self, opcode_index: int, call: ops.BlackBoxFuncCall):
        if isinstance(call, ops.BBRange):
            w = int(call.input.witness)
            level_idx = self._witness_level(w) + 1
            self._level(level_idx).range_checks.append(
                RangeCheck(w, call.input.num_bits, opcode_index)
            )
            return
        if isinstance(call, (ops.BBAnd, ops.BBXor)):
            lhs, rhs = int(call.lhs.witness), int(call.rhs.witness)
            level_idx = max(self._witness_level(lhs), self._witness_level(rhs)) + 1
            self._level(level_idx).logic.append(
                LogicGate(
                    is_xor=isinstance(call, ops.BBXor),
                    lhs=lhs,
                    rhs=rhs,
                    output=int(call.output),
                    num_bits=call.lhs.num_bits,
                    opcode_index=opcode_index,
                )
            )
            self._mark_known(int(call.output), level_idx)
            return
        if self.device_hash_kernels and isinstance(
            call, ops.BBHashToField128Security
        ):
            # blake2s then reduce-mod-p (blackbox_solver/src/lib.rs:85-99):
            # rides the hash-gate machinery with a single field output; the
            # byte->field composition happens in run_hashes.
            byte_src = []
            level_idx = 0
            for fi in call.inputs:
                w = int(fi.witness)
                level_idx = max(level_idx, self._witness_level(w))
                for j in range(_input_bytes(fi.num_bits)):
                    byte_src.append((w, j // 4, 8 * (j % 4)))
            level_idx += 1
            out = int(call.output)
            self._level(level_idx).hashes.append(
                HashGate("hash_to_field", byte_src, [out], opcode_index, None)
            )
            self._mark_known(out, level_idx)
            return
        if self.device_hash_kernels and isinstance(
            call,
            (
                ops.BBSha256,
                ops.BBBlake2s,
                ops.BBKeccak256,
                ops.BBKeccak256VariableLength,
            ),
        ):
            outputs = [int(w) for w in call.get_outputs_vec()]
            if len(outputs) != 32:
                # No silent caps: a non-32-output digest shape (possible for
                # KeccakVar per the wire format) is correct on the host stage
                # but skips the device hash kernel — say so.
                import logging

                logging.getLogger("acvm_tpu_torch.gpu.planner").info(
                    "opcode %d: %s with %d output witnesses routes to the "
                    "host stage (device hash kernels need 32)",
                    opcode_index, type(call).__name__, len(outputs),
                )
            if len(outputs) == 32:
                kind = {
                    ops.BBSha256: "sha256",
                    ops.BBBlake2s: "blake2s",
                    ops.BBKeccak256: "keccak256",
                    ops.BBKeccak256VariableLength: "keccak_var",
                }[type(call)]
                size_witness = None
                if isinstance(call, ops.BBKeccak256VariableLength):
                    size_witness = int(call.var_message_size.witness)
                byte_src = []
                level_idx = 0
                if size_witness is not None:
                    level_idx = self._witness_level(size_witness)
                for fi in call.inputs:
                    w = int(fi.witness)
                    level_idx = max(level_idx, self._witness_level(w))
                    for j in range(_input_bytes(fi.num_bits)):
                        byte_src.append((w, j // 4, 8 * (j % 4)))
                level_idx += 1
                self._level(level_idx).hashes.append(
                    HashGate(kind, byte_src, outputs, opcode_index, size_witness)
                )
                for w in outputs:
                    self._mark_known(w, level_idx)
                return
        if isinstance(call, ops.BBFixedBaseScalarMul):
            low, high = int(call.low.witness), int(call.high.witness)
            level_idx = max(self._witness_level(low), self._witness_level(high)) + 1
            out_x, out_y = int(call.outputs[0]), int(call.outputs[1])
            self._level(level_idx).ec_fixed_base.append(
                EcFixedBaseGate(low, high, out_x, out_y, opcode_index)
            )
            self._mark_known(out_x, level_idx)
            self._mark_known(out_y, level_idx)
            return
        if isinstance(call, ops.BBPedersen):
            inputs = [int(fi.witness) for fi in call.inputs]
            level_idx = max(
                (self._witness_level(w) for w in inputs), default=0
            ) + 1
            out_x, out_y = int(call.outputs[0]), int(call.outputs[1])
            self._level(level_idx).ec_pedersen.append(
                EcPedersenGate(
                    inputs, call.domain_separator, out_x, out_y, opcode_index
                )
            )
            self._mark_known(out_x, level_idx)
            self._mark_known(out_y, level_idx)
            return
        from ..blackbox.grumpkin import schnorr_challenge_hook

        if (
            isinstance(call, ops.BBSchnorrVerify)
            and len(call.signature) == 64
            # A Python challenge hook can't run inside the device kernel:
            # route hooked Schnorr through the bit-exact host stage.
            and schnorr_challenge_hook() is None
        ):
            reads = [int(fi.witness) for fi in call.get_inputs_vec()]
            level_idx = max(self._witness_level(w) for w in reads) + 1
            self._level(level_idx).schnorr.append(
                SchnorrGate(
                    pub_x=int(call.public_key_x.witness),
                    pub_y=int(call.public_key_y.witness),
                    signature=[int(fi.witness) for fi in call.signature],
                    message=[int(fi.witness) for fi in call.message],
                    output=int(call.output),
                    opcode_index=opcode_index,
                )
            )
            self._mark_known(int(call.output), level_idx)
            return
        if isinstance(call, (ops.BBEcdsaSecp256k1, ops.BBEcdsaSecp256r1)) and (
            len(call.public_key_x) == 32
            and len(call.public_key_y) == 32
            and len(call.signature) == 64
            and len(call.hashed_message) == 32
        ):
            reads = [int(fi.witness) for fi in call.get_inputs_vec()]
            level_idx = max(self._witness_level(w) for w in reads) + 1
            self._level(level_idx).ecdsa.append(
                EcdsaGate(
                    curve="secp256k1"
                    if isinstance(call, ops.BBEcdsaSecp256k1)
                    else "secp256r1",
                    pub_x=[int(fi.witness) for fi in call.public_key_x],
                    pub_y=[int(fi.witness) for fi in call.public_key_y],
                    signature=[int(fi.witness) for fi in call.signature],
                    hashed_msg=[int(fi.witness) for fi in call.hashed_message],
                    output=int(call.output),
                    opcode_index=opcode_index,
                )
            )
            self._mark_known(int(call.output), level_idx)
            return
        if isinstance(call, ops.BBRecursiveAggregation):
            # Outputs are zeroed; the real value comes from the proving backend
            # (blackbox/mod.rs:154-161).
            inputs = call.get_inputs_vec()
            level_idx = max(
                (self._witness_level(int(fi.witness)) for fi in inputs), default=0
            ) + 1
            outputs = [int(w) for w in call.output_aggregation_object]
            self._level(level_idx).zero_out.extend(outputs)
            for w in outputs:
                self._mark_known(w, level_idx)
            return
        # Variable-length keccak and signature verification gadgets: host stage
        # through the sequential solvers.
        self._plan_host_stage(opcode_index, call.get_inputs_vec(), call.get_outputs_vec())

    def _plan_host_stage(self, opcode_index: int, inputs, outputs):
        reads = [int(fi.witness) for fi in inputs]
        writes = [int(w) for w in outputs]
        level_idx = max((self._witness_level(w) for w in reads), default=0) + 1
        self._level(level_idx).host.append(
            HostStage([opcode_index], reads, writes)
        )
        for w in writes:
            self._mark_known(w, level_idx)

    # -- directives ---------------------------------------------------------
    def _plan_directive(self, opcode_index: int, directive: ops.Directive):
        if isinstance(directive, ops.DirQuotient):
            q = directive.quotient
            a_plan, a_lvl = self._plan_expr(q.a)
            b_plan, b_lvl = self._plan_expr(q.b)
            p_plan, p_lvl = self._plan_opt_expr(q.predicate)
            level_idx = max(a_lvl, b_lvl, p_lvl) + 1
            self._level(level_idx).quotient.append(
                QuotientGate(a_plan, b_plan, int(q.q), int(q.r), p_plan, opcode_index)
            )
            self._mark_known(int(q.q), level_idx)
            self._mark_known(int(q.r), level_idx)
            return
        if isinstance(directive, ops.DirToLeRadix):
            radix = directive.radix
            if radix >= 2 and (radix & (radix - 1)) == 0:
                a_plan, a_lvl = self._plan_expr(directive.a)
                level_idx = a_lvl + 1
                self._level(level_idx).to_le_radix.append(
                    ToLeRadixGate(
                        a_plan,
                        [int(w) for w in directive.b],
                        radix,
                        opcode_index,
                    )
                )
                for w in directive.b:
                    self._mark_known(int(w), level_idx)
                return
            # General radix: host stage.
            self._plan_host_stage_raw(
                opcode_index,
                _expr_witnesses(directive.a),
                [int(w) for w in directive.b],
            )
            return
        if isinstance(directive, ops.DirPermutationSort):
            reads = []
            for tup in directive.inputs:
                for e in tup:
                    reads.extend(_expr_witnesses(e))
            self._plan_host_stage_raw(
                opcode_index, reads, [int(w) for w in directive.bits]
            )
            return
        raise TypeError(directive)

    def _plan_host_stage_raw(self, opcode_index: int, reads, writes):
        level_idx = max((self._witness_level(w) for w in reads), default=0) + 1
        self._level(level_idx).host.append(HostStage([opcode_index], list(reads), list(writes)))
        for w in writes:
            self._mark_known(w, level_idx)

    # -- memory -------------------------------------------------------------
    def _plan_memory_init(self, opcode_index: int, op: ops.OpcodeMemoryInit):
        reads = [int(w) for w in op.init]
        level_idx = max(
            max((self._witness_level(w) for w in reads), default=0) + 1,
            self.mem_level.get(op.block_id.id, 0) + 1,
        )
        self._level(level_idx).memory.append(
            MemoryInitStage(op.block_id.id, reads, opcode_index)
        )
        self.memory_block_sizes[op.block_id.id] = max(
            self.memory_block_sizes.get(op.block_id.id, 0), len(reads)
        )
        self.mem_level[op.block_id.id] = level_idx

    def _plan_memory_op(self, opcode_index: int, op: ops.OpcodeMemoryOp):
        operation = op.op.operation.to_const()
        idx_plan, idx_lvl = self._plan_expr(op.op.index)
        pred_plan, pred_lvl = self._plan_opt_expr(op.predicate)
        dep = max(idx_lvl, pred_lvl)

        if operation is None:
            # Runtime operation selector (memory_operation.rs:5-31 /
            # memory_op.rs:47-123): each instance evaluates the selector and
            # acts as a read (0) or write (non-zero).  The batched stage
            # masks both behaviors per instance (run_memory_op).
            sel_plan, sel_lvl = self._plan_expr(op.op.operation)
            dep = max(dep, sel_lvl)
            value_w = op.op.value.to_witness()
            val_plan = None
            read_into = None
            if value_w is None or int(value_w) in self.known_level:
                # The value partial-evaluates (a compound expression, or a
                # witness already assigned): read-active instances hit the
                # reference's "must read into a specified witness" panic
                # (memory_op.rs:94-96) -> per-instance failure; write-active
                # instances evaluate the expression normally.
                val_plan, val_lvl = self._plan_expr(op.op.value)
                dep = max(dep, val_lvl)
            else:
                read_into = int(value_w)
                # Unknown witness: reads assign it; write-active instances
                # cannot evaluate the stored value -> per-instance failure
                # (the reference's OpcodeNotSolvable, pwg/mod.rs:72-127).
            level_idx = max(dep + 1, self.mem_level.get(op.block_id.id, 0) + 1)
            self._level(level_idx).memory.append(
                MemoryOpStage(
                    op.block_id.id, False, idx_plan, read_into, val_plan,
                    pred_plan, opcode_index, op_sel=sel_plan,
                )
            )
            if read_into is not None:
                self._mark_known(read_into, level_idx)
            self.mem_level[op.block_id.id] = level_idx
            return
        is_read = operation.is_zero()

        if is_read:
            read_into = op.op.value.to_witness()
            if read_into is not None and int(read_into) in self.known_level:
                # Partial evaluation folds an assigned witness into a
                # constant, so the reference panics on this read
                # (memory_op.rs:94-96); every instance fails.
                read_into = None
            if read_into is None:
                level_idx = max(
                    dep + 1, self.mem_level.get(op.block_id.id, 0) + 1
                )
                self._level(level_idx).memory.append(
                    MemoryOpStage(
                        op.block_id.id, True, idx_plan, None, None,
                        pred_plan, opcode_index,
                    )
                )
                self.mem_level[op.block_id.id] = level_idx
                return
            level_idx = max(dep + 1, self.mem_level.get(op.block_id.id, 0) + 1)
            self._level(level_idx).memory.append(
                MemoryOpStage(
                    op.block_id.id, True, idx_plan, int(read_into), None,
                    pred_plan, opcode_index,
                )
            )
            self._mark_known(int(read_into), level_idx)
        else:
            val_plan, val_lvl = self._plan_expr(op.op.value)
            dep = max(dep, val_lvl)
            level_idx = max(dep + 1, self.mem_level.get(op.block_id.id, 0) + 1)
            self._level(level_idx).memory.append(
                MemoryOpStage(
                    op.block_id.id, False, idx_plan, None, val_plan,
                    pred_plan, opcode_index,
                )
            )
        self.mem_level[op.block_id.id] = level_idx

    # -- brillig ------------------------------------------------------------
    def _plan_brillig(self, opcode_index: int, opcode: ops.OpcodeBrillig):
        b = opcode.brillig
        device_ok = self.device_brillig_trace and all(
            isinstance(o, _DEVICE_BRILLIG_OPS) for o in b.bytecode
        )
        reads: List[int] = []
        writes: List[int] = []
        for inp in b.inputs:
            exprs = [inp.expr] if isinstance(inp, ops.BrilligInputSingle) else inp.exprs
            for e in exprs:
                reads.extend(int(w) for _, w in e.linear_combinations)
                reads.extend(int(w) for _, wl, wr in e.mul_terms for w in (wl, wr))
        if b.predicate is not None:
            # Every witness of the predicate, its product terms too: the stage
            # must run after each of them is solved.
            reads.extend(_expr_witnesses(b.predicate))
        for out in b.outputs:
            if isinstance(out, ops.BrilligOutputSimple):
                writes.append(int(out.witness))
            else:
                writes.extend(int(w) for w in out.witnesses)

        if not device_ok:
            self._plan_host_stage_raw(opcode_index, reads, writes)
            return

        level_idx = max((self._witness_level(w) for w in reads), default=0) + 1
        inputs = []
        for inp in b.inputs:
            if isinstance(inp, ops.BrilligInputSingle):
                inputs.append(("single", self._plan_expr(inp.expr)[0]))
            else:
                inputs.append(
                    ("array", [self._plan_expr(e)[0] for e in inp.exprs])
                )
        output_simple, output_array = [], []
        for i, out in enumerate(b.outputs):
            if isinstance(out, ops.BrilligOutputSimple):
                output_simple.append((i, int(out.witness)))
            else:
                output_array.append((i, [int(w) for w in out.witnesses]))
        pred_plan, _ = self._plan_opt_expr(b.predicate)
        self._level(level_idx).brillig.append(
            BrilligTraceStage(
                inputs, output_simple, output_array, b.bytecode, pred_plan,
                opcode_index,
            )
        )
        for w in writes:
            self._mark_known(w, level_idx)

    # -- plan loop -----------------------------------------------------------
    def plan(self) -> Plan:
        for index, opcode in enumerate(self.circuit.opcodes):
            if isinstance(opcode, ops.OpcodeArithmetic):
                self._plan_arithmetic(index, opcode.expr)
            elif isinstance(opcode, ops.OpcodeBlackBoxFuncCall):
                self._plan_blackbox(index, opcode.call)
            elif isinstance(opcode, ops.OpcodeDirective):
                self._plan_directive(index, opcode.directive)
            elif isinstance(opcode, ops.OpcodeMemoryInit):
                self._plan_memory_init(index, opcode)
            elif isinstance(opcode, ops.OpcodeMemoryOp):
                self._plan_memory_op(index, opcode)
            elif isinstance(opcode, ops.OpcodeBrillig):
                self._plan_brillig(index, opcode)
            else:
                raise TypeError(opcode)

        # Fill host stages' readable-witness sets: everything known at a
        # strictly earlier level.  Uses original (pre-compaction) level ids.
        by_level: Dict[int, List[int]] = {}
        for w, lvl in self.known_level.items():
            by_level.setdefault(lvl, []).append(w)
        for level_idx, level in enumerate(self.levels):
            if level.host:
                known = sorted(
                    w
                    for lvl, ws in by_level.items()
                    if lvl < level_idx
                    for w in ws
                )
                for stage in level.host:
                    stage.known_before = known

        # Drop the synthetic empty level 0 (inputs live at level 0).
        levels = [lvl for lvl in self.levels if lvl.op_count() > 0]
        return Plan(
            circuit=self.circuit,
            params=self.params,
            num_witnesses=self.circuit.num_vars(),
            input_witnesses=sorted(
                w for w, lvl in self.known_level.items() if lvl == 0
            ),
            levels=levels,
            memory_block_sizes=self.memory_block_sizes,
        )


def plan_circuit(
    circuit: Circuit,
    input_witnesses: Optional[Sequence[int]] = None,
    params: Optional[FieldParams] = None,
    config=None,
) -> Plan:
    """Build a batched execution plan for ``circuit``.

    ``input_witnesses`` defaults to the circuit's declared arguments
    (private + public parameters), matching what an initial witness map for the
    sequential engine must provide.  ``config`` (an
    ``EngineConfig``-like object) selects the field and the device
    kernel toggles; an explicit ``params`` overrides the config's field.
    """
    if input_witnesses is None:
        known = {int(w) for w in circuit.circuit_arguments()}
    else:
        known = {int(w) for w in input_witnesses}
    if params is None:
        params = config.field_params() if config is not None else BN254_FR
    kwargs = {}
    if config is not None:
        kwargs = dict(
            device_hash_kernels=config.device_hash_kernels,
            device_brillig_trace=config.device_brillig_trace,
        )
    return _Planner(circuit, known, params, **kwargs).plan()
