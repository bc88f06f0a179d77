"""Constrained machine-integer gadget library (UInt8/32/64).

Reference: stdlib/src/blackbox_fallbacks/uint.rs (macro impl_uint) — the
"Brillig computes, ACIR constrains" pattern: every operation runs a tiny
Brillig hint block to produce the witness value, then emits arithmetic/range
gates that force it to be correct.  Division is the Quotient directive plus
range checks and the lhs = q*rhs + r constraint.
"""

from __future__ import annotations

from typing import List, Tuple

from .. import brillig as br
from ..acir.expression import Expression
from ..acir.witness import Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from .helpers import VariableStore

Opcodes = List[ops.Opcode]


def _single_input(witness: Witness) -> ops.BrilligInputSingle:
    return ops.BrilligInputSingle(Expression.from_witness(witness))


def _const_input(value: int) -> ops.BrilligInputSingle:
    return ops.BrilligInputSingle(Expression.from_field(FieldElement(value)))


def _brillig(inputs, outputs, bytecode) -> ops.OpcodeBrillig:
    return ops.OpcodeBrillig(
        ops.Brillig(
            inputs=list(inputs),
            outputs=list(outputs),
            foreign_call_results=[],
            bytecode=list(bytecode),
            predicate=None,
        )
    )


def _int_op(op: br.BinaryIntOp, bit_size: int, lhs: int, rhs: int, dest: int):
    return br.OpBinaryIntOp(
        br.RegisterIndex(dest), op, bit_size, br.RegisterIndex(lhs), br.RegisterIndex(rhs)
    )


class UIntGadget:
    """A width-parameterized uint witness (UInt8 / UInt32 / UInt64)."""

    def __init__(self, inner: Witness, width: int):
        self.inner = inner
        self.width = width

    # -- constants -----------------------------------------------------------
    @classmethod
    def load_constant(
        cls, constant: int, width: int, num_witness: int
    ) -> Tuple["UIntGadget", Opcodes, int]:
        variables = VariableStore(num_witness)
        new_witness = variables.new_variable()
        opcode = _brillig(
            [_const_input(constant)],
            [ops.BrilligOutputSimple(new_witness)],
            [br.OpStop()],
        )
        return cls(new_witness, width), [opcode], variables.finalize()

    def get_max_plus_one(self, num_witness: int):
        return UIntGadget.load_constant(1 << self.width, self.width, num_witness)

    # -- division ------------------------------------------------------------
    @staticmethod
    def euclidean_division(
        lhs: "UIntGadget", rhs: "UIntGadget", num_witness: int
    ) -> Tuple["UIntGadget", "UIntGadget", Opcodes, int]:
        new_opcodes: Opcodes = []
        variables = VariableStore(num_witness)
        q_witness = variables.new_variable()
        r_witness = variables.new_variable()

        new_opcodes.append(
            ops.OpcodeDirective(
                ops.DirQuotient(
                    ops.QuotientDirective(
                        a=Expression.from_witness(lhs.inner),
                        b=Expression.from_witness(rhs.inner),
                        q=q_witness,
                        r=r_witness,
                        predicate=None,
                    )
                )
            )
        )
        for w in (r_witness, q_witness):
            new_opcodes.append(
                ops.OpcodeBlackBoxFuncCall(
                    ops.BBRange(ops.FunctionInput(w, lhs.width))
                )
            )
        num_witness = variables.finalize()

        # constrain r < rhs via RANGE(rhs - r - 1)
        rhs_sub_r, extra, num_witness = rhs.sub_no_overflow(
            UIntGadget(r_witness, lhs.width), num_witness
        )
        new_opcodes.extend(extra)
        new_opcodes.append(
            ops.OpcodeBlackBoxFuncCall(
                ops.BBRange(ops.FunctionInput(rhs_sub_r.inner, lhs.width))
            )
        )

        # constrain lhs = rhs*q + r
        rhs_expr = Expression.from_witness(rhs.inner)
        rhs_constraint = rhs_expr.mul(Expression.from_witness(q_witness))
        rhs_constraint = rhs_constraint + Expression.from_witness(r_witness)
        div_euclidean = Expression.from_witness(lhs.inner) - rhs_constraint
        new_opcodes.append(ops.OpcodeArithmetic(div_euclidean))

        return (
            UIntGadget(q_witness, lhs.width),
            UIntGadget(r_witness, lhs.width),
            new_opcodes,
            num_witness,
        )

    # -- shifts / rotations ----------------------------------------------------
    def rol(self, rotation: int, num_witness: int):
        rotation = rotation % self.width
        new_opcodes: Opcodes = []
        right_shift, extra, num_witness = self.rightshift(
            self.width - rotation, num_witness
        )
        new_opcodes.extend(extra)
        left_shift, extra, num_witness = self.leftshift(rotation, num_witness)
        new_opcodes.extend(extra)
        result, extra, num_witness = left_shift.or_(right_shift, num_witness)
        new_opcodes.extend(extra)
        return result, new_opcodes, num_witness

    def ror(self, rotation: int, num_witness: int):
        rotation = rotation % self.width
        new_opcodes: Opcodes = []
        left_shift, extra, num_witness = self.leftshift(
            self.width - rotation, num_witness
        )
        new_opcodes.extend(extra)
        right_shift, extra, num_witness = self.rightshift(rotation, num_witness)
        new_opcodes.extend(extra)
        result, extra, num_witness = left_shift.or_(right_shift, num_witness)
        new_opcodes.extend(extra)
        return result, new_opcodes, num_witness

    def leftshift(self, bits: int, num_witness: int):
        bits = bits % self.width
        new_opcodes: Opcodes = []
        two_pow, extra, num_witness = UIntGadget.load_constant(
            2**bits, self.width, num_witness
        )
        new_opcodes.extend(extra)
        left_shift, extra, num_witness = self.mul(two_pow, num_witness)
        new_opcodes.extend(extra)
        return left_shift, new_opcodes, num_witness

    def rightshift(self, bits: int, num_witness: int):
        bits = bits % self.width
        new_opcodes: Opcodes = []
        two_pow, extra, num_witness = UIntGadget.load_constant(
            2**bits, self.width, num_witness
        )
        new_opcodes.extend(extra)
        right_shift, _, extra, num_witness = UIntGadget.euclidean_division(
            self, two_pow, num_witness
        )
        new_opcodes.extend(extra)
        return right_shift, new_opcodes, num_witness

    # -- arithmetic ------------------------------------------------------------
    def add(self, rhs: "UIntGadget", num_witness: int):
        new_opcodes: Opcodes = []
        variables = VariableStore(num_witness)
        new_witness = variables.new_variable()

        new_opcodes.append(
            _brillig(
                [_single_input(self.inner), _single_input(rhs.inner)],
                [ops.BrilligOutputSimple(new_witness)],
                [_int_op(br.BinaryIntOp.Add, 127, 0, 1, 0)],
            )
        )
        num_witness = variables.finalize()

        add_expr = Expression.from_witness(new_witness)
        add_expr.linear_combinations.append((-FieldElement.one(), self.inner))
        add_expr.linear_combinations.append((-FieldElement.one(), rhs.inner))
        new_opcodes.append(ops.OpcodeArithmetic(add_expr))

        two_pow_width, extra, num_witness = self.get_max_plus_one(num_witness)
        new_opcodes.extend(extra)
        _, add_mod, extra, num_witness = UIntGadget.euclidean_division(
            UIntGadget(new_witness, self.width), two_pow_width, num_witness
        )
        new_opcodes.extend(extra)
        return add_mod, new_opcodes, num_witness

    def sub(self, rhs: "UIntGadget", num_witness: int):
        new_opcodes: Opcodes = []
        variables = VariableStore(num_witness)
        new_witness = variables.new_variable()

        new_opcodes.append(
            _brillig(
                [
                    _single_input(self.inner),
                    _single_input(rhs.inner),
                    _const_input(1 << self.width),
                ],
                [ops.BrilligOutputSimple(new_witness)],
                [
                    _int_op(br.BinaryIntOp.Add, 127, 0, 2, 0),
                    _int_op(br.BinaryIntOp.Sub, 127, 0, 1, 0),
                ],
            )
        )
        num_witness = variables.finalize()

        sub_constraint = Expression.from_witness(self.inner)
        sub_constraint.linear_combinations.append((-FieldElement.one(), new_witness))
        sub_constraint.linear_combinations.append((-FieldElement.one(), rhs.inner))
        sub_constraint.q_c = FieldElement(1 << self.width)
        new_opcodes.append(ops.OpcodeArithmetic(sub_constraint))

        two_pow_width, extra, num_witness = self.get_max_plus_one(num_witness)
        new_opcodes.extend(extra)
        _, sub_mod, extra, num_witness = UIntGadget.euclidean_division(
            UIntGadget(new_witness, self.width), two_pow_width, num_witness
        )
        new_opcodes.extend(extra)
        return sub_mod, new_opcodes, num_witness

    def sub_no_overflow(self, rhs: "UIntGadget", num_witness: int):
        """self - rhs - 1 without wraparound (helper for euclidean_division)."""
        new_opcodes: Opcodes = []
        variables = VariableStore(num_witness)
        new_witness = variables.new_variable()

        new_opcodes.append(
            _brillig(
                [
                    _single_input(self.inner),
                    _single_input(rhs.inner),
                    _const_input(1),
                ],
                [ops.BrilligOutputSimple(new_witness)],
                [
                    _int_op(br.BinaryIntOp.Sub, 127, 0, 1, 0),
                    _int_op(br.BinaryIntOp.Sub, 127, 0, 2, 0),
                ],
            )
        )
        num_witness = variables.finalize()

        sub_constraint = Expression.from_witness(self.inner)
        sub_constraint.linear_combinations.append((-FieldElement.one(), new_witness))
        sub_constraint.linear_combinations.append((-FieldElement.one(), rhs.inner))
        sub_constraint.q_c = -FieldElement.one()
        new_opcodes.append(ops.OpcodeArithmetic(sub_constraint))

        return UIntGadget(new_witness, self.width), new_opcodes, num_witness

    def mul(self, rhs: "UIntGadget", num_witness: int):
        new_opcodes: Opcodes = []
        variables = VariableStore(num_witness)
        new_witness = variables.new_variable()

        new_opcodes.append(
            _brillig(
                [_single_input(self.inner), _single_input(rhs.inner)],
                [ops.BrilligOutputSimple(new_witness)],
                [
                    br.OpBinaryFieldOp(
                        br.RegisterIndex(0),
                        br.BinaryFieldOp.Mul,
                        br.RegisterIndex(0),
                        br.RegisterIndex(1),
                    )
                ],
            )
        )
        num_witness = variables.finalize()

        mul_constraint = Expression.from_witness(new_witness)
        mul_constraint.mul_terms.append(
            (-FieldElement.one(), self.inner, rhs.inner)
        )
        new_opcodes.append(ops.OpcodeArithmetic(mul_constraint))

        two_pow, extra, num_witness = self.get_max_plus_one(num_witness)
        new_opcodes.extend(extra)
        _, mul_mod, extra, num_witness = UIntGadget.euclidean_division(
            UIntGadget(new_witness, self.width), two_pow, num_witness
        )
        new_opcodes.extend(extra)
        return mul_mod, new_opcodes, num_witness

    # -- bitwise ---------------------------------------------------------------
    def and_(self, rhs: "UIntGadget", num_witness: int):
        variables = VariableStore(num_witness)
        new_witness = variables.new_variable()
        opcode = ops.OpcodeBlackBoxFuncCall(
            ops.BBAnd(
                ops.FunctionInput(self.inner, self.width),
                ops.FunctionInput(rhs.inner, self.width),
                new_witness,
            )
        )
        return UIntGadget(new_witness, self.width), [opcode], variables.finalize()

    def xor(self, rhs: "UIntGadget", num_witness: int):
        variables = VariableStore(num_witness)
        new_witness = variables.new_variable()
        opcode = ops.OpcodeBlackBoxFuncCall(
            ops.BBXor(
                ops.FunctionInput(self.inner, self.width),
                ops.FunctionInput(rhs.inner, self.width),
                new_witness,
            )
        )
        return UIntGadget(new_witness, self.width), [opcode], variables.finalize()

    def or_(self, rhs: "UIntGadget", num_witness: int):
        # a | b = (a & b) + (a ^ b)
        new_opcodes: Opcodes = []
        a_and_b, extra, num_witness = self.and_(rhs, num_witness)
        new_opcodes.extend(extra)
        a_xor_b, extra, num_witness = self.xor(rhs, num_witness)
        new_opcodes.extend(extra)
        result, extra, num_witness = a_and_b.add(a_xor_b, num_witness)
        new_opcodes.extend(extra)
        return result, new_opcodes, num_witness

    def not_(self, num_witness: int):
        new_opcodes: Opcodes = []
        variables = VariableStore(num_witness)
        new_witness = variables.new_variable()

        new_opcodes.append(
            _brillig(
                [
                    _single_input(self.inner),
                    _const_input((1 << self.width) - 1),
                ],
                [ops.BrilligOutputSimple(new_witness)],
                [_int_op(br.BinaryIntOp.Sub, self.width, 1, 0, 0)],
            )
        )
        num_witness = variables.finalize()

        not_constraint = Expression.from_witness(new_witness)
        not_constraint.linear_combinations.append((FieldElement.one(), self.inner))
        not_constraint.q_c = -FieldElement((1 << self.width) - 1)
        new_opcodes.append(ops.OpcodeArithmetic(not_constraint))

        return UIntGadget(new_witness, self.width), new_opcodes, num_witness

    # -- comparisons -----------------------------------------------------------
    def more_than_eq_comparison(self, rhs: "UIntGadget", num_witness: int):
        new_opcodes: Opcodes = []
        variables = VariableStore(num_witness)
        new_witness = variables.new_variable()
        q_witness = variables.new_variable()
        r_witness = variables.new_variable()

        new_opcodes.append(
            _brillig(
                [
                    _single_input(self.inner),
                    _single_input(rhs.inner),
                    _const_input(1 << self.width),
                ],
                [ops.BrilligOutputSimple(new_witness)],
                [
                    _int_op(br.BinaryIntOp.Add, 127, 0, 2, 0),
                    _int_op(br.BinaryIntOp.Sub, 127, 0, 1, 0),
                ],
            )
        )
        num_witness = variables.finalize()

        sub_constraint = Expression.from_witness(self.inner)
        sub_constraint.linear_combinations.append((-FieldElement.one(), new_witness))
        sub_constraint.linear_combinations.append((-FieldElement.one(), rhs.inner))
        sub_constraint.q_c = FieldElement(1 << self.width)
        new_opcodes.append(ops.OpcodeArithmetic(sub_constraint))

        two_pow, extra, num_witness = self.get_max_plus_one(num_witness)
        new_opcodes.extend(extra)

        new_opcodes.append(
            ops.OpcodeDirective(
                ops.DirQuotient(
                    ops.QuotientDirective(
                        a=Expression.from_witness(new_witness),
                        b=Expression.from_witness(two_pow.inner),
                        q=q_witness,
                        r=r_witness,
                        predicate=None,
                    )
                )
            )
        )
        new_opcodes.append(
            ops.OpcodeBlackBoxFuncCall(
                ops.BBRange(ops.FunctionInput(r_witness, self.width))
            )
        )
        new_opcodes.append(
            ops.OpcodeBlackBoxFuncCall(
                ops.BBRange(ops.FunctionInput(q_witness, 1))
            )
        )

        return UIntGadget(q_witness, self.width), new_opcodes, num_witness

    def less_than_comparison(self, rhs: "UIntGadget", num_witness: int):
        new_opcodes: Opcodes = []
        comparison, extra, num_witness = self.more_than_eq_comparison(
            rhs, num_witness
        )
        new_opcodes.extend(extra)
        comparison.width = 1
        less_than, extra, num_witness = comparison.not_(num_witness)
        new_opcodes.extend(extra)
        return less_than, new_opcodes, num_witness


def uint8(inner: Witness) -> UIntGadget:
    return UIntGadget(inner, 8)


def uint32(inner: Witness) -> UIntGadget:
    return UIntGadget(inner, 32)


def uint64(inner: Witness) -> UIntGadget:
    return UIntGadget(inner, 64)


def uint32_from_witnesses(
    witnesses: List[Witness], num_witness: int
) -> Tuple[List[UIntGadget], Opcodes, int]:
    """Pack groups of four u8 witnesses big-endian into u32 gadgets
    (uint32.rs:5-29)."""
    return _uint_from_witnesses(witnesses, 32, 4, num_witness)


def uint64_from_witnesses(
    witnesses: List[Witness], num_witness: int
) -> Tuple[List[UIntGadget], Opcodes, int]:
    """Pack groups of eight u8 witnesses big-endian into u64 gadgets
    (uint64.rs analogue of uint32::from_witnesses)."""
    return _uint_from_witnesses(witnesses, 64, 8, num_witness)


def _uint_from_witnesses(witnesses, width, group, num_witness):
    new_opcodes: Opcodes = []
    variables = VariableStore(num_witness)
    uints: List[UIntGadget] = []
    for i in range(len(witnesses) // group):
        new_witness = variables.new_variable()
        uints.append(UIntGadget(new_witness, width))
        expr = Expression.from_witness(new_witness)
        for j in range(group):
            scaling = FieldElement(1 << (8 * (group - 1 - j)))
            expr.linear_combinations.append((-scaling, witnesses[i * group + j]))
        new_opcodes.append(ops.OpcodeArithmetic(expr))
    return uints, new_opcodes, variables.finalize()
