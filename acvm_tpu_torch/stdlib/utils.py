"""Shared circuit-builder utilities (reference: stdlib/src/blackbox_fallbacks/utils.rs):
bit/byte decomposition via ToLeRadix directives plus constraining gates, and
expression multiplication with intermediate witnesses."""

from __future__ import annotations

from typing import List, Tuple

from ..acir.expression import Expression
from ..acir.witness import Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from .helpers import VariableStore


def round_to_nearest_mul_8(num_bits: int) -> int:
    remainder = num_bits % 8
    return num_bits if remainder == 0 else num_bits + 8 - remainder


def round_to_nearest_byte(num_bits: int) -> int:
    return round_to_nearest_mul_8(num_bits) // 8


def mul_with_witness(
    lhs: Expression, rhs: Expression, variables: VariableStore
) -> Expression:
    """lhs * rhs, spilling non-linear operands into fresh witnesses."""
    lhs_is_linear = lhs.is_linear()
    rhs_is_linear = rhs.is_linear()

    if lhs_is_linear and rhs_is_linear:
        product = lhs.mul(rhs)
        assert product is not None
        return product

    lhs_reduced = (
        lhs if lhs_is_linear else Expression.from_witness(variables.new_variable())
    )
    if lhs == rhs:
        product = lhs_reduced.mul(lhs_reduced)
        assert product is not None
        return product
    rhs_reduced = (
        rhs if rhs_is_linear else Expression.from_witness(variables.new_variable())
    )
    product = lhs_reduced.mul(rhs_reduced)
    assert product is not None
    return product


def boolean_expr(expr: Expression, variables: VariableStore) -> Expression:
    """expr^2 - expr (zero iff expr is boolean)."""
    return mul_with_witness(expr, expr, variables) - expr


def bit_decomposition(
    expr: Expression, bit_size: int, num_witness: int
) -> Tuple[List[ops.Opcode], List[Witness], int]:
    """ToLeRadix(2) directive + booleanity + recomposition constraints."""
    new_opcodes: List[ops.Opcode] = []
    variables = VariableStore(num_witness)

    bit_vector = [variables.new_variable() for _ in range(bit_size)]
    new_opcodes.append(
        ops.OpcodeDirective(
            ops.DirToLeRadix(a=expr.clone(), b=list(bit_vector), radix=2)
        )
    )

    binary_exprs = []
    bit_decomp_constraint = expr.clone()
    two_pow = FieldElement.one()
    two = FieldElement(2)
    for bit in bit_vector:
        binary_exprs.append(
            ops.OpcodeArithmetic(
                boolean_expr(Expression.from_witness(bit), variables)
            )
        )
        bit_decomp_constraint.linear_combinations.append((-two_pow, bit))
        two_pow = two * two_pow

    new_opcodes.extend(binary_exprs)
    bit_decomp_constraint.sort()
    new_opcodes.append(ops.OpcodeArithmetic(bit_decomp_constraint))

    return new_opcodes, bit_vector, variables.finalize()


def byte_decomposition(
    expr: Expression, num_bytes: int, num_witness: int
) -> Tuple[List[ops.Opcode], List[Witness], int]:
    """ToLeRadix(256) directive + RANGE(8) per byte + recomposition; returns the
    bytes big-endian first (utils.rs:131-175)."""
    new_opcodes: List[ops.Opcode] = []
    variables = VariableStore(num_witness)

    vector = [variables.new_variable() for _ in range(num_bytes)]
    new_opcodes.append(
        ops.OpcodeDirective(
            ops.DirToLeRadix(a=expr.clone(), b=list(vector), radix=256)
        )
    )
    vector.reverse()

    byte_exprs = []
    decomp_constraint = expr.clone()
    for i, v in enumerate(vector):
        byte_exprs.append(
            ops.OpcodeBlackBoxFuncCall(
                ops.BBRange(ops.FunctionInput(v, 8))
            )
        )
        scaling_factor = FieldElement(256 ** (num_bytes - 1 - i))
        decomp_constraint.linear_combinations.append((-scaling_factor, v))

    new_opcodes.extend(byte_exprs)
    decomp_constraint.sort()
    new_opcodes.append(ops.OpcodeArithmetic(decomp_constraint))

    return new_opcodes, vector, variables.finalize()
