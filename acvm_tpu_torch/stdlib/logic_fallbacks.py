"""ACIR gate fallbacks for RANGE / AND / XOR.

Reference: stdlib/src/blackbox_fallbacks/logic_fallbacks.rs — range via bit
decomposition (1-bit special case is a booleanity gate), AND as
sum 2^i * a_i * b_i, XOR as sum 2^i (a_i + b_i - 2 a_i b_i).
"""

from __future__ import annotations

from typing import List, Tuple

from ..acir.expression import Expression
from ..acir.witness import Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from .helpers import VariableStore
from .utils import bit_decomposition, boolean_expr, mul_with_witness


def range_fallback(
    expr: Expression, bit_size: int, num_witness: int
) -> Tuple[int, List[ops.Opcode]]:
    if bit_size == 1:
        variables = VariableStore(num_witness)
        bit_constraint = ops.OpcodeArithmetic(boolean_expr(expr, variables))
        return variables.finalize(), [bit_constraint]
    new_opcodes, _, updated = bit_decomposition(expr, bit_size, num_witness)
    return updated, new_opcodes


def and_fallback(
    a: Expression, b: Expression, result: Witness, bit_size: int, num_witness: int
) -> Tuple[int, List[ops.Opcode]]:
    if bit_size == 1:
        variables = VariableStore(num_witness)
        and_expr = mul_with_witness(a, b, variables)
        and_expr.linear_combinations.append((-FieldElement.one(), result))
        return variables.finalize(), [ops.OpcodeArithmetic(and_expr)]

    extra_a, a_bits, updated = bit_decomposition(a, bit_size, num_witness)
    extra_b, b_bits, updated = bit_decomposition(b, bit_size, updated)
    assert len(a_bits) == len(b_bits) == bit_size

    two_pow = FieldElement.one()
    two = FieldElement(2)
    and_expr = Expression()
    for a_bit, b_bit in zip(a_bits, b_bits):
        and_expr.mul_terms.append((two_pow, a_bit, b_bit))
        two_pow = two * two_pow
    and_expr.linear_combinations.append((-FieldElement.one(), result))
    and_expr.sort()

    return updated, [*extra_a, *extra_b, ops.OpcodeArithmetic(and_expr)]


def xor_fallback(
    a: Expression, b: Expression, result: Witness, bit_size: int, num_witness: int
) -> Tuple[int, List[ops.Opcode]]:
    if bit_size == 1:
        variables = VariableStore(num_witness)
        product = mul_with_witness(a, b, variables)
        xor_expr = (a + b) - product
        xor_expr.linear_combinations.append((-FieldElement.one(), result))
        return variables.finalize(), [ops.OpcodeArithmetic(xor_expr)]

    extra_a, a_bits, updated = bit_decomposition(a, bit_size, num_witness)
    extra_b, b_bits, updated = bit_decomposition(b, bit_size, updated)
    assert len(a_bits) == len(b_bits) == bit_size

    two_pow = FieldElement.one()
    two = FieldElement(2)
    xor_expr = Expression()
    for a_bit, b_bit in zip(a_bits, b_bits):
        xor_expr.linear_combinations.append((two_pow, a_bit))
        xor_expr.linear_combinations.append((two_pow, b_bit))
        two_pow = two * two_pow
        xor_expr.mul_terms.append((-two_pow, a_bit, b_bit))
    xor_expr.linear_combinations.append((-FieldElement.one(), result))
    xor_expr.sort()

    return updated, [*extra_a, *extra_b, ops.OpcodeArithmetic(xor_expr)]
