"""HashToField128Security fallback circuit builder.

Reference: stdlib/src/blackbox_fallbacks/hash_to_field.rs — blake2s in gates,
then recompose the 32 digest bytes big-endian into a single field element via
field add/mul hint+constraint pairs.
"""

from __future__ import annotations

from typing import List, Tuple

from .. import brillig as br
from ..acir.expression import Expression
from ..acir.witness import Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from .blake2s import create_blake2s_constraint
from .helpers import VariableStore
from .uint import UIntGadget, _brillig, _single_input
from .utils import byte_decomposition, round_to_nearest_byte


def hash_to_field(
    inputs: List[Tuple[Expression, int]],
    output: Witness,
    num_witness: int,
) -> Tuple[int, List[ops.Opcode]]:
    new_opcodes: List[ops.Opcode] = []
    new_inputs: List[Witness] = []

    for expr, num_bits in inputs:
        num_bytes = round_to_nearest_byte(num_bits)
        extra, extra_inputs, num_witness = byte_decomposition(
            expr, num_bytes, num_witness
        )
        new_opcodes.extend(extra)
        new_inputs.extend(extra_inputs)

    result, num_witness, extra = create_blake2s_constraint(new_inputs, num_witness)
    new_opcodes.extend(extra)

    result_witness, extra, num_witness = _field_from_be_bytes(result, num_witness)
    new_opcodes.extend(extra)

    expr = Expression.from_witness(output)
    expr.linear_combinations.append((-FieldElement.one(), result_witness))
    new_opcodes.append(ops.OpcodeArithmetic(expr))
    return num_witness, new_opcodes


def _field_from_be_bytes(result: List[Witness], num_witness: int):
    new_opcodes: List[ops.Opcode] = []

    acc, extra, num_witness = UIntGadget.load_constant(0, 32, num_witness)
    acc = acc.inner
    new_opcodes.extend(extra)
    const_256, extra, num_witness = UIntGadget.load_constant(256, 32, num_witness)
    const_256 = const_256.inner
    new_opcodes.extend(extra)

    for r in result[:-1]:
        acc, extra, num_witness = _field_addition(acc, r, num_witness)
        new_opcodes.extend(extra)
        acc, extra, num_witness = _field_mul(acc, const_256, num_witness)
        new_opcodes.extend(extra)

    acc, extra, num_witness = _field_addition(acc, result[-1], num_witness)
    new_opcodes.extend(extra)

    return acc, new_opcodes, num_witness


def _field_addition(lhs: Witness, rhs: Witness, num_witness: int):
    new_opcodes: List[ops.Opcode] = []
    variables = VariableStore(num_witness)
    new_witness = variables.new_variable()

    new_opcodes.append(
        _brillig(
            [_single_input(lhs), _single_input(rhs)],
            [ops.BrilligOutputSimple(new_witness)],
            [
                br.OpBinaryFieldOp(
                    br.RegisterIndex(0),
                    br.BinaryFieldOp.Add,
                    br.RegisterIndex(0),
                    br.RegisterIndex(1),
                )
            ],
        )
    )
    num_witness = variables.finalize()

    add_expr = Expression.from_witness(new_witness)
    add_expr.linear_combinations.append((-FieldElement.one(), lhs))
    add_expr.linear_combinations.append((-FieldElement.one(), rhs))
    new_opcodes.append(ops.OpcodeArithmetic(add_expr))

    return new_witness, new_opcodes, num_witness


def _field_mul(lhs: Witness, rhs: Witness, num_witness: int):
    new_opcodes: List[ops.Opcode] = []
    variables = VariableStore(num_witness)
    new_witness = variables.new_variable()

    new_opcodes.append(
        _brillig(
            [_single_input(lhs), _single_input(rhs)],
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
    mul_constraint.mul_terms.append((-FieldElement.one(), lhs, rhs))
    new_opcodes.append(ops.OpcodeArithmetic(mul_constraint))

    return new_witness, new_opcodes, num_witness
