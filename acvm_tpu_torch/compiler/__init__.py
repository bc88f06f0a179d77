"""Backend-targeting compiler passes (reference: acvm/src/compiler/mod.rs).

``compile(circuit, language, is_opcode_supported)`` runs:
Fallback -> GeneralOptimizer (arith only) -> RangeOptimizer -> {R1CS passthrough
| CSat width reduction}, threading opcode positions through every pass to
produce the `AcirTransformationMap` and remapping assert messages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from ..acir.circuit import Circuit, OpcodeLocation
from ..acir.expression import Expression
from ..acir.witness import Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from . import fallback as fallback_pass
from . import general_opt, range_opt
from .csat import CSatTransformer
from .fallback import CompileError, UnsupportedBlackBox, UnsupportedMemoryOpcode


@dataclass(frozen=True)
class R1CS:
    pass


@dataclass(frozen=True)
class PLONKCSat:
    width: int


Language = object  # R1CS | PLONKCSat


class AcirTransformationMap:
    """new opcode index -> old opcode index (compiler/mod.rs:31-59)."""

    def __init__(self, acir_opcode_positions: List[int]):
        self.acir_opcode_positions = list(acir_opcode_positions)

    def new_locations(self, old_location: OpcodeLocation):
        old_acir_index = old_location.acir_index
        for new_index, old_index in enumerate(self.acir_opcode_positions):
            if old_index == old_acir_index:
                if old_location.brillig_index is None:
                    yield OpcodeLocation.acir(new_index)
                else:
                    yield OpcodeLocation.brillig(
                        new_index, old_location.brillig_index
                    )


def transform_assert_messages(assert_messages, transformation_map):
    out = []
    for location, message in assert_messages:
        for new_location in transformation_map.new_locations(location):
            out.append((new_location, message))
    return out


def default_is_opcode_supported(language) -> Callable[[ops.Opcode], bool]:
    """Sensible defaults per language (pwg/mod.rs:374-399)."""
    if isinstance(language, R1CS):
        return lambda opcode: isinstance(opcode, ops.OpcodeArithmetic)
    return lambda opcode: True


def compile(
    acir: Circuit,
    np_language,
    is_opcode_supported: Callable[[ops.Opcode], bool],
    enable_hash_fallbacks: bool = True,
) -> Tuple[Circuit, AcirTransformationMap]:
    acir_opcode_positions = list(range(len(acir.opcodes)))

    # Fallback pass.
    acir, acir_opcode_positions = fallback_pass.transform(
        acir, is_opcode_supported, acir_opcode_positions, enable_hash_fallbacks
    )

    # General optimizer pass (arithmetic opcodes only).
    opcodes = []
    for opcode in acir.opcodes:
        if isinstance(opcode, ops.OpcodeArithmetic):
            opcodes.append(ops.OpcodeArithmetic(general_opt.optimize(opcode.expr)))
        else:
            opcodes.append(opcode)
    acir = Circuit(
        current_witness_index=acir.current_witness_index,
        opcodes=opcodes,
        private_parameters=acir.private_parameters,
        public_parameters=acir.public_parameters,
        return_values=acir.return_values,
        assert_messages=acir.assert_messages,
    )

    # Range optimization pass.
    acir, acir_opcode_positions = range_opt.replace_redundant_ranges(
        acir, acir_opcode_positions
    )

    if isinstance(np_language, R1CS):
        transformation_map = AcirTransformationMap(acir_opcode_positions)
        acir.assert_messages = transform_assert_messages(
            acir.assert_messages, transformation_map
        )
        return acir, transformation_map

    assert isinstance(np_language, PLONKCSat)
    transformer = CSatTransformer(np_language.width)
    for value in acir.circuit_arguments():
        transformer.mark_solvable(value)

    new_acir_opcode_positions: List[int] = []
    transformed_opcodes: List[ops.Opcode] = []
    next_witness_index = [acir.current_witness_index + 1]
    # normalized-expression key -> (normalized expr, (norm, witness)); insertion
    # ordered like the reference IndexMap.
    intermediate_variables: Dict = {}

    for index, opcode in enumerate(acir.opcodes):
        if isinstance(opcode, ops.OpcodeArithmetic):
            start = len(intermediate_variables)
            arith_expr = transformer.transform(
                opcode.expr.clone(), intermediate_variables, next_witness_index
            )
            new_opcodes = []
            for key in list(intermediate_variables)[start:]:
                normalized, (norm, w) = intermediate_variables[key]
                intermediate_opcode = normalized.scale(norm)
                intermediate_opcode.linear_combinations.append(
                    (-FieldElement.one(), w)
                )
                intermediate_opcode.sort()
                new_opcodes.append(intermediate_opcode)
            new_opcodes.append(arith_expr)
            for expr in new_opcodes:
                new_acir_opcode_positions.append(acir_opcode_positions[index])
                transformed_opcodes.append(ops.OpcodeArithmetic(expr))
            continue

        if isinstance(opcode, ops.OpcodeBlackBoxFuncCall):
            for w in opcode.call.get_outputs_vec():
                transformer.mark_solvable(w)
        elif isinstance(opcode, ops.OpcodeDirective):
            d = opcode.directive
            if isinstance(d, ops.DirQuotient):
                transformer.mark_solvable(d.quotient.q)
                transformer.mark_solvable(d.quotient.r)
            elif isinstance(d, ops.DirToLeRadix):
                for w in d.b:
                    transformer.mark_solvable(w)
            elif isinstance(d, ops.DirPermutationSort):
                for w in d.bits:
                    transformer.mark_solvable(w)
        elif isinstance(opcode, ops.OpcodeMemoryInit):
            pass  # MemoryInit does not write to the witness map
        elif isinstance(opcode, ops.OpcodeMemoryOp):
            for _, w1, w2 in opcode.op.value.mul_terms:
                transformer.mark_solvable(w1)
                transformer.mark_solvable(w2)
            for _, w in opcode.op.value.linear_combinations:
                transformer.mark_solvable(w)
        elif isinstance(opcode, ops.OpcodeBrillig):
            for output in opcode.brillig.outputs:
                if isinstance(output, ops.BrilligOutputSimple):
                    transformer.mark_solvable(output.witness)
                else:
                    for w in output.witnesses:
                        transformer.mark_solvable(w)

        new_acir_opcode_positions.append(acir_opcode_positions[index])
        transformed_opcodes.append(opcode)

    current_witness_index = next_witness_index[0] - 1
    transformation_map = AcirTransformationMap(new_acir_opcode_positions)

    result = Circuit(
        current_witness_index=current_witness_index,
        opcodes=transformed_opcodes,
        private_parameters=acir.private_parameters,
        public_parameters=acir.public_parameters,
        return_values=acir.return_values,
        assert_messages=transform_assert_messages(
            acir.assert_messages, transformation_map
        ),
    )
    return result, transformation_map


__all__ = [
    "compile",
    "AcirTransformationMap",
    "transform_assert_messages",
    "default_is_opcode_supported",
    "R1CS",
    "PLONKCSat",
    "CompileError",
    "UnsupportedBlackBox",
    "UnsupportedMemoryOpcode",
    "CSatTransformer",
]
