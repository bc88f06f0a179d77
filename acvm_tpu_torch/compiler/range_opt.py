"""RangeOptimizer: keep only the single lowest-bit range constraint per witness.

Reference: acvm/src/compiler/optimizers/redundant_range.rs — two-phase: collect
the minimum bit size per witness, then retain the first opcode carrying that
minimum and drop every other range constraint on the same witness.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..acir.circuit import Circuit
from ..acir.opcodes import BBRange, Opcode, OpcodeBlackBoxFuncCall
from ..acir.witness import Witness


def _extract_range(opcode: Opcode) -> Optional[Tuple[Witness, int]]:
    if isinstance(opcode, OpcodeBlackBoxFuncCall) and isinstance(
        opcode.call, BBRange
    ):
        return opcode.call.input.witness, opcode.call.input.num_bits
    return None


def collect_ranges(circuit: Circuit) -> Dict[Witness, int]:
    lowest: Dict[Witness, int] = {}
    for opcode in circuit.opcodes:
        extracted = _extract_range(opcode)
        if extracted is None:
            continue
        witness, num_bits = extracted
        if witness not in lowest or lowest[witness] > num_bits:
            lowest[witness] = num_bits
    return lowest


def replace_redundant_ranges(
    circuit: Circuit, order_list: List[int]
) -> Tuple[Circuit, List[int]]:
    lowest = collect_ranges(circuit)
    already_seen = set()
    new_order: List[int] = []
    optimized: List[Opcode] = []
    for idx, opcode in enumerate(circuit.opcodes):
        extracted = _extract_range(opcode)
        if extracted is None:
            optimized.append(opcode)
            new_order.append(order_list[idx])
            continue
        witness, num_bits = extracted
        if witness in already_seen:
            continue
        if num_bits <= lowest[witness]:
            already_seen.add(witness)
            new_order.append(order_list[idx])
            optimized.append(opcode)
    new_circuit = Circuit(
        current_witness_index=circuit.current_witness_index,
        opcodes=optimized,
        private_parameters=circuit.private_parameters,
        public_parameters=circuit.public_parameters,
        return_values=circuit.return_values,
        assert_messages=circuit.assert_messages,
    )
    return new_circuit, new_order
