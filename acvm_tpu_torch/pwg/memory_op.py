"""Memory block solver for MemoryInit / MemoryOp opcodes.

Reference: acvm/src/pwg/memory_op.rs — per-BlockId map of index→value with
out-of-bounds errors, predicate masking (pred=0: reads produce zero, writes are
skipped).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..acir.expression import Expression
from ..acir.opcodes import MemOp
from ..acir.witness import Witness, WitnessMap
from ..fields.field import FieldElement
from .arithmetic import ArithmeticSolver
from .errors import IndexOutOfBounds


class MemoryOpSolver:
    def __init__(self):
        self.block_value: Dict[int, FieldElement] = {}
        self.block_len: int = 0

    def _write_memory_index(self, index: int, value: FieldElement) -> None:
        if index >= self.block_len:
            raise IndexOutOfBounds(index=index, array_size=self.block_len)
        self.block_value[index] = value

    def _read_memory_index(self, index: int) -> FieldElement:
        if index not in self.block_value:
            raise IndexOutOfBounds(index=index, array_size=self.block_len)
        return self.block_value[index]

    def init(self, init: List[Witness], witness_map: WitnessMap) -> None:
        from .acvm import witness_to_value

        self.block_len = len(init)
        for memory_index, witness in enumerate(init):
            self._write_memory_index(
                memory_index, witness_to_value(witness_map, witness)
            )

    def solve_memory_op(
        self,
        op: MemOp,
        witness_map: WitnessMap,
        predicate: Optional[Expression],
    ) -> None:
        from .acvm import get_value, insert_value

        operation = get_value(op.operation, witness_map)
        index = get_value(op.index, witness_map)
        memory_index = index.try_to_u64()
        if memory_index is None:
            raise ValueError("memory index does not fit into u64")

        value = ArithmeticSolver.evaluate(op.value, witness_map)
        is_read_operation = operation.is_zero()

        if predicate is not None:
            pred_value = get_value(predicate, witness_map)
        else:
            pred_value = FieldElement.one()

        if is_read_operation:
            value_read_witness = value.to_witness()
            assert value_read_witness is not None, (
                "Memory must be read into a specified witness index, "
                "encountered an Expression"
            )
            if pred_value.is_zero():
                value_in_array = FieldElement.zero()
            else:
                value_in_array = self._read_memory_index(memory_index)
            insert_value(value_read_witness, value_in_array, witness_map)
        else:
            if pred_value.is_zero():
                return
            value_to_write = get_value(value, witness_map)
            self._write_memory_index(memory_index, value_to_write)
