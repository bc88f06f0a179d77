"""Fresh-witness allocator (reference: stdlib/src/helpers.rs)."""

from __future__ import annotations

from ..acir.witness import Witness


class VariableStore:
    """Tracks the next free witness index while building fallback circuits."""

    def __init__(self, witness_index: int):
        self.witness_index = witness_index

    def new_variable(self) -> Witness:
        witness = Witness(self.witness_index)
        self.witness_index += 1
        return witness

    def finalize(self) -> int:
        return self.witness_index
