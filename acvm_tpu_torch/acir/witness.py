"""Witness index newtype and the WitnessMap.

Mirrors ``acir/src/native_types/witness.rs`` and ``witness_map.rs`` from the
reference: a ``Witness`` is a u32 index, and a ``WitnessMap`` is an ordered map
from witness index to field element (BTreeMap semantics — iteration sorted by
index, which the binary serialization relies on).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from ..fields.field import FieldElement


class Witness(int):
    """A witness index (u32 newtype).  Subclasses int so ordering/hashing match
    the reference's derive(Ord, Hash) for free."""

    __slots__ = ()

    def __new__(cls, index: int):
        if index < 0 or index > 0xFFFFFFFF:
            raise ValueError(f"witness index out of u32 range: {index}")
        return super().__new__(cls, index)

    @property
    def witness_index(self) -> int:
        return int(self)

    def __repr__(self) -> str:
        return f"Witness({int(self)})"


class WitnessMap:
    """Sorted witness→value map (reference: BTreeMap<Witness, FieldElement>)."""

    __slots__ = ("_map",)

    def __init__(self, initial: Optional[Dict[Witness, FieldElement]] = None):
        self._map: Dict[Witness, FieldElement] = dict(initial or {})

    def get(self, witness: Witness) -> Optional[FieldElement]:
        return self._map.get(witness)

    def get_index(self, index: int) -> Optional[FieldElement]:
        return self._map.get(Witness(index))

    def contains_key(self, witness: Witness) -> bool:
        return witness in self._map

    def insert(self, witness: Witness, value: FieldElement) -> Optional[FieldElement]:
        old = self._map.get(witness)
        self._map[witness] = value
        return old

    def __getitem__(self, witness: Witness) -> FieldElement:
        return self._map[witness]

    def __contains__(self, witness: Witness) -> bool:
        return witness in self._map

    def __len__(self) -> int:
        return len(self._map)

    def __iter__(self) -> Iterator[Tuple[Witness, FieldElement]]:
        # BTreeMap iteration order: sorted by key.
        for k in sorted(self._map):
            yield k, self._map[k]

    def __eq__(self, other) -> bool:
        return isinstance(other, WitnessMap) and self._map == other._map

    def __repr__(self) -> str:
        inner = ", ".join(f"{int(k)}: {v!r}" for k, v in self)
        return f"WitnessMap({{{inner}}})"

    def copy(self) -> "WitnessMap":
        return WitnessMap(self._map)
