"""The ACIR circuit container and opcode locations.

Mirrors ``acir/src/circuit/mod.rs``: ``Circuit`` holds the opcode list, the
highest witness index, public/private parameter index sets, and assert messages
keyed by opcode location.  ``write``/``read`` use the reference wire format —
bincode then gzip (see `acvm_tpu_torch.acir.serialization`).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Set, Tuple

from .opcodes import Opcode
from .witness import Witness


@dataclass(frozen=True)
class OpcodeLocation:
    """Acir(index) when brillig_index is None, else Brillig{acir_index, brillig_index}."""

    acir_index: int
    brillig_index: Optional[int] = None

    @classmethod
    def acir(cls, index: int) -> "OpcodeLocation":
        return cls(index, None)

    @classmethod
    def brillig(cls, acir_index: int, brillig_index: int) -> "OpcodeLocation":
        return cls(acir_index, brillig_index)

    def is_brillig(self) -> bool:
        return self.brillig_index is not None

    def __str__(self) -> str:
        if self.brillig_index is None:
            return str(self.acir_index)
        return f"{self.acir_index}.{self.brillig_index}"

    @classmethod
    def from_str(cls, s: str) -> "OpcodeLocation":
        parts = s.split(".")
        if len(parts) == 1:
            return cls.acir(int(parts[0]))
        if len(parts) == 2:
            return cls.brillig(int(parts[0]), int(parts[1]))
        raise ValueError(f"Invalid opcode location string: {s}")


@dataclass
class PublicInputs:
    """Ordered set of public witness indices (BTreeSet semantics)."""

    witnesses: Set[Witness] = dc_field(default_factory=set)

    def indices(self) -> List[int]:
        return [int(w) for w in sorted(self.witnesses)]

    def contains(self, index: int) -> bool:
        return Witness(index) in self.witnesses

    def union(self, other: "PublicInputs") -> "PublicInputs":
        return PublicInputs(self.witnesses | other.witnesses)

    def __eq__(self, other):
        return isinstance(other, PublicInputs) and self.witnesses == other.witnesses


@dataclass
class Circuit:
    current_witness_index: int = 0
    opcodes: List[Opcode] = dc_field(default_factory=list)
    private_parameters: Set[Witness] = dc_field(default_factory=set)
    public_parameters: PublicInputs = dc_field(default_factory=PublicInputs)
    return_values: PublicInputs = dc_field(default_factory=PublicInputs)
    assert_messages: List[Tuple[OpcodeLocation, str]] = dc_field(default_factory=list)

    def num_vars(self) -> int:
        return self.current_witness_index + 1

    def circuit_arguments(self) -> Set[Witness]:
        return self.private_parameters | self.public_parameters.witnesses

    def public_inputs(self) -> PublicInputs:
        return PublicInputs(
            self.public_parameters.witnesses | self.return_values.witnesses
        )

    def get_assert_message(self, location: OpcodeLocation) -> Optional[str]:
        for loc, message in self.assert_messages:
            if loc == location:
                return message
        return None

    # Wire format (bincode + gzip) — implemented in serialization.py to keep the
    # codec in one place; re-exported here for API parity with the reference.
    def write(self) -> bytes:
        from .serialization import serialize_circuit

        return serialize_circuit(self)

    @classmethod
    def read(cls, data: bytes) -> "Circuit":
        from .serialization import deserialize_circuit

        return deserialize_circuit(data)
