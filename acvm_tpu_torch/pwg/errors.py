"""ACVM status and error model (reference: acvm/src/pwg/mod.rs:33-127)."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from ..acir.circuit import OpcodeLocation
from ..acir.opcodes import BlackBoxFunc


class ACVMStatus:
    SOLVED = "solved"
    IN_PROGRESS = "in_progress"
    FAILURE = "failure"
    REQUIRES_FOREIGN_CALL = "requires_foreign_call"


class OpcodeResolutionError(Exception):
    """Base for all solver failures."""


class OpcodeNotSolvable(OpcodeResolutionError):
    pass


class MissingAssignment(OpcodeNotSolvable):
    def __init__(self, witness_index: int):
        self.witness_index = witness_index
        super().__init__(f"missing assignment for witness index {witness_index}")


class ExpressionHasTooManyUnknowns(OpcodeNotSolvable):
    def __init__(self, expr):
        self.expr = expr
        super().__init__(f"expression has too many unknowns {expr!r}")


class UnsupportedBlackBoxFunc(OpcodeResolutionError):
    def __init__(self, func: BlackBoxFunc):
        self.func = func
        super().__init__(
            f"Backend does not currently support the {func.func_name()} opcode. "
            "ACVM does not currently have a fallback for this opcode."
        )


class UnsatisfiedConstrain(OpcodeResolutionError):
    def __init__(self, opcode_location: Optional[OpcodeLocation] = None):
        self.opcode_location = opcode_location  # None == ErrorLocation::Unresolved
        super().__init__("Cannot satisfy constraint")


class IndexOutOfBounds(OpcodeResolutionError):
    def __init__(
        self,
        index: int,
        array_size: int,
        opcode_location: Optional[OpcodeLocation] = None,
    ):
        self.index = index
        self.array_size = array_size
        self.opcode_location = opcode_location
        super().__init__(
            f"Index out of bounds, array has size {array_size}, but index was {index}"
        )


class BlackBoxFunctionFailed(OpcodeResolutionError):
    def __init__(self, func: BlackBoxFunc, reason: str):
        self.func = func
        self.reason = reason
        super().__init__(
            f"Failed to solve blackbox function: {func.func_name()}, reason: {reason}"
        )


class BrilligFunctionFailed(OpcodeResolutionError):
    def __init__(self, message: str, call_stack: List[OpcodeLocation]):
        self.message = message
        self.call_stack = call_stack
        super().__init__(f"Failed to solve brillig function, reason: {message}")
