from .acvm import ACVM, get_value, insert_value, witness_to_value
from .arithmetic import ArithmeticSolver
from .brillig_solver import BrilligSolver, ForeignCallWaitInfo
from .directives import solve_directives
from .errors import (
    ACVMStatus,
    BlackBoxFunctionFailed,
    BrilligFunctionFailed,
    ExpressionHasTooManyUnknowns,
    IndexOutOfBounds,
    MissingAssignment,
    OpcodeNotSolvable,
    OpcodeResolutionError,
    UnsatisfiedConstrain,
    UnsupportedBlackBoxFunc,
)
from .memory_op import MemoryOpSolver
from .sorting import route

__all__ = [
    "ACVM",
    "ACVMStatus",
    "ArithmeticSolver",
    "BrilligSolver",
    "ForeignCallWaitInfo",
    "MemoryOpSolver",
    "route",
    "solve_directives",
    "get_value",
    "insert_value",
    "witness_to_value",
    "OpcodeResolutionError",
    "OpcodeNotSolvable",
    "MissingAssignment",
    "ExpressionHasTooManyUnknowns",
    "UnsupportedBlackBoxFunc",
    "UnsatisfiedConstrain",
    "IndexOutOfBounds",
    "BlackBoxFunctionFailed",
    "BrilligFunctionFailed",
]
