"""The ACVM state machine — sequential partial witness generation.

Reference: acvm/src/pwg/mod.rs:129-357.  This is the bit-exact host engine and
the semantic oracle for the batched solver (`acvm_tpu_torch.gpu`), whose host
stages run it per instance where no batched route exists: one linear
pass over the opcode list, each opcode solving at most one unknown, pausing at
Brillig foreign calls with full state retained, and re-assignments of differing
values surfacing as UnsatisfiedConstrain.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..acir.circuit import OpcodeLocation
from ..acir.expression import Expression
from ..acir.opcodes import (
    BlockId,
    Opcode,
    OpcodeArithmetic,
    OpcodeBlackBoxFuncCall,
    OpcodeBrillig,
    OpcodeDirective,
    OpcodeMemoryInit,
    OpcodeMemoryOp,
)
from ..acir.witness import Witness, WitnessMap
from ..blackbox import BlackBoxFunctionSolver
from ..fields.field import FieldElement
from . import blackbox as blackbox_dispatch
from .arithmetic import ArithmeticSolver
from .brillig_solver import BrilligSolver, ForeignCallWaitInfo
from .directives import solve_directives
from .errors import (
    ACVMStatus,
    IndexOutOfBounds,
    MissingAssignment,
    OpcodeNotSolvable,
    OpcodeResolutionError,
    UnsatisfiedConstrain,
)
from .memory_op import MemoryOpSolver
from .. import brillig as br


def witness_to_value(witness_map: WitnessMap, witness: Witness) -> FieldElement:
    value = witness_map.get(witness)
    if value is None:
        raise MissingAssignment(int(witness))
    return value


def get_value(expr: Expression, witness_map: WitnessMap) -> FieldElement:
    evaluated = ArithmeticSolver.evaluate(expr, witness_map)
    const = evaluated.to_const()
    if const is not None:
        return const
    raise MissingAssignment(int(_any_witness(evaluated)))


def insert_value(
    witness: Witness, value: FieldElement, witness_map: WitnessMap
) -> None:
    old_value = witness_map.insert(witness, value)
    if old_value is not None and old_value != value:
        raise UnsatisfiedConstrain()


def _any_witness(expr: Expression) -> Witness:
    if expr.linear_combinations:
        return expr.linear_combinations[0][1]
    return expr.mul_terms[0][1]


class ACVM:
    def __init__(
        self,
        backend: BlackBoxFunctionSolver,
        opcodes: List[Opcode],
        initial_witness: WitnessMap,
    ):
        self.status = ACVMStatus.SOLVED if not opcodes else ACVMStatus.IN_PROGRESS
        self.backend = backend
        self.block_solvers: Dict[int, MemoryOpSolver] = {}
        self.opcodes = opcodes
        self.instruction_pointer = 0
        self.witness_map = initial_witness
        self.error: Optional[OpcodeResolutionError] = None
        self.pending_foreign_call: Optional[ForeignCallWaitInfo] = None
        # Per-execution foreign-call replay lists, keyed by opcode index and
        # seeded lazily from the circuit-embedded results.  The reference
        # consumes its opcode list per execution (acvm/src/pwg/mod.rs:139-152),
        # so oracle results must die with this ACVM — never be written back to
        # the caller's (possibly shared, possibly re-executed) Circuit.
        self._foreign_call_results: Dict[int, List[br.ForeignCallResult]] = {}

    def finalize(self) -> WitnessMap:
        if self.status != ACVMStatus.SOLVED:
            raise RuntimeError(f"ACVM execution is not complete: ({self.status})")
        return self.witness_map

    def get_pending_foreign_call(self) -> Optional[ForeignCallWaitInfo]:
        return self.pending_foreign_call

    def resolve_pending_foreign_call(self, result: br.ForeignCallResult) -> None:
        if self.status != ACVMStatus.REQUIRES_FOREIGN_CALL:
            raise RuntimeError(
                "ACVM is not expecting a foreign call response as no call was made"
            )
        opcode = self.opcodes[self.instruction_pointer]
        assert isinstance(opcode, OpcodeBrillig), (
            "ACVM can only enter RequiresForeignCall state on a Brillig opcode"
        )
        self._foreign_call_results.setdefault(
            self.instruction_pointer, list(opcode.brillig.foreign_call_results)
        ).append(result)
        self.pending_foreign_call = None
        self.status = ACVMStatus.IN_PROGRESS

    def solve(self) -> str:
        while self.status == ACVMStatus.IN_PROGRESS:
            self.solve_opcode()
        return self.status

    def solve_opcode(self) -> str:
        opcode = self.opcodes[self.instruction_pointer]
        try:
            if isinstance(opcode, OpcodeArithmetic):
                ArithmeticSolver.solve(self.witness_map, opcode.expr)
            elif isinstance(opcode, OpcodeBlackBoxFuncCall):
                blackbox_dispatch.solve(self.backend, self.witness_map, opcode.call)
            elif isinstance(opcode, OpcodeDirective):
                solve_directives(self.witness_map, opcode.directive)
            elif isinstance(opcode, OpcodeMemoryInit):
                solver = self.block_solvers.setdefault(
                    opcode.block_id.id, MemoryOpSolver()
                )
                solver.init(opcode.init, self.witness_map)
            elif isinstance(opcode, OpcodeMemoryOp):
                solver = self.block_solvers.setdefault(
                    opcode.block_id.id, MemoryOpSolver()
                )
                solver.solve_memory_op(opcode.op, self.witness_map, opcode.predicate)
            elif isinstance(opcode, OpcodeBrillig):
                foreign_call = BrilligSolver.solve(
                    self.witness_map,
                    opcode.brillig,
                    self.backend,
                    self.instruction_pointer,
                    self._foreign_call_results.get(self.instruction_pointer),
                )
                if foreign_call is not None:
                    self.pending_foreign_call = foreign_call
                    self.status = ACVMStatus.REQUIRES_FOREIGN_CALL
                    return self.status
            else:
                raise TypeError(opcode)
        except OpcodeResolutionError as error:
            # Back-fill the opcode location on location-less constraint errors
            # (pwg/mod.rs:282-299).
            if isinstance(error, (IndexOutOfBounds, UnsatisfiedConstrain)):
                if error.opcode_location is None:
                    error.opcode_location = OpcodeLocation.acir(
                        self.instruction_pointer
                    )
            self.error = error
            self.status = ACVMStatus.FAILURE
            return self.status

        self.instruction_pointer += 1
        if self.instruction_pointer == len(self.opcodes):
            self.status = ACVMStatus.SOLVED
        else:
            self.status = ACVMStatus.IN_PROGRESS
        return self.status
