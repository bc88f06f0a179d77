"""BrilligSolver: bridges ACIR Brillig opcodes to the Brillig VM.

Reference: acvm/src/pwg/brillig.rs — predicate gating (0 => outputs zeroed),
input Expression evaluation into registers / flattened array memory, VM run,
and status mapping (Finished => write outputs; ForeignCallWait => bubble wait
info; Failure => BrilligFunctionFailed with acir-indexed call stack).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .. import brillig as br
from ..acir.circuit import OpcodeLocation
from ..acir.opcodes import (
    Brillig,
    BrilligInputArray,
    BrilligInputSingle,
    BrilligOutputArray,
    BrilligOutputSimple,
)
from ..acir.witness import WitnessMap
from ..blackbox import BlackBoxFunctionSolver
from ..brillig_vm import VM, Registers, VMStatus
from ..fields.field import FieldElement
from .errors import (
    BrilligFunctionFailed,
    ExpressionHasTooManyUnknowns,
    OpcodeResolutionError,
)


@dataclass
class ForeignCallWaitInfo:
    function: str
    inputs: List[List[br.Value]]


class BrilligSolver:
    @staticmethod
    def solve(
        witness_map: WitnessMap,
        brillig: Brillig,
        bb_solver: BlackBoxFunctionSolver,
        acir_index: int,
        foreign_call_results: Optional[List[br.ForeignCallResult]] = None,
    ) -> Optional[ForeignCallWaitInfo]:
        """Solve one Brillig opcode.

        ``foreign_call_results`` is the per-*execution* oracle replay list.
        The reference never reuses a solved opcode list (acvm/src/pwg/mod.rs:
        139-152 takes opcodes by value per execution; acvm_js/src/execute.rs:
        44-55 deserializes a fresh circuit per call), so results accumulated
        while solving one instance must not leak into another.  Callers that
        resume after a foreign call own this list; when absent we replay only
        the circuit-embedded results, without mutating the opcode.
        """
        from .acvm import get_value, insert_value

        if brillig.predicate is not None:
            pred_value = get_value(brillig.predicate, witness_map)
        else:
            pred_value = FieldElement.one()

        if pred_value.is_zero():
            BrilligSolver._zero_out_outputs(witness_map, brillig)
            return None

        input_register_values: List[br.Value] = []
        input_memory: List[br.Value] = []
        for inp in brillig.inputs:
            if isinstance(inp, BrilligInputSingle):
                try:
                    value = get_value(inp.expr, witness_map)
                except OpcodeResolutionError:
                    raise ExpressionHasTooManyUnknowns(inp.expr)
                input_register_values.append(br.Value(value))
            elif isinstance(inp, BrilligInputArray):
                memory_pointer = len(input_memory)
                for expr in inp.exprs:
                    try:
                        value = get_value(expr, witness_map)
                    except OpcodeResolutionError:
                        raise ExpressionHasTooManyUnknowns(expr)
                    input_memory.append(br.Value(value))
                input_register_values.append(br.Value.from_int(memory_pointer))
            else:
                raise TypeError(inp)

        if foreign_call_results is None:
            foreign_call_results = list(brillig.foreign_call_results)
        vm = VM(
            Registers(input_register_values),
            input_memory,
            brillig.bytecode,
            list(foreign_call_results),
            bb_solver,
        )
        status = vm.process_opcodes()

        if status == VMStatus.FINISHED:
            for i, output in enumerate(brillig.outputs):
                register_value = vm.registers.get(br.RegisterIndex(i))
                if isinstance(output, BrilligOutputSimple):
                    insert_value(output.witness, register_value.to_field(), witness_map)
                elif isinstance(output, BrilligOutputArray):
                    base = register_value.to_usize()
                    memory = vm.get_memory()
                    for j, witness in enumerate(output.witnesses):
                        insert_value(witness, memory[base + j].to_field(), witness_map)
                else:
                    raise TypeError(output)
            return None

        if status == VMStatus.FOREIGN_CALL_WAIT:
            wait = vm.status_data
            return ForeignCallWaitInfo(wait.function, wait.inputs)

        if status == VMStatus.FAILURE:
            failure = vm.status_data
            raise BrilligFunctionFailed(
                failure.message,
                [
                    OpcodeLocation.brillig(acir_index, brillig_index)
                    for brillig_index in failure.call_stack
                ],
            )

        raise AssertionError("Brillig VM has not completed execution")

    @staticmethod
    def _zero_out_outputs(witness_map: WitnessMap, brillig: Brillig) -> None:
        from .acvm import insert_value

        for output in brillig.outputs:
            if isinstance(output, BrilligOutputSimple):
                insert_value(output.witness, FieldElement.zero(), witness_map)
            elif isinstance(output, BrilligOutputArray):
                for witness in output.witnesses:
                    insert_value(witness, FieldElement.zero(), witness_map)
            else:
                raise TypeError(output)
