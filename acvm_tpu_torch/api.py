"""Product API surface — the Python analogue of the reference's ``acvm_js``
bindings (``acvm_js/src/{execute,public_witness,compression,foreign_call}.rs``).

Provides:

* :func:`execute_circuit` — run a serialized (or in-memory) circuit against an
  initial witness, resolving Brillig foreign calls through a user callback.
* :func:`execute_circuit_batched` — solve a batch of instances on the
  batched engine (:mod:`acvm_tpu_torch.gpu`) under an
  :class:`~acvm_tpu_torch.config.EngineConfig`, streaming a batch larger
  than one pass.
* :func:`compress_witness` / :func:`decompress_witness` — the Nargo
  gzip(bincode) witness format.
* :func:`get_return_witness` / :func:`get_public_parameters_witness` /
  :func:`get_public_witness` — public-input extraction.
* :class:`ExecutionError` — failure with resolved call stack and circuit-embedded
  assert message.
* :func:`init_log_level` and :func:`build_info`.

Foreign-call handlers receive ``(name, inputs)`` where ``inputs`` is a list of
lists of :class:`FieldElement` and must return a list whose items are either a
single FieldElement/int/hex-string (register output) or a list of them (array
output), mirroring the JS ``ForeignCallHandler`` contract.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

from . import brillig as br
from .acir.circuit import Circuit, OpcodeLocation
from .acir.serialization import (
    compress_witness,
    decompress_witness,
    deserialize_circuit,
)
from .acir.witness import Witness, WitnessMap
from .blackbox import BlackBoxFunctionSolver, GrumpkinSolver
from .fields.field import FieldElement
from .pwg import ACVM, ACVMStatus
from .pwg.errors import (
    BrilligFunctionFailed,
    IndexOutOfBounds,
    OpcodeResolutionError,
    UnsatisfiedConstrain,
)

ForeignCallValue = Union[FieldElement, int, str]
ForeignCallHandler = Callable[[str, List[List[FieldElement]]], Sequence[object]]


class ExecutionError(Exception):
    """Execution failure carrying the resolved opcode call stack
    (acvm_js/src/js_execution_error.rs)."""

    def __init__(self, message: str, call_stack: Optional[List[OpcodeLocation]]):
        super().__init__(message)
        self.call_stack = call_stack


def create_black_box_solver() -> BlackBoxFunctionSolver:
    return GrumpkinSolver()


def init_log_level(level: str) -> None:
    """Set the package logging level (acvm_js/src/logging.rs ``initLogLevel``
    analogue; levels OFF/ERROR/WARN/INFO/DEBUG/TRACE)."""
    from .utils.logging import init_log_level as _init

    _init(level)


def build_info() -> dict:
    """Version / environment report (acvm_js/src/build_info.rs analogue): the
    package, the PyTorch build, the CUDA devices it sees and the host Grumpkin
    library (``native_kernels``: its file, built here if need be; a failed
    build raises)."""
    import torch

    from . import __version__, native

    cuda = torch.cuda.is_available()
    return {
        "version": __version__,
        "reference": "noir-lang/acvm v0.27.0",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "devices": torch.cuda.device_count() if cuda else 0,
        "native_kernels": native.load()._name,
    }


def _to_field(value: ForeignCallValue) -> FieldElement:
    if isinstance(value, FieldElement):
        return value
    if isinstance(value, int):
        return FieldElement(value)
    if isinstance(value, str):
        f = FieldElement.from_hex(value)
        if f is None:
            raise ValueError(f"invalid hex field element: {value!r}")
        return f
    raise TypeError(f"cannot convert {value!r} to a field element")


def _decode_foreign_call_result(outputs: Sequence[object]) -> br.ForeignCallResult:
    values = []
    for output in outputs:
        if isinstance(output, (list, tuple)):
            values.append(br.FcArray(tuple(br.Value(_to_field(v)) for v in output)))
        else:
            values.append(br.FcSingle(br.Value(_to_field(output))))
    return br.ForeignCallResult(tuple(values))


def _get_assert_message(circuit: Circuit, location: OpcodeLocation) -> Optional[str]:
    return circuit.get_assert_message(location)


def _to_witness_map(initial) -> WitnessMap:
    """Coerce the initial witness into a WitnessMap: accepts a WitnessMap or
    any {index-or-Witness: int/hex/FieldElement} mapping (the JS bindings'
    Map<number, hex> analogue, acvm_js/src/js_witness_map.rs:9-72)."""
    if isinstance(initial, WitnessMap):
        return initial.copy()
    wm = WitnessMap()
    for k, v in dict(initial).items():
        witness = k if isinstance(k, Witness) else Witness(int(k))
        wm.insert(witness, _to_field(v))
    return wm


def execute_circuit(
    circuit: Union[Circuit, bytes],
    initial_witness: WitnessMap,
    foreign_call_handler: Optional[ForeignCallHandler] = None,
    solver: Optional[BlackBoxFunctionSolver] = None,
) -> WitnessMap:
    """Solve every opcode of ``circuit``; returns the full witness map.

    Mirrors ``executeCircuit`` (acvm_js/src/execute.rs:38-123): loops the ACVM,
    dispatches foreign calls to the handler, and converts failures into
    :class:`ExecutionError` with assert-message lookup and call stack.
    """
    if isinstance(circuit, (bytes, bytearray, memoryview)):
        circuit = deserialize_circuit(bytes(circuit))
    if solver is None:
        solver = GrumpkinSolver()

    acvm = ACVM(solver, circuit.opcodes, _to_witness_map(initial_witness))

    while True:
        status = acvm.solve()
        if status == ACVMStatus.SOLVED:
            break
        if status == ACVMStatus.FAILURE:
            error = acvm.error
            assert_message: Optional[str] = None
            call_stack: Optional[List[OpcodeLocation]] = None
            if isinstance(error, (UnsatisfiedConstrain, IndexOutOfBounds)):
                if error.opcode_location is not None:
                    assert_message = _get_assert_message(
                        circuit, error.opcode_location
                    )
                    call_stack = [error.opcode_location]
            elif isinstance(error, BrilligFunctionFailed):
                failing = error.call_stack[-1]
                assert_message = _get_assert_message(circuit, failing)
                call_stack = list(error.call_stack)
            if assert_message is not None:
                raise ExecutionError(
                    f"Assertion failed: {assert_message}", call_stack
                )
            raise ExecutionError(str(error), call_stack)
        if status == ACVMStatus.REQUIRES_FOREIGN_CALL:
            wait = acvm.get_pending_foreign_call()
            if foreign_call_handler is None:
                raise ExecutionError(
                    f"circuit requires foreign call {wait.function!r} but no "
                    "handler was provided",
                    None,
                )
            inputs = [[v.to_field() for v in group] for group in wait.inputs]
            outputs = foreign_call_handler(wait.function, inputs)
            acvm.resolve_pending_foreign_call(_decode_foreign_call_result(outputs))
            continue
        raise AssertionError("Execution should not stop while in-progress")

    return acvm.finalize()


def execute_circuit_batched(
    circuit: Union[Circuit, bytes],
    input_values,
    config=None,
    foreign_call_handler: Optional[ForeignCallHandler] = None,
    solver: Optional[BlackBoxFunctionSolver] = None,
    stats=None,
    **solver_options,
):
    """Solve ``circuit`` for a batch of instances on the batched engine.

    ``input_values`` is any input form
    :meth:`acvm_tpu_torch.gpu.BatchSolver.solve` takes (one
    ``{witness_index: int}`` dict per instance, columns, or a packed matrix);
    ``config`` (an :class:`acvm_tpu_torch.config.EngineConfig`) selects the
    field, the device, the mesh (``mesh_shape``) and the kernel policy; ``solver_options`` go to the
    solver (``max_batch_per_pass``, ``pass_budget_bytes``, ...).  A batch
    larger than one pass is streamed, and its result then carries every
    instance's flags and no panel.  Returns the
    :class:`acvm_tpu_torch.gpu.batch_solver.BatchResult`.
    """
    from .config import DEFAULT_CONFIG

    config = config or DEFAULT_CONFIG
    circuit = _as_circuit(circuit)
    plan = config.plan(circuit)
    batch_solver = config.solver(
        plan,
        backend=solver,
        foreign_call_handler=foreign_call_handler,
        **solver_options,
    )
    return batch_solver.solve(input_values, stats=stats)


def _extract_indices(witness_map: WitnessMap, indices: List[Witness]) -> WitnessMap:
    extracted = WitnessMap()
    for witness in indices:
        value = witness_map.get(witness)
        if value is None:
            raise KeyError(
                f"Failed to extract witness {int(witness)} from witness map. "
                "Witness not found."
            )
        extracted.insert(witness, value)
    return extracted


def _as_circuit(circuit: Union[Circuit, bytes]) -> Circuit:
    if isinstance(circuit, (bytes, bytearray, memoryview)):
        return deserialize_circuit(bytes(circuit))
    return circuit


def get_return_witness(
    circuit: Union[Circuit, bytes], witness_map: WitnessMap
) -> WitnessMap:
    circuit = _as_circuit(circuit)
    return _extract_indices(witness_map, sorted(circuit.return_values.witnesses))


def get_public_parameters_witness(
    circuit: Union[Circuit, bytes], witness_map: WitnessMap
) -> WitnessMap:
    circuit = _as_circuit(circuit)
    return _extract_indices(witness_map, sorted(circuit.public_parameters.witnesses))


def get_public_witness(
    circuit: Union[Circuit, bytes], witness_map: WitnessMap
) -> WitnessMap:
    circuit = _as_circuit(circuit)
    return _extract_indices(
        witness_map, sorted(circuit.public_inputs().witnesses)
    )


__all__ = [
    "ExecutionError",
    "build_info",
    "ForeignCallHandler",
    "compress_witness",
    "create_black_box_solver",
    "decompress_witness",
    "execute_circuit",
    "execute_circuit_batched",
    "get_public_parameters_witness",
    "get_public_witness",
    "get_return_witness",
    "init_log_level",
]
