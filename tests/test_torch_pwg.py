"""The port's sequential engine (`acvm_tpu_torch.pwg.ACVM`) against the JAX
package's (`acvm_tpu.pwg.ACVM`), on the CPU, pure Python.

Each case is a circuit built by both packages' classes (the builders' ``lib=``)
or a golden circuit of the JAX package, deserialized by its codec and
translated class by class into the port's (the port has no codec yet), and a
few initial witness maps.  Both engines solve each map, answering foreign
calls with the case's handler (or stopping at the first one without a
handler); the record of each run must be equal: every foreign-call wait
(function and inputs) in order, the final status, the error's kind, message
and opcode location where the run fails, an exception raised out of
``solve`` (the VM's ``ZeroDivisionError`` on an ``UnsignedDiv`` by zero), and
the witness map.
"""

import dataclasses
import enum
import importlib
import types

import numpy as np
import pytest

from acvm_tpu import acir as jacir
from acvm_tpu import brillig as jbr
from acvm_tpu import pwg as jpwg
from acvm_tpu import stdlib as jstdlib
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.blackbox import GrumpkinSolver as JGrumpkinSolver
from acvm_tpu.fields import FieldElement as JFieldElement

from acvm_tpu_torch import brillig as br
from acvm_tpu_torch import pwg
from acvm_tpu_torch.acir import Expression, Witness, WitnessMap
from acvm_tpu_torch.blackbox import GrumpkinSolver
from acvm_tpu_torch.fields.field import FieldElement
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.utils import (
    PORT_CLASSES, array_inputs, brillig_ops_inputs, build_array_circuit,
    build_brillig_ops_circuit, build_sort_circuit, build_u32_circuit, build_uint_ops_circuit,
    oracle_affine, sort_inputs, u32_inputs,
)

import golden_vectors as gv

P = BN254_FR.modulus
JAX_LIB = types.SimpleNamespace(Circuit=jacir.Circuit, Expression=jacir.Expression,
                                Witness=jacir.Witness, FieldElement=JFieldElement, opcodes=jops,
                                brillig=jbr, stdlib=jstdlib)
PORT = types.SimpleNamespace(pwg=pwg, br=br, WitnessMap=WitnessMap, Witness=Witness,
                             FieldElement=FieldElement, backend=GrumpkinSolver)
JAX = types.SimpleNamespace(pwg=jpwg, br=jbr, WitnessMap=jacir.WitnessMap, Witness=jacir.Witness,
                            FieldElement=JFieldElement, backend=JGrumpkinSolver)


def to_port(obj):
    """A JAX-package ACIR object -> the port's class of the same module path
    and name, field by field."""
    if isinstance(obj, JFieldElement):
        return FieldElement(obj.value)
    if isinstance(obj, enum.Enum):
        return port_class(type(obj))[obj.name]
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(to_port(x) for x in obj)
    if isinstance(obj, jacir.Expression):
        return Expression(to_port(obj.mul_terms), to_port(obj.linear_combinations), to_port(obj.q_c))
    if type(obj).__module__.startswith("acvm_tpu."):
        cls = port_class(type(obj))
        if isinstance(obj, int):
            return cls(int(obj))
        assert dataclasses.is_dataclass(obj), type(obj)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    return obj


def port_class(cls):
    module = importlib.import_module("acvm_tpu_torch." + cls.__module__.split(".", 1)[1])
    return getattr(module, cls.__name__)


def run(pkg, circuit, assignment, handler):
    """One engine over one initial map: the record the two must share."""
    wm = pkg.WitnessMap({pkg.Witness(w): pkg.FieldElement(v) for w, v in assignment.items()})
    acvm = pkg.pwg.ACVM(pkg.backend(), circuit.opcodes, wm)
    record = []
    try:
        while acvm.solve() == pkg.pwg.ACVMStatus.REQUIRES_FOREIGN_CALL:
            call = acvm.get_pending_foreign_call()
            inputs = [[v.to_field() for v in group] for group in call.inputs]
            record.append(("wait", acvm.instruction_pointer, call.function,
                           [[int(v) for v in group] for group in inputs]))
            if handler is None:
                break
            values = tuple(
                pkg.br.FcArray(tuple(pkg.br.Value(pkg.FieldElement(int(x))) for x in out))
                if isinstance(out, (list, tuple)) else pkg.br.FcSingle(pkg.br.Value(pkg.FieldElement(int(out))))
                for out in handler(call.function, inputs))
            acvm.resolve_pending_foreign_call(pkg.br.ForeignCallResult(values))
    except Exception as err:  # the VM's panics surface as Python exceptions in both
        record.append(("raised", type(err).__name__, str(err)))
    record.append(("status", acvm.status, acvm.instruction_pointer))
    if acvm.error is not None:
        location = getattr(acvm.error, "opcode_location", None)
        record.append(("error", type(acvm.error).__name__, str(acvm.error), str(location)))
    record.append(("witnesses", sorted((int(w), int(v)) for w, v in acvm.witness_map)))
    return record


def columnar_rows(cols, count):
    return [{w: int(a[b]) for w, a in cols.items()} for b in range(count)]


def invert(name, inputs):  # the golden SIMPLE_BRILLIG_FOREIGN_CALL's oracle
    assert name == "invert"
    return [pow(int(inputs[0][0]), -1, P) if int(inputs[0][0]) else 0]


def complex_call(name, inputs):  # the golden COMPLEX_BRILLIG_FOREIGN_CALL's oracle
    assert name == "complex"
    arr = [int(v) for v in inputs[0]]
    return [[a * i for a, i in zip(arr, (2, 3, 4))], int(inputs[1][0]), 2 * int(inputs[1][0])]


def golden(data):
    def build(lib):
        circuit = jacir.Circuit.read(data)
        return circuit if lib is JAX_LIB else to_port(circuit)
    return build


def sort_case():
    cols, _ = sort_inputs(build_sort_circuit(8), 4, fail_instance=2)
    return columnar_rows(cols, 4)


def array_case():
    small = dict(num_blocks=2, block_size=8, rounds=2, final_reads=1, num_seeds=4)
    cols, _ = array_inputs(build_array_circuit(**small), 4, fail_instance=1)
    return (lambda lib: build_array_circuit(**small, lib=lib)), columnar_rows(cols, 4)


def u32_case():
    small = dict(num_inputs=4, num_rounds=2, units_per_round=4)
    rows = u32_inputs(build_u32_circuit(**small), 3)
    rows[1][1] = 1 << 32  # fails its input's Range
    return (lambda lib: build_u32_circuit(**small, lib=lib)), rows


def brillig_ops_case():
    cols = brillig_ops_inputs(40)
    rows = columnar_rows(cols, 40)
    return build_brillig_ops_circuit, [r for r in rows if r[2] != 0][:2] + [r for r in rows if r[2] == 0][:1]


CASES = {
    "addition": (golden(gv.ADDITION_CIRCUIT), [{1: 1, 2: 2}, {1: P - 1, 2: 5}, {1: 1, 2: 2, 3: 4}], None),
    "simple_foreign_call": (golden(gv.SIMPLE_BRILLIG_FOREIGN_CALL), [{1: 5}, {1: 0}], invert),
    "simple_foreign_call_unanswered": (golden(gv.SIMPLE_BRILLIG_FOREIGN_CALL), [{1: 5}], None),
    "complex_foreign_call": (golden(gv.COMPLEX_BRILLIG_FOREIGN_CALL), [{1: 1, 2: 2, 3: 3}, {1: 7, 2: 0, 3: P - 2}],
                             complex_call),
    # the last map reads into w4, already known with another value
    "memory_op": (golden(gv.MEMORY_OP_CIRCUIT), [{1: 1, 2: 1, 3: 2}, {1: 4, 2: 0, 3: 9}, {1: 1, 2: 5, 3: 2, 4: 7}],
                  None),
    "sort": (lambda lib: build_sort_circuit(8, lib=lib), sort_case(), oracle_affine),
    "sort_unanswered": (lambda lib: build_sort_circuit(4, lib=lib), [{1: 3, 2: 1, 3: 2, 4: 2}], None),
    "array": (*array_case(), None),
    "u32": (*u32_case(), None),
    "brillig_ops": (*brillig_ops_case(), None),
    "uint_ops": (lambda lib: build_uint_ops_circuit(32, lib=lib)[0], [{1: 7, 2: 3}, {1: (1 << 32) - 1, 2: 1}],
                 None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequential_engine_matches_jax_package(name):
    build, rows, handler = CASES[name]
    circuit, jcircuit = build(PORT_CLASSES), build(JAX_LIB)
    assert len(circuit.opcodes) == len(jcircuit.opcodes)
    records = []
    for row in rows:
        got, want = run(PORT, circuit, row, handler), run(JAX, jcircuit, row, handler)
        assert got == want, (name, row)
        records.append(got)
    kinds = {r[0] for rec in records for r in rec}
    # each case reaches what it is there for
    expect = {"simple_foreign_call": "wait", "complex_foreign_call": "wait", "sort": "wait",
              "sort_unanswered": "wait", "simple_foreign_call_unanswered": "wait",
              "addition": "error", "memory_op": "raised", "array": "error", "u32": "error",
              "brillig_ops": "raised"}
    if name in expect:
        assert expect[name] in kinds, (name, records)


def test_translated_golden_circuits_keep_their_opcodes():
    for data in (gv.ADDITION_CIRCUIT, gv.SIMPLE_BRILLIG_FOREIGN_CALL, gv.COMPLEX_BRILLIG_FOREIGN_CALL,
                 gv.MEMORY_OP_CIRCUIT):
        jcircuit = jacir.Circuit.read(data)
        circuit = to_port(jcircuit)
        assert circuit.current_witness_index == jcircuit.current_witness_index
        assert [repr(op) for op in circuit.opcodes] == [repr(op) for op in jcircuit.opcodes]
        assert np.array_equal(sorted(circuit.circuit_arguments()), sorted(jcircuit.circuit_arguments()))
