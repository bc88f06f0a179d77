"""The port's product surface (``api``, ``config``) against the JAX package's,
tolerance 0.

Every acvm_js fixture of ``golden_vectors.py`` (acvm_js/test/shared/*.ts)
runs through the port's ``execute_circuit`` and the JAX package's: the
solved witness maps, the two foreign calls' answers, the error of an
unsatisfied gate with its location and the public-witness extraction must
agree.  ``execute_circuit_batched`` on the CPU must give each instance the
sequential result.  ``EngineConfig`` drives the planner, the compiler and the
solver as the JAX one does, on the device it names.
"""

import logging

import pytest

from acvm_tpu import api as japi
from acvm_tpu.acir import Witness as JWitness, WitnessMap as JWitnessMap
from acvm_tpu.fields import FieldElement as JFieldElement

from acvm_tpu_torch import api
from acvm_tpu_torch.acir import Circuit, Expression, OpcodeLocation, Witness, WitnessMap
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.config import DEFAULT_CONFIG, EngineConfig
from acvm_tpu_torch.fields import FieldElement
from acvm_tpu_torch.gpu import FAIL_NONE
from acvm_tpu_torch.utils.logging import _LEVELS

import golden_vectors as gv


def invert(name, inputs):  # acvm_js/test/shared/foreign_call.ts
    assert name == "invert"
    return [inputs[0][0].inverse()]


def complex_call(name, inputs):  # acvm_js/test/shared/complex_foreign_call.ts
    assert name == "complex"
    arr, total = [int(v) for v in inputs[0]], int(inputs[1][0])
    return [[a * i for a, i in zip(arr, (2, 3, 4))], total, total * 2]


# fixture: (circuit bytes, initial witness, foreign-call handler)
FIXTURES = {
    "addition": (gv.ADDITION_CIRCUIT, {1: 1, 2: 2}, None),
    "memory_op": (gv.MEMORY_OP_CIRCUIT, {1: 1, 2: 1, 3: 2}, None),
    "fixed_base_scalar_mul": (gv.FIXED_BASE_SCALAR_MUL_CIRCUIT, {1: 1, 2: 0}, None),
    "pedersen": (gv.PEDERSEN_CIRCUIT, {1: 1}, None),
    "simple_foreign_call": (gv.SIMPLE_BRILLIG_FOREIGN_CALL, {1: 5}, invert),
    "complex_foreign_call": (gv.COMPLEX_BRILLIG_FOREIGN_CALL, {1: 1, 2: 2, 3: 3}, complex_call),
}


def port_map(values):
    return WitnessMap({Witness(w): FieldElement(v) for w, v in values.items()})


def jax_map(values):
    return JWitnessMap({JWitness(w): JFieldElement(v) for w, v in values.items()})


def as_ints(wm):
    return {int(w): int(v) for w, v in wm}


def jax_handler(handler):
    """The handler over the JAX package's field elements: its answers as
    ints (or lists of ints)."""
    if handler is None:
        return None

    def as_plain(v):
        return [as_plain(x) for x in v] if isinstance(v, (list, tuple)) else int(v)

    return lambda name, inputs: [as_plain(v) for v in handler(
        name, [[FieldElement(int(v)) for v in group] for group in inputs])]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_executes_as_the_jax_package(name):
    data, initial, handler = FIXTURES[name]
    solved = api.execute_circuit(data, port_map(initial), handler)
    want = japi.execute_circuit(data, jax_map(initial), jax_handler(handler))
    assert as_ints(solved) == as_ints(want)
    for extract in ("get_return_witness", "get_public_parameters_witness", "get_public_witness"):
        assert as_ints(getattr(api, extract)(data, solved)) == \
            as_ints(getattr(japi, extract)(data, want)), extract
    # The Nargo witness file of the solved map is the JAX package's.
    assert api.compress_witness(solved) == japi.compress_witness(want)
    assert api.decompress_witness(api.compress_witness(solved)) == solved


def test_pinned_outputs():
    """The acvm_js fixtures' expected outputs."""
    solved = api.execute_circuit(gv.FIXED_BASE_SCALAR_MUL_CIRCUIT, port_map({1: 1, 2: 0}))
    assert (solved.get(Witness(3)).to_hex(), solved.get(Witness(4)).to_hex()) == gv.FIXED_BASE_1_0
    solved = api.execute_circuit(gv.SIMPLE_BRILLIG_FOREIGN_CALL, port_map({1: 5}), invert)
    assert solved.get(Witness(2)).to_hex() == \
        "135b52945a13d9aa49b9b57c33cd568ba9ae5ce9ca4a2d06e7f3fbd4c6666667"
    solved = api.execute_circuit(gv.COMPLEX_BRILLIG_FOREIGN_CALL, {1: 1, 2: "0x02", 3: 3},
                                 complex_call)
    assert as_ints(solved) == {1: 1, 2: 2, 3: 3, 4: 2, 5: 6, 6: 12, 7: 6, 8: 12}


def test_errors_carry_the_jax_package_s_location_and_message():
    with pytest.raises(api.ExecutionError) as exc:
        api.execute_circuit(gv.ADDITION_CIRCUIT, port_map({1: 1, 2: 2, 3: 7}))
    with pytest.raises(japi.ExecutionError) as jexc:
        japi.execute_circuit(gv.ADDITION_CIRCUIT, jax_map({1: 1, 2: 2, 3: 7}))
    assert str(exc.value) == str(jexc.value)
    assert [str(loc) for loc in exc.value.call_stack] == ["0"] == \
        [str(loc) for loc in jexc.value.call_stack]
    # A foreign call with no handler.
    with pytest.raises(api.ExecutionError) as exc:
        api.execute_circuit(gv.SIMPLE_BRILLIG_FOREIGN_CALL, port_map({1: 5}))
    with pytest.raises(japi.ExecutionError) as jexc:
        japi.execute_circuit(gv.SIMPLE_BRILLIG_FOREIGN_CALL, jax_map({1: 5}))
    assert str(exc.value) == str(jexc.value) and exc.value.call_stack is None
    # An assert message embedded in the circuit.
    circuit = api.deserialize_circuit(gv.ADDITION_CIRCUIT)
    circuit.assert_messages = [(OpcodeLocation.acir(0), "sum is wrong")]
    with pytest.raises(api.ExecutionError, match="Assertion failed: sum is wrong"):
        api.execute_circuit(circuit, port_map({1: 1, 2: 2, 3: 7}))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_batched_execution_equals_the_sequential_one(name):
    data, initial, handler = FIXTURES[name]
    inputs = [{w: v + 3 * b for w, v in initial.items()} for b in range(4)]
    res = api.execute_circuit_batched(data, inputs, EngineConfig(device="cpu"),
                                      foreign_call_handler=handler)
    assert str(res.solver.device) == "cpu"
    for b, values in enumerate(inputs):
        want = as_ints(api.execute_circuit(data, port_map(values), handler))
        got = res.instance_ints(b)
        assert res.ok[b] and res.fail[b] == FAIL_NONE
        assert {w: got[w] for w in want} == want


def test_batched_execution_reports_a_failing_instance():
    inputs = [{1: 1, 2: 2, 3: 3}, {1: 1, 2: 2, 3: 7}]
    circuit = Circuit.read(gv.ADDITION_CIRCUIT)
    circuit.private_parameters.add(Witness(3))  # the sum is an input: a check
    res = api.execute_circuit_batched(circuit, inputs, EngineConfig(device="cpu"))
    assert res.ok.tolist() == [True, False]
    assert str(res.error_location(1)) == "0" and res.error_location(0) is None


# -- EngineConfig -------------------------------------------------------------


def _arith_circuit():
    # w2 = w1 + 1
    expr = (Expression.from_witness(Witness(1)) - Expression.from_witness(Witness(2))
            + Expression.from_field(FieldElement(1)))
    return Circuit(current_witness_index=2, opcodes=[ops.OpcodeArithmetic(expr)],
                   private_parameters={Witness(1)})


def _hash_circuit():
    call = ops.BBSha256(inputs=[ops.FunctionInput(Witness(1), 8)],
                        outputs=[Witness(i) for i in range(2, 34)])
    return Circuit(current_witness_index=33, opcodes=[ops.OpcodeBlackBoxFuncCall(call)],
                   private_parameters={Witness(1)})


def test_config_defaults_and_fields():
    assert EngineConfig().device == "cuda" and DEFAULT_CONFIG.device == "cuda"
    assert EngineConfig(field="bn254").field_params().name == "bn254"
    assert EngineConfig(field="bls12_381").field_params().modulus.bit_length() == 255
    with pytest.raises(ValueError, match="unknown field"):
        EngineConfig(field="goldilocks").field_params()
    # BLS12-381 solves on the device's field ops: w1 + w2 + 1 = 0 there.
    config = EngineConfig(field="bls12_381", device="cpu")
    one = FieldElement(1)
    circuit = Circuit(current_witness_index=2, opcodes=[ops.OpcodeArithmetic(Expression(
        linear_combinations=[(one, Witness(1)), (one, Witness(2))], q_c=one))],
        private_parameters={Witness(1)})
    plan = config.plan(circuit)
    p = config.field_params().modulus
    assert plan.params.name == "bls12_381" and p.bit_length() == 255
    assert config.solver(plan).solve([{1: 41}, {1: p - 1}]).witness_ints(2) == [p - 42, 0]


def test_config_plans_and_compiles():
    plan = EngineConfig(device="cpu").plan(_hash_circuit())
    assert any(level.hashes for level in plan.levels)
    plan_host = EngineConfig(device_hash_kernels=False).plan(_hash_circuit())
    assert not any(level.hashes for level in plan_host.levels)
    assert any(level.host for level in plan_host.levels)
    compiled, _ = EngineConfig(width=3).compile(_arith_circuit())
    assert all(isinstance(op, ops.OpcodeArithmetic) for op in compiled.opcodes)
    compiled, _ = EngineConfig(language="r1cs").compile(_arith_circuit())
    assert len(compiled.opcodes) == 1
    with pytest.raises(ValueError):
        EngineConfig(language="groth").compile(_arith_circuit())


def test_config_solver_device_and_mesh():
    config = EngineConfig(device="cpu")
    solver = config.solver(config.plan(_arith_circuit()), max_batch_per_pass=1)
    assert str(solver.device) == "cpu" and solver.max_batch_per_pass() == 1
    assert solver.solve([{1: 41}, {1: 1}]).ok.all()
    # A mesh of the config's distinct devices: the CPU is one.
    sharded = EngineConfig(device="cpu", mesh_shape=(1,)).solver(config.plan(_arith_circuit()))
    assert sharded.mesh.size == 1 and str(sharded.device) == "cpu"
    assert sharded.solve([{1: 41}, {1: 1}]).ok.all()
    with pytest.raises(ValueError, match="mesh_shape"):
        EngineConfig(device="cpu", mesh_shape=(2,)).solver(config.plan(_arith_circuit()))


def test_config_generator_table_does_not_leak_across_configs():
    import acvm_tpu_torch.config as config_mod
    from acvm_tpu_torch.blackbox.grumpkin import (
        clear_external_generators, derive_generator, grumpkin, set_external_generators)

    baseline = derive_generator(0, 0)
    g = grumpkin.generator()
    table = (grumpkin.add(g, g), grumpkin.add(grumpkin.add(g, g), g))
    try:
        EngineConfig(pedersen_generators=table, device="cpu").plan(_arith_circuit())
        assert derive_generator(0, 0) == table[0]
        DEFAULT_CONFIG.plan(_arith_circuit())
        assert derive_generator(0, 0) == baseline
        # A table installed directly survives a config without one.
        set_external_generators(table)
        DEFAULT_CONFIG.plan(_arith_circuit())
        assert derive_generator(0, 0) == table[0]
    finally:
        clear_external_generators()
        config_mod._GENERATORS_FROM_CONFIG = False


def test_build_info_and_log_level():
    import torch

    info = api.build_info()
    assert info["torch"] == torch.__version__ and "jax" not in info
    assert info["devices"] == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    root = logging.getLogger("acvm_tpu_torch")
    api.init_log_level("INFO")
    assert root.level == logging.INFO
    api.init_log_level("bogus")
    assert root.level == logging.ERROR
    api.init_log_level("trace")
    assert root.level == _LEVELS["TRACE"]
    api.init_log_level("OFF")
    assert root.level > logging.CRITICAL
    api.init_log_level("ERROR")
