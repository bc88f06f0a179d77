"""The port's solver on FixedBaseScalarMul, Pedersen and SchnorrVerify circuits,
on the CPU, against the JAX `BatchSolver`, the sequential engine `pwg.ACVM` and
the host curve code.  Witnesses, `ok` flags and first-failure opcode indices
must be equal bit for bit.

The circuits are the reference's own serialized test circuits
(`tests/golden_vectors.py`), rebuilt with the port's classes (the port reads no
serialized circuit yet) and checked to name the same witnesses.  Each JAX solve
compiles one program of a whole MSM tree (a quarter of a minute on a CPU), so
the JAX `BatchSolver` runs on the fixed-base and the one-input Pedersen circuit,
two instances a solve; the two-input Pedersen circuit and the Schnorr circuit
are held to the sequential engine.  `ec.schnorr_verify_batched` of the JAX
package (its own test of it is marked slow) is not run here.
"""

import random

import numpy as np
import pytest
import torch

from acvm_tpu.acir import Expression as JExpression
from acvm_tpu.acir import Witness as JWitness, WitnessMap as JWitnessMap
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.acir.circuit import Circuit as JCircuit
from acvm_tpu.acir.serialization import deserialize_circuit
from acvm_tpu.blackbox import GrumpkinSolver
from acvm_tpu.blackbox import grumpkin as jgk
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.pwg import ACVM, ACVMStatus
from acvm_tpu.tpu import BatchSolver as JBatchSolver, plan_circuit as jplan_circuit
from acvm_tpu.utils import bench_circuits as jbench

import golden_vectors as gv

from acvm_tpu_torch import convert
from acvm_tpu_torch.acir import Circuit, Expression, Witness
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.blackbox import grumpkin as gk
from acvm_tpu_torch.blackbox.ec import grumpkin
from acvm_tpu_torch.fields.field import FieldElement
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, plan_circuit
from acvm_tpu_torch.utils import bench_circuits as bench

P = BN254_FR.modulus
N_ORDER = grumpkin.params.n
G = grumpkin.generator()



def sequential(jcircuit, assignment):
    wm = JWitnessMap()
    for k, v in assignment.items():
        wm.insert(JWitness(k), JFieldElement(v))
    acvm = ACVM(GrumpkinSolver(), jcircuit.opcodes, wm)
    return acvm.solve(), acvm


def assert_equals_sequential(jcircuit, inputs, res, num_solved):
    """Witnesses, `ok` and the first failing opcode against `pwg.ACVM`."""
    for b, assignment in enumerate(inputs):
        status, acvm = sequential(jcircuit, assignment)
        if status == ACVMStatus.SOLVED:
            assert res.ok[b] and res.fail[b] == FAIL_NONE and res.error_location(b) is None
            got = res.instance_ints(b)
            solved = list(acvm.finalize())
            assert len(solved) == num_solved
            assert all(got[int(w)] == int(v) for w, v in solved), b
        else:
            assert status == ACVMStatus.FAILURE and not res.ok[b]
            # a failed black-box call carries no location: the engine stops on it
            location = getattr(acvm.error, "opcode_location", None)
            index = acvm.instruction_pointer if location is None else location.acir_index
            assert int(res.fail[b]) == index == res.error_location(b).acir_index


def assert_equals_jax_solver(jcircuit, inputs, res):
    """Panel, `ok` and `fail` against the JAX BatchSolver, two instances a
    solve (the batch shape `tests/test_tpu_ec.py` compiles)."""
    jsolver = JBatchSolver(jplan_circuit(jcircuit))
    nw = res.panel.shape[0]
    for lo in range(0, len(inputs), 2):
        jres = jsolver.solve(inputs[lo : lo + 2])
        assert np.array_equal(convert.panel_from_jax(np.asarray(jres.W), num_witnesses=nw),
                              res.panel[:, lo : lo + 2].numpy())
        assert np.array_equal(jres.ok, res.ok[lo : lo + 2])
        assert np.array_equal(jres.fail, res.fail[lo : lo + 2])


def fn_input(w, bits):
    return ops.FunctionInput(Witness(w), bits)


def test_fixed_base_circuit_matches_jax_solver_sequential_engine_and_golden_vectors():
    jcircuit = deserialize_circuit(gv.FIXED_BASE_SCALAR_MUL_CIRCUIT)
    circuit = Circuit(
        current_witness_index=jcircuit.current_witness_index,
        opcodes=[ops.OpcodeBlackBoxFuncCall(ops.BBFixedBaseScalarMul(
            low=fn_input(1, 128), high=fn_input(2, 128), outputs=(Witness(3), Witness(4))))],
        private_parameters={Witness(1), Witness(2)},
    )
    call = jcircuit.opcodes[0].call
    assert (int(call.low.witness), int(call.high.witness), [int(w) for w in call.outputs]) == (
        1, 2, [3, 4])
    lo128 = (1 << 128) - 1
    inputs = [
        {1: 1, 2: 0}, {1: 1, 2: 2},                    # the golden vectors
        {1: 1, 2: 0}, {1: 1 << 130, 2: 0},            # a limb past 2^128
        {1: N_ORDER & lo128, 2: N_ORDER >> 128},       # the group order itself
        {1: (N_ORDER - 1) & lo128, 2: (N_ORDER - 1) >> 128},
    ]
    plan = plan_circuit(circuit)
    solver = BatchSolver(plan, device="cpu")
    res = solver.solve(inputs)
    assert res.ok.tolist() == [True, True, True, False, False, True]
    assert res.fail.tolist() == [int(FAIL_NONE)] * 3 + [0, 0, int(FAIL_NONE)]
    hexes = [(f"{x:064x}", f"{y:064x}") for x, y in zip(res.witness_ints(3), res.witness_ints(4))]
    assert hexes[0] == gv.FIXED_BASE_1_0 and hexes[1] == gv.FIXED_BASE_1_2
    zero = "0" * 64
    assert hexes[3] == (zero, zero) and hexes[4] == (zero, zero)  # an invalid scalar writes zeros
    assert_equals_sequential(jcircuit, inputs, res, 4)
    assert_equals_jax_solver(jcircuit, inputs, res)
    # columnar inputs give the same panel
    cols = {w: np.array([d[w] for d in inputs], dtype=object) for w in (1, 2)}
    assert torch.equal(solver.solve(cols).panel, res.panel)


def test_pedersen_circuits_match_jax_solver_sequential_engine_and_golden_vectors():
    # one input: the serialized circuit of the reference's own test
    jone = deserialize_circuit(gv.PEDERSEN_CIRCUIT)
    call = jone.opcodes[0].call
    assert ([int(fi.witness) for fi in call.inputs], [int(w) for w in call.outputs],
            call.domain_separator) == ([1], [2, 3], 0)
    one = Circuit(
        current_witness_index=jone.current_witness_index,
        opcodes=[ops.OpcodeBlackBoxFuncCall(ops.BBPedersen(
            inputs=[fn_input(1, 254)], domain_separator=0, outputs=(Witness(2), Witness(3))))],
        private_parameters={Witness(1)},
    )
    inputs = [{1: 1}, {1: 7}]
    plan = plan_circuit(one)
    res = BatchSolver(plan, device="cpu").solve(inputs)
    assert res.ok.all()
    assert (f"{res.witness_ints(2)[0]:064x}"
            == "09489945604c9686e698cb69d7bd6fc0cdb02e9faae3e1a433f1c342c1a5ecc4")
    assert_equals_sequential(jone, inputs, res, 3)
    assert_equals_jax_solver(jone, inputs, res)

    # two inputs, mixed with an arithmetic gate on the commitment: the
    # reference's pedersen([0, 1], 0) vector, random field elements, p - 1
    def two_input(mod_circuit, mod_ops, w, expr, fe, **extra):
        return mod_circuit(
            current_witness_index=5,
            opcodes=[
                mod_ops.OpcodeBlackBoxFuncCall(mod_ops.BBPedersen(
                    inputs=[mod_ops.FunctionInput(w(1), 254), mod_ops.FunctionInput(w(2), 254)],
                    domain_separator=0, outputs=(w(3), w(4)))),
                mod_ops.OpcodeArithmetic(expr(  # w5 = 3 * x + y + 9
                    linear_combinations=[(fe(3), w(3)), (fe(1), w(4)), (-fe(1), w(5))], q_c=fe(9))),
            ],
            private_parameters={w(1), w(2)}, **extra)

    jtwo = two_input(JCircuit, jops, JWitness, JExpression, JFieldElement)
    two = two_input(Circuit, ops, Witness, Expression, FieldElement)
    rng = random.Random(12)
    inputs = [{1: 0, 2: 1}, {1: 123456789, 2: 987654321},
              {1: rng.randrange(P), 2: rng.randrange(P)}, {1: P - 1, 2: 0}]
    plan = plan_circuit(two)
    res = BatchSolver(plan, device="cpu").solve(inputs)
    assert res.ok.all()
    assert (f"{res.witness_ints(3)[0]:064x}", f"{res.witness_ints(4)[0]:064x}") == gv.PEDERSEN_0_1
    x, y = gk.pedersen_commit([FieldElement(P - 1), FieldElement(0)], 0)
    assert res.instance_ints(3)[3:6] == [int(x), int(y), (3 * int(x) + int(y) + 9) % P]
    assert_equals_sequential(jtwo, inputs, res, 5)


def test_schnorr_circuit_matches_sequential_engine():
    """The reference's serialized SchnorrVerify circuit (10 message bytes): a
    good signature, a flipped byte of s, an off-curve key and s = 0."""
    jcircuit = deserialize_circuit(gv.SCHNORR_VERIFY_CIRCUIT)
    call = jcircuit.opcodes[0].call
    sig_w = [int(fi.witness) for fi in call.signature]
    msg_w = [int(fi.witness) for fi in call.message]
    assert (int(call.public_key_x.witness), int(call.public_key_y.witness), sig_w, msg_w,
            int(call.output)) == (1, 2, list(range(3, 67)), list(range(67, 77)), 77)
    circuit = Circuit(
        current_witness_index=jcircuit.current_witness_index,
        opcodes=[ops.OpcodeBlackBoxFuncCall(ops.BBSchnorrVerify(
            public_key_x=fn_input(1, 254), public_key_y=fn_input(2, 254),
            signature=[fn_input(w, 8) for w in sig_w], message=[fn_input(w, 8) for w in msg_w],
            output=Witness(77)))],
        private_parameters={Witness(w) for w in range(1, 77)},
    )
    sk = 0xDEADBEEFCAFE1234
    pub_x, pub_y = gk.schnorr_public_key(sk)
    message = bytes(range(10))
    sig = gk.schnorr_sign(sk, message)
    assert sig == jgk.schnorr_sign(sk, message)  # the two host copies agree

    def assignment(sig_bytes, y=int(pub_y)):
        a = {1: int(pub_x), 2: y}
        a.update({3 + i: byte for i, byte in enumerate(sig_bytes)})
        a.update({67 + i: byte for i, byte in enumerate(message)})
        return a

    inputs = [assignment(sig), assignment(bytes([sig[0] ^ 1]) + sig[1:]),
              assignment(sig, y=int(pub_y) + 1), assignment(bytes(32) + sig[32:])]
    plan = plan_circuit(circuit)
    res = BatchSolver(plan, device="cpu").solve(inputs)
    assert res.ok.all() and res.witness_ints(77) == [1, 0, 0, 0]
    assert_equals_sequential(jcircuit, inputs, res, 77)


@pytest.mark.parametrize("kind", ["pedersen", "fixed_base", "schnorr", "sha256", "blake2s", "keccak256",
                                  "ecdsa_k1", "ecdsa_r1"])
def test_gadget_circuits_and_inputs_equal_the_jax_package_s(kind):
    circuit = bench.build_gadget_circuit(kind, 2, msg_len=5)
    jcircuit = jbench.build_gadget_circuit(kind, 2, msg_len=5)
    assert circuit.current_witness_index == jcircuit.current_witness_index
    assert [repr(op) for op in circuit.opcodes] == [repr(op) for op in jcircuit.opcodes]
    assert bench.gadget_inputs(circuit, 3, kind) == jbench.gadget_inputs(jcircuit, 3, kind)
    cols, jcols = (m.gadget_inputs_columnar(c, 3, kind) for m, c in ((bench, circuit), (jbench, jcircuit)))
    assert sorted(cols) == sorted(jcols)
    assert all(np.array_equal(cols[w], jcols[w]) and cols[w].dtype == jcols[w].dtype for w in cols)
    assert bench.columnar_instance(cols, 2) == jbench.columnar_instance(jcols, 2)
    with pytest.raises(NotImplementedError, match="not ported"):
        bench.build_gadget_circuit("ecdsa_k2", 1)


# ---------------------------------------------------------------------------
# What must not go stale: the Schnorr challenge hook and the generator tables
# ---------------------------------------------------------------------------


def test_schnorr_challenge_hook_is_refused_at_plan_time():
    """A hook set at plan time takes SchnorrVerify off the device: the gate
    becomes a host stage, as in the JAX planner (its solve is held to the
    JAX package in tests/test_torch_host_stages.py)."""
    circuit = bench.build_gadget_circuit("schnorr", 1, msg_len=2)
    plan = plan_circuit(circuit)  # no hook: a device gate
    assert sum(len(lv.schnorr) for lv in plan.levels) == 1
    solver = BatchSolver(plan, device="cpu")
    gk.set_schnorr_challenge_hook(lambda r_x, pub, message: 1)
    try:
        hooked = plan_circuit(circuit)
        assert sum(len(lv.schnorr) for lv in hooked.levels) == 0
        assert [h.opcode_indices for lv in hooked.levels for h in lv.host] == [[0]]
        # a solver planned before the hook was set would ignore it: refused
        with pytest.raises(RuntimeError, match="challenge hook"):
            solver.solve(bench.gadget_inputs_columnar(circuit, 1, "schnorr"))
    finally:
        gk.set_schnorr_challenge_hook(None)
    assert plan_circuit(circuit).levels
    solver._check_generators()


def test_changed_generators_are_refused_at_solve():
    circuit = bench.build_gadget_circuit("pedersen", 1)
    solver = BatchSolver(plan_circuit(circuit), device="cpu")
    inputs = bench.gadget_inputs_columnar(circuit, 1, "pedersen")
    solver._check_generators()
    gk.set_external_generators([gk.derive_generator(0, 0), grumpkin.mul(5, G)])
    try:
        with pytest.raises(RuntimeError, match=r"\(0, 1\).*rebuild"):
            solver.solve(inputs)
        rebuilt = BatchSolver(plan_circuit(circuit), device="cpu")
        rebuilt._check_generators()  # built from the new table: fine
    finally:
        gk.clear_external_generators()
    solver._check_generators()  # the old table is current again
    with pytest.raises(RuntimeError, match="rebuild"):
        rebuilt._check_generators()
