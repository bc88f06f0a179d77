"""The tensor-core expression dot (acvm_tpu_torch/fields/mxu_ops.py) on the
CPU, through its plain version: against the JAX package's
``fields/mxu_ops.py::mont_dot_mxu`` (called un-jitted on the same numpy
inputs), Python ints, and through ``BatchSolver(dot_kernel="mxu")`` against
the ``v2`` route and the sequential engine.  Tolerance 0."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvm_tpu.fields.mxu_ops import mont_dot_mxu as jax_mont_dot_mxu
from acvm_tpu.pwg import ACVM as JACVM
from acvm_tpu.pwg import ACVMStatus
from acvm_tpu.blackbox import StubBlackBoxSolver
from acvm_tpu.acir import Witness as JWitness
from acvm_tpu.acir import WitnessMap as JWitnessMap
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu_torch.acir import Circuit, Expression, Witness
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.convert import limbs16_to_limbs32, limbs32_to_limbs16
from acvm_tpu_torch.fields import FieldElement
from acvm_tpu_torch.fields import mxu_ops
from acvm_tpu_torch.fields.kernels import ints_to_limbs32, limbs32_to_ints
from acvm_tpu_torch.fields.params import BLS12_381_FR, BN254_FR
from acvm_tpu_torch.gpu import BatchSolver, plan_circuit
from acvm_tpu_torch.gpu import batch_solver as bs
from acvm_tpu_torch.utils import (
    build_wide_arith_circuit,
    random_inputs,
    with_repeated_constraints,
)

P = BN254_FR.modulus
RV = (1 << 256) % P


def _panel(E, T, B, rng, edges):
    """Values, coefficients and constants as ints: random, with the rows of
    ``edges`` (0, 1, p - 1) at the front of each axis."""
    def draw(i):
        return edges[i] if i < len(edges) else rng.randrange(P)

    vals = [[[draw((e + t + b) % (len(edges) + 3)) for b in range(B)] for t in range(T)]
            for e in range(E)]
    coeffs = [[draw((e * T + t) % (len(edges) + 2)) for t in range(T)] for e in range(E)]
    qc = [draw(e) for e in range(E)]
    return vals, coeffs, qc


@pytest.mark.parametrize("T", range(1, 9))
def test_plain_dot_equals_the_jax_package_s_and_ints(T):
    rng = random.Random(T)
    E, B = 4, 5
    vals, coeffs, qc = _panel(E, T, B, rng, [0, 1, P - 1])
    v = ints_to_limbs32([x for e in vals for t in e for x in t]).reshape(E, T, B, 8)
    c = ints_to_limbs32([x * RV % P for e in coeffs for x in e]).reshape(E, T, 8)
    q = ints_to_limbs32([x * RV % P for x in qc]).reshape(E, 8)
    got = mxu_ops.mont_dot_mxu(torch.from_numpy(v), torch.from_numpy(c), torch.from_numpy(q))
    got = got.numpy()
    want = [(qc[e] + sum(coeffs[e][t] * vals[e][t][b] for t in range(T))) % P
            for e in range(E) for b in range(B)]
    assert limbs32_to_ints(got) == want
    # The JAX function takes (B, E, T, 16) 16-bit limbs and gives (B, E, 16).
    jax_out = jax_mont_dot_mxu(
        jnp.asarray(limbs32_to_limbs16(v).transpose(2, 0, 1, 3)),
        jnp.asarray(limbs32_to_limbs16(c)), jnp.asarray(limbs32_to_limbs16(q)))
    jax_out = limbs16_to_limbs32(np.asarray(jax_out)).transpose(1, 0, 2)
    assert np.array_equal(got, jax_out)


def test_plain_dot_at_the_bound_and_zero():
    """p - 1 everywhere at T = 8 (every column at its largest), and zeros."""
    E, T, B = 2, 8, 3
    pm1 = int((P - 1) * RV % P)
    v = torch.from_numpy(ints_to_limbs32([P - 1] * (E * T * B)).reshape(E, T, B, 8))
    c = torch.from_numpy(ints_to_limbs32([pm1] * (E * T)).reshape(E, T, 8))
    q = torch.from_numpy(ints_to_limbs32([pm1] * E).reshape(E, 8))
    want = ((P - 1) + T * (P - 1) * (P - 1)) % P
    assert limbs32_to_ints(mxu_ops.mont_dot_mxu(v, c, q).numpy()) == [want] * (E * B)
    zero = torch.zeros_like(q)
    assert limbs32_to_ints(mxu_ops.mont_dot_mxu(torch.zeros_like(v), c, zero).numpy()) == \
        [0] * (E * B)
    # A small chunk walks the gates in several pieces: the same bits.
    step = mxu_ops.PLAIN_CHUNK
    try:
        mxu_ops.PLAIN_CHUNK = T * B * mxu_ops.N8
        assert limbs32_to_ints(mxu_ops.mont_dot_mxu(v, c, q).numpy()) == [want] * (E * B)
    finally:
        mxu_ops.PLAIN_CHUNK = step


def test_gate_and_refusals():
    assert mxu_ops.mxu_ok(BN254_FR, 1) and mxu_ops.mxu_ok(BN254_FR, 8)
    assert not mxu_ops.mxu_ok(BN254_FR, 0) and not mxu_ops.mxu_ok(BN254_FR, 9)
    assert not mxu_ops.mxu_ok(BLS12_381_FR, 3)
    v = torch.zeros((1, 9, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="1-8 terms"):
        mxu_ops.mont_dot_mxu(v, torch.zeros((1, 9, 8), dtype=torch.int32),
                             torch.zeros((1, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="bls12_381"):
        mxu_ops.mont_dot_mxu(v[:, :2], torch.zeros((1, 2, 8), dtype=torch.int32),
                             torch.zeros((1, 8), dtype=torch.int32), BLS12_381_FR)
    with pytest.raises(ValueError, match="coeffs"):
        mxu_ops.mont_dot_mxu(v[:, :2], torch.zeros((1, 3, 8), dtype=torch.int32),
                             torch.zeros((1, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="dot_kernel"):
        BatchSolver(plan_circuit(_mxu_circuit()), device="cpu", dot_kernel="mma")


def _mxu_circuit():
    """test_mxu_ops.py's circuit (w3 = 3 w1 w2 + w1 + 7, 5 w3 = 2 w2 + w4) and
    its quadratic constraint stated again as an assert-zero check over known
    witnesses, so that a panel with a product term reaches the dot."""
    fe = FieldElement
    one, three = fe(1), fe(3)
    first = Expression(mul_terms=[(three, Witness(1), Witness(2))],
                       linear_combinations=[(one, Witness(1)), (-one, Witness(3))], q_c=fe(7))
    return Circuit(
        current_witness_index=4,
        opcodes=[
            ops.OpcodeArithmetic(first),
            ops.OpcodeArithmetic(Expression(linear_combinations=[
                (fe(5), Witness(3)), (-fe(2), Witness(2)), (-one, Witness(4))])),
            ops.OpcodeArithmetic(first),
        ],
        private_parameters={Witness(1), Witness(2)},
    )


@pytest.fixture
def mxu_calls(monkeypatch):
    calls = []

    def counted(vals, *args):
        calls.append(tuple(vals.shape))
        return mxu_ops.mont_dot_mxu(vals, *args)

    monkeypatch.setattr(bs, "mont_dot_mxu", counted)
    return calls


@pytest.mark.parametrize("which", ["mxu_ops", "dyn"])
def test_solver_mxu_route_equals_v2_and_the_sequential_engine(which, mxu_calls):
    if which == "mxu_ops":
        circuit = _mxu_circuit()
        rng = random.Random(3)
        inputs = [{1: rng.randrange(P), 2: rng.randrange(P)} for _ in range(4)]
    else:
        circuit = with_repeated_constraints(build_wide_arith_circuit(
            num_inputs=8, num_levels=2, gates_per_level=16, dyn_fraction=0.5, seed=11), 6)
        inputs = random_inputs(circuit, 5)
    plan = plan_circuit(circuit)
    res = BatchSolver(plan, device="cpu", dot_kernel="mxu").solve(inputs)
    assert mxu_calls and all(1 <= shape[1] <= 8 for shape in mxu_calls), mxu_calls
    ref = BatchSolver(plan, device="cpu").solve(inputs)
    assert res.ok.all() and torch.equal(res.panel, ref.panel)
    for b in (0, len(inputs) - 1):
        wm = JWitnessMap()
        for w, v in inputs[b].items():
            wm.insert(JWitness(w), JFieldElement(v))
        acvm = JACVM(StubBlackBoxSolver(), _jax_circuit(circuit).opcodes, wm)
        assert acvm.solve() == ACVMStatus.SOLVED
        solved = acvm.finalize()
        assert res.instance_ints(b)[1:] == [
            int(solved.get(JWitness(w))) for w in range(1, plan.num_witnesses)]


def _jax_circuit(circuit):
    from acvm_tpu.acir.circuit import Circuit as JCircuit

    return JCircuit.read(circuit.write())
