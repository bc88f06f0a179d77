"""The port's arithmetic-circuit solver, end to end, on the CPU.

`plan_circuit` -> `BatchSolver(plan, device="cpu")` -> `solve(inputs)` of
`acvm_tpu_torch` against (1) the sequential engine `acvm_tpu.pwg.ACVM`, (2) the
JAX `BatchSolver` on the CPU and (3) Python ints, on the circuits of
`build_wide_arith_circuit` (same seeds in both packages, so the same circuit).
Witness values, `ok` flags and first-failure opcode indices must be equal bit
for bit.  The JAX solver compiles one program per circuit (minutes in all for
deep dynamic-denominator circuits on a CPU), so it runs on the 3-level static
circuit and on a 1-level dynamic one, each ONCE with the failing instances in
the batch; the deeper dynamic circuit is held to the sequential engine.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from acvm_tpu import acir as jacir
from acvm_tpu.acir import Witness as JWitness, WitnessMap as JWitnessMap
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.blackbox import StubBlackBoxSolver
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.pwg import ACVM, ACVMStatus
from acvm_tpu.tpu import BatchSolver as JBatchSolver, plan_circuit as jplan_circuit
from acvm_tpu.utils import build_wide_arith_circuit as jbuild, random_inputs as jrandom_inputs

from acvm_tpu_torch import brillig as br
from acvm_tpu_torch import convert
from acvm_tpu_torch.acir import Circuit, Expression, Witness
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.fields.field import FieldElement
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, plan_circuit
from acvm_tpu_torch.parallel import make_mesh
from acvm_tpu_torch.utils import (
    PORT_CLASSES, build_wide_arith_circuit, random_inputs, with_repeated_constraints,
)

P = BN254_FR.modulus
BATCH = 8
REPO = pathlib.Path(__file__).resolve().parent.parent


def sequential(jcircuit, assignment):
    wm = JWitnessMap()
    for k, v in assignment.items():
        wm.insert(JWitness(k), JFieldElement(v))
    acvm = ACVM(StubBlackBoxSolver(), jcircuit.opcodes, wm)
    return acvm.solve(), acvm


def inputs_with_failures(circuit, plan):
    """BATCH seeded instances; instance 2 zeroes every input (every runtime
    denominator vanishes), instance 5 zeroes the partner witness of the LAST
    dynamic gate only.  On a circuit with no dynamic gate nothing fails."""
    inputs = random_inputs(circuit, BATCH)
    dyn = [g for lv in plan.levels for g in lv.arith_solve if g.neg_inv_den_r is None]
    input_set = set(plan.input_witnesses)
    partners = [g.den_dyn_idx[0] for g in dyn if g.den_dyn_idx[0] in input_set]
    if partners:
        inputs[2] = {w: 0 for w in inputs[2]}
        inputs[5] = {**inputs[5], partners[-1]: 0}
    return inputs, bool(partners)


CASES = {"static-3lv": (3, 0.0), "dyn-3lv": (3, 0.5), "dyn-1lv": (1, 0.5)}
# The JAX solver's 3-level dynamic program takes about a minute to compile on
# a CPU; the 1-level circuit holds the same level kinds.
JAX_CASES = ["static-3lv", "dyn-1lv"]


@functools.lru_cache(maxsize=None)
def build_case(name):
    levels, dyn = CASES[name]
    kw = dict(num_inputs=8, num_levels=levels, gates_per_level=16, dyn_fraction=dyn)
    circuit, jcircuit = build_wide_arith_circuit(**kw), jbuild(**kw)
    plan = plan_circuit(circuit)
    inputs, has_failures = inputs_with_failures(circuit, plan)
    assert inputs[0] == jrandom_inputs(jcircuit, BATCH)[0]  # same seeds, same data
    solver = BatchSolver(plan, device="cpu")
    return dict(circuit=circuit, jcircuit=jcircuit, plan=plan, inputs=inputs,
                has_failures=has_failures, solver=solver, res=solver.solve(inputs),
                levels=levels, dyn=dyn)


@pytest.fixture(params=sorted(CASES))
def case(request):
    return build_case(request.param)


def test_plan_matches_jax_planner(case):
    jplan = jplan_circuit(case["jcircuit"])
    plan = case["plan"]
    assert plan.num_witnesses == jplan.num_witnesses
    assert plan.input_witnesses == jplan.input_witnesses
    assert [
        [(g.unknown, g.opcode_index, g.neg_inv_den_r, g.num.lin_coeff_r) for g in lv.arith_solve]
        for lv in plan.levels
    ] == [
        [(g.unknown, g.opcode_index, g.neg_inv_den_r, g.num.lin_coeff_r) for g in lv.arith_solve]
        for lv in jplan.levels
    ]


@pytest.mark.parametrize("instance", range(BATCH))
def test_matches_sequential_engine(case, instance):
    res = case["res"]
    status, acvm = sequential(case["jcircuit"], case["inputs"][instance])
    if status == ACVMStatus.SOLVED:
        assert res.ok[instance] and res.fail[instance] == FAIL_NONE
        assert res.error_location(instance) is None
        expected = acvm.finalize()
        got = res.instance_ints(instance)
        n = 0
        for w, value in expected:
            assert got[int(w)] == int(value), int(w)
            n += 1
        assert n == case["plan"].num_witnesses - 1
    else:
        assert case["has_failures"] and instance in (2, 5)
        assert not res.ok[instance]
        assert res.error_location(instance).acir_index == acvm.error.opcode_location.acir_index
        assert int(res.fail[instance]) == acvm.error.opcode_location.acir_index


def test_failing_instances_fail(case):
    want = [not (case["has_failures"] and b in (2, 5)) for b in range(BATCH)]
    assert case["res"].ok.tolist() == want


@functools.lru_cache(maxsize=None)
def jax_result(name):
    case = build_case(name)
    return JBatchSolver(jplan_circuit(case["jcircuit"])).solve(case["inputs"])


@pytest.mark.parametrize("name", JAX_CASES)
def test_matches_jax_batch_solver(name):
    case = build_case(name)
    jres = jax_result(name)
    res = case["res"]
    nw = case["plan"].num_witnesses
    assert res.W.shape == (BATCH, nw, 16) and res.W.dtype == np.uint32
    assert np.array_equal(res.W, jres.W[:, :nw])  # the JAX panel has a scratch column
    assert np.array_equal(res.ok, jres.ok)
    assert np.array_equal(res.fail, jres.fail)
    for b in range(BATCH):
        jl, tl = jres.error_location(b), res.error_location(b)
        assert (jl is None) == (tl is None)
        assert jl is None or jl.acir_index == tl.acir_index
    assert res.witness_ints(nw - 1) == jres.witness_ints(nw - 1)
    # state carried across: the JAX panel converts to the port's panel
    assert np.array_equal(
        convert.panel_from_jax(jres.W, num_witnesses=nw), res.panel.numpy())


# ---------------------------------------------------------------------------
# dot_kernel="v1": the first-generation multiply and dot
# ---------------------------------------------------------------------------


def test_dot_kernel_v1_equals_v2(case):
    v1 = BatchSolver(case["plan"], device="cpu", dot_kernel="v1").solve(case["inputs"])
    res = case["res"]
    assert torch.equal(v1.panel, res.panel)
    assert np.array_equal(v1.ok, res.ok) and np.array_equal(v1.fail, res.fail)


@pytest.mark.parametrize("name", JAX_CASES)
def test_dot_kernel_v1_matches_jax_batch_solver(name):
    case = build_case(name)
    jres = jax_result(name)
    v1 = BatchSolver(case["plan"], device="cpu", dot_kernel="v1").solve(case["inputs"])
    assert np.array_equal(v1.W, jres.W[:, : case["plan"].num_witnesses])
    assert np.array_equal(v1.ok, jres.ok) and np.array_equal(v1.fail, jres.fail)


@pytest.mark.parametrize("dot_kernel", ["v2", "v1"])
def test_repeated_quadratic_constraints_plan_as_checks(dot_kernel):
    """A quadratic constraint stated again is an assert-zero check over known
    witnesses: the expression evaluation's operand pre-multiply (`mont_mul_v1`
    under "v1").  Held to the sequential engine; a spoiled input must fail at
    the first repeat it breaks."""
    kw = dict(num_inputs=8, num_levels=2, gates_per_level=16, dyn_fraction=0.5)
    circuit = with_repeated_constraints(build_wide_arith_circuit(**kw), 5)
    jcircuit = with_repeated_constraints(jbuild(**kw), 5)
    assert len(circuit.opcodes) == 37 == len(jcircuit.opcodes)
    plan = plan_circuit(circuit)
    checks = [g for lv in plan.levels for g in lv.arith_check]
    assert len(checks) == 5 and all(len(g.expr.mul_idx) == 1 for g in checks)
    inputs = random_inputs(circuit, 3)
    res = BatchSolver(plan, device="cpu", dot_kernel=dot_kernel).solve(inputs)
    assert res.ok.all()
    for b in range(3):
        status, acvm = sequential(jcircuit, inputs[b])
        assert status == ACVMStatus.SOLVED
        got = res.instance_ints(b)
        assert all(got[int(w)] == int(v) for w, v in acvm.finalize())
    with pytest.raises(ValueError, match="only"):
        with_repeated_constraints(circuit, 1000)


def test_dot_kernel_argument_is_checked(case):
    with pytest.raises(ValueError, match="dot_kernel"):
        BatchSolver(case["plan"], device="cpu", dot_kernel="v3")
    bls = Circuit(
        current_witness_index=2,
        opcodes=[ops.OpcodeArithmetic(Expression(
            linear_combinations=[(FieldElement(1), Witness(1)), (-FieldElement(1), Witness(2))]))],
        private_parameters={Witness(1)},
    )
    from acvm_tpu_torch.fields.params import BLS12_381_FR

    plan = plan_circuit(bls, params=BLS12_381_FR)
    BatchSolver(plan, device="cpu")  # the default route takes any field
    with pytest.raises(ValueError, match="BN254"):
        BatchSolver(plan, device="cpu", dot_kernel="v1")


def test_witness_maps_and_result_views(case):
    res = case["res"]
    maps = res.witness_maps()
    assert len(maps) == BATCH
    last = case["plan"].num_witnesses - 1
    col = res.witness_ints(last)
    assert [int(m.get(Witness(last))) for m in maps] == col
    assert res.instance_ints(3)[last] == col[3]


def test_columnar_inputs_equal_dict_inputs(case):
    inputs = case["inputs"]
    columns = {w: np.array([d[w] for d in inputs], dtype=object) for w in inputs[0]}
    res = case["solver"].solve(columns)
    assert np.array_equal(res.panel.numpy(), case["res"].panel.numpy())
    assert np.array_equal(res.fail, case["res"].fail)


# ---------------------------------------------------------------------------
# A hand-built circuit: one runtime-denominator solve and one assert-zero check
# ---------------------------------------------------------------------------


def check_circuit(mod_circuit, mod_expr, mod_witness, mod_ops, fe):
    """opcode 0 solves w4 from w1*w4 + w2 = 0; opcode 1 asserts w3 - w2 = 0."""
    w = mod_witness
    return mod_circuit(
        current_witness_index=4,
        opcodes=[
            mod_ops.OpcodeArithmetic(mod_expr(
                mul_terms=[(fe(1), w(1), w(4))], linear_combinations=[(fe(1), w(2))], q_c=fe(0))),
            mod_ops.OpcodeArithmetic(mod_expr(
                linear_combinations=[(fe(1), w(3)), (-fe(1), w(2))], q_c=fe(0))),
        ],
        private_parameters={w(1), w(2), w(3)},
    )


CHECK_CASES = [  # (w1, w2, w3) -> first failing opcode (None: satisfied), w4
    ((0, 5, 5), 0), ((2, 4, 7), 1), ((0, 0, 0), None), ((0, 3, 9), 0),
    ((3, 6, 6), None), ((P - 1, 1, 1), None), ((7, 0, 1), 1),
]


@pytest.fixture(scope="module")
def check_result():
    circuit = check_circuit(Circuit, Expression, Witness, ops, FieldElement)
    inputs = [{1: a, 2: b, 3: c} for (a, b, c), _ in CHECK_CASES]
    return BatchSolver(plan_circuit(circuit), device="cpu").solve(inputs)


@pytest.mark.parametrize("instance", range(len(CHECK_CASES)))
def test_check_and_dyn_failures(check_result, instance):
    from acvm_tpu.acir import Circuit as JC, Expression as JE
    from acvm_tpu.acir import opcodes as jops

    (w1, w2, w3), failing = CHECK_CASES[instance]
    res = check_result
    assert bool(res.ok[instance]) == (failing is None)
    assert int(res.fail[instance]) == (int(FAIL_NONE) if failing is None else failing)
    loc = res.error_location(instance)
    assert (loc is None) if failing is None else (loc.acir_index == failing)
    # den = 0 writes 0 whether or not the instance fails (batch convention)
    w4 = (-w2 * pow(w1, -1, P)) % P if w1 else 0
    assert res.witness_ints(4)[instance] == w4
    status, acvm = sequential(check_circuit(JC, JE, JWitness, jops, JFieldElement),
                              {1: w1, 2: w2, 3: w3})
    if failing is None and w1:
        assert status == ACVMStatus.SOLVED
        assert int(acvm.finalize().get(JWitness(4))) == w4
    elif failing is not None:
        assert status == ACVMStatus.FAILURE
        assert acvm.error.opcode_location.acir_index == failing


# ---------------------------------------------------------------------------
# What this slice refuses, and what it must never import
# ---------------------------------------------------------------------------


def test_unsupported_opcode_kind_raises():
    """A straight-line Brillig block with an array output: the VM would read
    it from its memory, which the trace does not hold."""
    circuit = Circuit(
        current_witness_index=3,
        opcodes=[ops.OpcodeBrillig(ops.Brillig(
            inputs=[ops.BrilligInputSingle(Expression.from_witness(Witness(1)))],
            outputs=[ops.BrilligOutputArray([Witness(2), Witness(3)])], foreign_call_results=[],
            bytecode=[br.OpStop()], predicate=None))],
        private_parameters={Witness(1)},
    )
    with pytest.raises(NotImplementedError, match=r"opcode 0 has array inputs or outputs"):
        BatchSolver(plan_circuit(circuit), device="cpu")


def memory_circuit(lib):
    """The circuit the port refused before memory blocks: MemoryInit of [w1],
    a read of entry 0 into w3, then w2 = w1 + w3."""
    o, W, f = lib.opcodes, lib.Witness, lib.FieldElement
    return lib.Circuit(
        current_witness_index=3,
        opcodes=[
            o.OpcodeMemoryInit(block_id=o.BlockId(0), init=[W(1)]),
            o.OpcodeMemoryOp(o.BlockId(0), o.MemOp.read_at_mem_index(lib.Expression.zero(), W(3)),
                             None),
            o.OpcodeArithmetic(lib.Expression(linear_combinations=[
                (f(1), W(1)), (f(1), W(3)), (-f(1), W(2))])),
        ],
        private_parameters={W(1)},
    )


def test_memory_circuit_solves_as_sequential_engine():
    jlib = type(PORT_CLASSES)(Circuit=jacir.Circuit, Expression=jacir.Expression,
                              Witness=JWitness, FieldElement=JFieldElement, opcodes=jops)
    values = [0, 7, P - 1]
    res = BatchSolver(plan_circuit(memory_circuit(PORT_CLASSES)), device="cpu").solve(
        [{1: v} for v in values])
    assert res.ok.all() and (res.fail == FAIL_NONE).all()
    for b, v in enumerate(values):
        status, acvm = sequential(memory_circuit(jlib), {1: v})
        assert status == ACVMStatus.SOLVED
        assert res.instance_ints(b)[1:] == [int(acvm.finalize().get(JWitness(w))) for w in (1, 2, 3)]
        assert res.witness_ints(2)[b] == 2 * v % P


def test_unported_options_raise(case):
    # Sharding over a mesh is ported (acvm_tpu_torch/parallel): three
    # instances over two CPU entries give the unsharded solve's bits.
    res = BatchSolver(case["plan"], mesh=make_mesh(["cpu"] * 2)).solve(case["inputs"][:3])
    assert np.array_equal(res.ok, case["res"].ok[:3])
    assert np.array_equal(res.fail, case["res"].fail[:3])
    assert torch.equal(res.panel, case["res"].panel[:, :3])
    # The two ingest forms are ported: what they refuse is their input
    # (tests/test_torch_host_stages.py holds them to the dict forms).
    with pytest.raises(ValueError, match="uint8/uint16"):
        case["solver"].solve(([1, 2], np.zeros((4, 2), np.uint32)))
    with pytest.raises(ValueError, match="solver's device"):
        case["solver"].solve({1: torch.zeros(4, device="meta")})
    # The wire format is ported (acir/serialization.py): write and read
    # round-trip.
    data = case["circuit"].write()
    assert Circuit.read(data).write() == data


def test_default_device_needs_a_card(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchSolver(case["plan"])


IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|acvm_tpu)(?:\.|\s|$)", re.M)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "acvm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = [str(f.relative_to(REPO)) for f in files if IMPORT.search(f.read_text())]
    assert not bad, bad
    assert IMPORT.search("from acvm_tpu.fields import x") and IMPORT.search("import jax")
    assert not IMPORT.search("from acvm_tpu_torch.fields import x")
