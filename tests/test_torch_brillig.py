"""The port's straight-line Brillig blocks on the CPU.

`build_brillig_ops_circuit` (every field op, and every int op at 1-256 bits,
on edge values) and `build_uint_ops_circuit` (every `UIntGadget` operation of
the stdlib: a Brillig hint and the constraints that check it) are solved by
`acvm_tpu_torch` and held, at tolerance 0, to (1) Python ints (the VM's rules
written out below), (2) the sequential engine `acvm_tpu.pwg.ACVM` and (3) the
JAX package: its `trace_brillig`, block by block, on the ops circuit, and its
`BatchSolver`'s level on 14 of those blocks (every field op but `Div`, `Sub`
at every width, the two blocks of several steps).  The JAX package's CPU path
takes about a minute to compile the whole ops circuit, its field `Div` alone
about 25 s and its level over every block but `Div` about 80 s, so the field
ops but `Div` go through its trace, the subset through its level, and `Div`
is held to (1) and (2).  Where the JAX package is known to differ from `pwg.ACVM`
(ROADMAP queue 3) the port follows `pwg.ACVM`, and the test says where.

The SHA-256 fallback is checked here as a builder (opcode for opcode equal to
the JAX package's stdlib); its solve takes about two minutes on a CPU, so it
runs on the card (`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""

import dataclasses
import enum
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from acvm_tpu import acir as jacir
from acvm_tpu import brillig as jbr
from acvm_tpu import stdlib as jstdlib
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.blackbox import StubBlackBoxSolver
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.fields.jnp_ops import LimbContext as JLimbContext
from acvm_tpu.fields.limbs import int_to_limbs, limbs_to_int
from acvm_tpu.pwg import ACVM, ACVMStatus
from acvm_tpu.tpu import BatchSolver as JBatchSolver, plan_circuit as jplan_circuit
from acvm_tpu.tpu.brillig_trace import trace_brillig as jax_trace_brillig

from acvm_tpu_torch import brillig as br
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, plan_circuit
from acvm_tpu_torch.utils import (
    BRILLIG_BIT_SIZES,
    PORT_CLASSES,
    build_brillig_ops_circuit,
    build_sha256_circuit,
    build_uint_ops_circuit,
    brillig_ops_inputs,
    columnar_instance,
)

P = BN254_FR.modulus
B_OPS = 96
JAX_LIB = types.SimpleNamespace(Circuit=jacir.Circuit, Expression=jacir.Expression,
                                Witness=jacir.Witness, FieldElement=JFieldElement, opcodes=jops,
                                brillig=jbr, stdlib=jstdlib)


# ---------------------------------------------------------------------------
# Python ints: the VM's rules (brillig_vm/src/arithmetic.rs)
# ---------------------------------------------------------------------------


def int_op(op, a, b, bits):
    """An int op on field values, its result stored as a field element.
    UnsignedDiv by zero gives 0, as the batched solvers do (the VM raises)."""
    mod = 1 << bits
    O = br.BinaryIntOp
    if op in (O.SignedDiv,):
        sa = a if a < mod >> 1 else a - mod
        sb = b if b < mod >> 1 else b - mod
        q = abs(sa) // abs(sb) if sb else 0
        r = -q if (sa < 0) != (sb < 0) else q
    else:
        r = {
            O.Add: lambda: a + b, O.Sub: lambda: a - b, O.Mul: lambda: a * b,
            O.UnsignedDiv: lambda: (a % mod) // (b % mod) if b % mod else 0,
            O.Equals: lambda: int(a % mod == b % mod), O.LessThan: lambda: int(a % mod < b % mod),
            O.LessThanEquals: lambda: int(a % mod <= b % mod), O.And: lambda: a & b,
            O.Or: lambda: a | b, O.Xor: lambda: a ^ b,
            O.Shl: lambda: a << b if b < bits else 0, O.Shr: lambda: a >> b,
        }[op]()
    return r % mod % P


def field_op(op, a, b):
    O = br.BinaryFieldOp
    return {O.Add: lambda: a + b, O.Sub: lambda: a - b, O.Mul: lambda: a * b,
            O.Div: lambda: a * pow(b, -1, P) if b else 0, O.Equals: lambda: int(a == b)}[op]() % P


def run_block(brillig, w):
    """One straight-line block over the witness values ``w``: its outputs."""
    def value(e):
        v = e.q_c.value + sum(c.value * w[int(x)] for c, x in e.linear_combinations)
        return (v + sum(c.value * w[int(x)] * w[int(y)] for c, x, y in e.mul_terms)) % P

    regs = {i: value(inp.expr) for i, inp in enumerate(brillig.inputs)}
    for op in brillig.bytecode:
        if isinstance(op, br.OpStop):
            break
        if isinstance(op, br.OpConst):
            regs[op.destination] = op.value.inner.value
        elif isinstance(op, br.OpMov):
            regs[op.destination] = regs.get(op.source, 0)
        elif isinstance(op, br.OpBinaryFieldOp):
            regs[op.destination] = field_op(op.op, regs.get(op.lhs, 0), regs.get(op.rhs, 0))
        else:
            regs[op.destination] = int_op(op.op, regs.get(op.lhs, 0), regs.get(op.rhs, 0),
                                          op.bit_size)
    active = brillig.predicate is None or value(brillig.predicate)
    return [regs.get(i, 0) if active else 0 for i in range(len(brillig.outputs))]


def block_label(brillig):
    """'field' for a field op, the bit size of an int op, 'steps' for a block
    of several ops."""
    ops_ = [op for op in brillig.bytecode if hasattr(op, "op")]
    if len(ops_) > 1:
        return "steps"
    return ops_[0].bit_size if isinstance(ops_[0], br.OpBinaryIntOp) else "field"


def op_of(brillig):
    return next(op for op in brillig.bytecode if hasattr(op, "op"))


LABELS = ["field", *BRILLIG_BIT_SIZES, "steps"]


@pytest.fixture(scope="module")
def ops_case():
    circuit = build_brillig_ops_circuit()
    cols = brillig_ops_inputs(B_OPS)
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve(cols)
    return dict(circuit=circuit, jcircuit=build_brillig_ops_circuit(lib=JAX_LIB), cols=cols,
                res=res, inst=[columnar_instance(cols, b) for b in range(B_OPS)])


def blocks_of(case, label):
    return [(i, op.brillig) for i, op in enumerate(case["circuit"].opcodes)
            if block_label(op.brillig) == label]


def test_brillig_ops_circuit_shape(ops_case):
    c = ops_case["circuit"]
    kinds = [block_label(op.brillig) for op in c.opcodes]
    assert kinds.count("field") == 5 and kinds.count("steps") == 2
    assert all(kinds.count(k) == (13 if k <= 128 else 11) for k in BRILLIG_BIT_SIZES)
    assert ops_case["res"].ok.all()
    # one level: every block reads the inputs; blocks never share a bytecode
    plan = plan_circuit(c)
    assert len(plan.levels) == 1 and len(plan.levels[0].brillig) == len(c.opcodes)


@pytest.mark.parametrize("label", LABELS)
def test_brillig_ops_match_ints(ops_case, label):
    res = ops_case["res"]
    for _, block in blocks_of(ops_case, label):
        got = [res.witness_ints(int(o.witness)) for o in block.outputs]
        for b, w in enumerate(ops_case["inst"]):
            assert [g[b] for g in got] == run_block(block, w), (op_of(block), b)


def sequential_block(jblock, assignment):
    """One Brillig opcode alone through pwg.ACVM: its outputs, or the
    exception the VM raised."""
    wm = jacir.WitnessMap()
    for k, v in assignment.items():
        wm.insert(jacir.Witness(k), JFieldElement(v))
    acvm = ACVM(StubBlackBoxSolver(), [jops.OpcodeBrillig(jblock)], wm)
    try:
        assert acvm.solve() == ACVMStatus.SOLVED
    except ZeroDivisionError as err:
        return err
    return [int(acvm.finalize().get(jacir.Witness(int(o.witness)))) for o in jblock.outputs]


@pytest.mark.parametrize("label", LABELS)
def test_brillig_ops_match_sequential_engine(ops_case, label):
    res, jops_ = ops_case["res"], ops_case["jcircuit"].opcodes
    raised = 0
    for i, block in blocks_of(ops_case, label):
        got = [res.witness_ints(int(o.witness)) for o in block.outputs]
        for b, w in enumerate(ops_case["inst"]):
            want = sequential_block(jops_[i].brillig, {k: w[k] for k in (1, 2, 3)})
            if isinstance(want, ZeroDivisionError):
                # UnsignedDiv by zero: the VM raises, the batched solvers give
                # 0 (ROADMAP queue 3).
                op = op_of(block)
                assert op.op == br.BinaryIntOp.UnsignedDiv and w[2] % (1 << op.bit_size) == 0
                assert got[0][b] == 0
                raised += 1
                continue
            assert [g[b] for g in got] == want, (op_of(block), b)
    if label not in ("field", "steps"):
        assert raised > 0  # the edge values hold a zero divisor at every width


def jax_limbs(values):
    return jnp.asarray(np.stack([int_to_limbs(int(v)) for v in values]).astype(np.uint32))


@pytest.mark.parametrize("label", LABELS[:-1])  # "steps": the BatchSolver test below
def test_brillig_ops_match_jax_trace(ops_case, label):
    """The JAX package's trace of each block on the same registers.  Two of
    its faults (ROADMAP queue 3) show here: an int op at 254 or 256 bits keeps
    a result at or above p where the VM reduces it, and SignedDiv masks an
    operand at or above 2^bit_size where the VM reads it as it is."""
    res, cols = ops_case["res"], ops_case["cols"]
    ctx = JLimbContext()
    a, b = jax_limbs(cols[1]), jax_limbs(cols[2])
    for i, block in blocks_of(ops_case, label):
        op = op_of(block)
        if op.op == br.BinaryFieldOp.Div and isinstance(op, br.OpBinaryFieldOp):
            continue  # held to ints and pwg.ACVM above: 25 s of compiling on this path
        jblock = ops_case["jcircuit"].opcodes[i].brillig
        regs = jax_trace_brillig(ctx, B_OPS, jblock.bytecode, [a, b])
        want = [limbs_to_int(np.asarray(v)) for v in np.asarray(regs.get_arr(0))]
        got = res.witness_ints(int(block.outputs[0].witness))
        for i, (g, j) in enumerate(zip(got, want)):
            if g == j:
                continue
            x, y = int(cols[1][i]), int(cols[2][i])
            unreduced = op.bit_size >= 254 and j >= P and j % P == g
            wide_operand = op.op == br.BinaryIntOp.SignedDiv and max(x, y) >= 1 << op.bit_size
            assert unreduced or wide_operand, (op, i, g, j)


def in_jax_subset(brillig):
    """The blocks the JAX BatchSolver runs here: every field op but Div, the
    subtraction at every bit size, and the two blocks of several steps (one
    under a predicate, one over a compound input)."""
    label, op = block_label(brillig), op_of(brillig)
    if label == "field":
        return op.op.name != "Div"
    return label == "steps" or op.op.name == "Sub"


@pytest.fixture(scope="module")
def jax_level(ops_case):
    """The JAX BatchSolver's level (its `_run_level`, as its jitted segment
    runs it, which compiles far sooner) over the subset above: its packing,
    input expressions, predicate and output writes.  Each block's op alone
    goes through the JAX trace above; its BatchSolver over every block but
    Div takes about 80 s on a CPU."""
    jc = ops_case["jcircuit"]
    keep = [i for i, op in enumerate(ops_case["circuit"].opcodes) if in_jax_subset(op.brillig)]
    sub = JAX_LIB.Circuit(current_witness_index=jc.current_witness_index,
                          opcodes=[jc.opcodes[i] for i in keep],
                          private_parameters=set(jc.private_parameters))
    solver = JBatchSolver(jplan_circuit(sub))
    assert len(solver.plan.levels) == 1
    W, ok, fail, mem = solver.initial_state(ops_case["cols"])
    for segment in solver.segments:
        for packed in segment.levels:
            W, ok, fail, mem = solver._run_level(W, ok, fail, mem, packed)
    W, ok, fail = jax.device_get((W, ok, fail))
    return dict(keep=keep, W=np.asarray(W), ok=np.asarray(ok), fail=np.asarray(fail))


def test_brillig_blocks_match_jax_batch_solver(ops_case, jax_level):
    """Every output of the subset's blocks equals the JAX BatchSolver's, but
    where an op at 254 or 256 bits leaves a result at or above p: the JAX
    trace keeps it, the VM and the port reduce it (ROADMAP queue 3)."""
    res, jW = ops_case["res"], jax_level["W"]
    assert len(jax_level["keep"]) == 4 + len(BRILLIG_BIT_SIZES) + 2
    unreduced = 0
    for i in jax_level["keep"]:
        block = ops_case["circuit"].opcodes[i].brillig
        for out in block.outputs:
            w = int(out.witness)
            got = res.witness_ints(w)
            for b in range(B_OPS):
                want = limbs_to_int(jW[b, w])
                if got[b] != want:
                    assert op_of(block).bit_size >= 254 and want >= P and want % P == got[b], (i, b)
                    unreduced += 1
    assert unreduced > 0  # 0 - 1 at 254 and 256 bits, among others
    assert jax_level["ok"].all() and res.ok.all()
    assert np.array_equal(res.fail, jax_level["fail"])
    pred = ops_case["cols"][3]
    assert 0 < pred.sum() < B_OPS  # the predicate block sees both cases


# ---------------------------------------------------------------------------
# The stdlib's UIntGadget and SHA-256 builders
# ---------------------------------------------------------------------------


UINT_INPUTS = [(0xDEADBEEF, 0x12345678), (0xFFFFFFFF, 0xFFFFFFFF), (0, 1), (1, 0xFFFFFFFF),
               (0x80000000, 3), (12345, 12345), (7, 0), (0xFFFFFFFF, 0)]


def uint_expected(name, x, y):
    m = (1 << 32) - 1
    return dict(add=(x + y) & m, sub=(x - y) & m, mul=(x * y) & m, and_=x & y, xor=x ^ y,
                or_=x | y, not_=~x & m, rol=((x << 7) | (x >> 25)) & m,
                ror=((x >> 11) | (x << 21)) & m, leftshift=(x << 5) & m, rightshift=x >> 9,
                more_than_eq_comparison=int(x >= y), less_than_comparison=int(x < y),
                div_q=x // y if y else 0, div_r=x % y if y else 0)[name]


@pytest.fixture(scope="module")
def uint_case():
    circuit, outputs = build_uint_ops_circuit()
    inputs = [{1: x, 2: y} for x, y in UINT_INPUTS]
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve(inputs)
    return dict(circuit=circuit, outputs=outputs, inputs=inputs, res=res)


@pytest.mark.parametrize("instance", range(len(UINT_INPUTS)))
def test_uint_gadgets_match_ints_and_sequential_engine(uint_case, instance):
    res, (x, y) = uint_case["res"], UINT_INPUTS[instance]
    jcircuit, _ = build_uint_ops_circuit(lib=JAX_LIB)
    wm = jacir.WitnessMap()
    for k, v in uint_case["inputs"][instance].items():
        wm.insert(jacir.Witness(k), JFieldElement(v))
    acvm = ACVM(StubBlackBoxSolver(), jcircuit.opcodes, wm)
    status = acvm.solve()
    got = res.instance_ints(instance)
    if y == 0:  # the division's range check of y - r - 1 fails
        assert status == ACVMStatus.FAILURE and not res.ok[instance]
        assert res.fail[instance] == acvm.error.opcode_location.acir_index
        return
    assert status == ACVMStatus.SOLVED and res.ok[instance] and res.fail[instance] == FAIL_NONE
    expected = list(acvm.finalize())
    assert len(expected) == uint_case["circuit"].current_witness_index
    assert all(got[int(w)] == int(v) for w, v in expected)
    for name, w in uint_case["outputs"].items():
        assert got[int(w)] == uint_expected(name, x, y), name


def test_one_trace_a_group_equals_one_trace_a_block(uint_case):
    """A level's blocks of one bytecode run as one trace over (G, B, 8)
    registers; one trace a block gives the same bits."""
    solver = BatchSolver(plan_circuit(uint_case["circuit"]), device="cpu")
    blocks = sum(len(lv.brillig) for lv in solver.plan.levels)
    groups = sum(len(lv.get("brillig", [])) for seg in solver.segments for lv in seg.levels)
    assert groups < blocks
    one_a_block = BatchSolver(plan_circuit(uint_case["circuit"]), device="cpu", group_stages=False)
    assert sum(len(lv.get("brillig", [])) for seg in one_a_block.segments
               for lv in seg.levels) == blocks
    res = one_a_block.solve(uint_case["inputs"])
    assert np.array_equal(res.W, uint_case["res"].W)
    assert np.array_equal(res.fail, uint_case["res"].fail)


def dump(x):
    """A structural dump of an ACIR object, whichever package built it."""
    name = type(x).__name__
    if x is None:
        return None
    if name == "Expression":
        return ("Expression", dump(x.mul_terms), dump(x.linear_combinations), dump(x.q_c))
    if name == "FieldElement":
        return ("fe", x.value)
    if dataclasses.is_dataclass(x):
        return (name,) + tuple(dump(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(dump(v) for v in x)
    if isinstance(x, enum.Enum):
        return (name, x.name)
    if isinstance(x, (int, str)):
        return (name, x)
    raise TypeError(name)


def test_sha256_builder_equals_jax_stdlib():
    circuit, jcircuit = build_sha256_circuit(32), build_sha256_circuit(32, lib=JAX_LIB)
    assert len(circuit.opcodes) == len(jcircuit.opcodes) == 28980
    assert circuit.current_witness_index == jcircuit.current_witness_index == 15793
    assert all(dump(a) == dump(b) for a, b in zip(circuit.opcodes, jcircuit.opcodes))
    kinds = [type(op).__name__ for op in circuit.opcodes]
    assert kinds.count("OpcodeBrillig") == 8297
    plan = plan_circuit(circuit)
    assert len(plan.levels) == 1093 and not any(lv.host for lv in plan.levels)


# ---------------------------------------------------------------------------
# The predicate's level, and what still goes to a host stage
# ---------------------------------------------------------------------------


def predicate_circuit(lib):
    """w2 = w1 + 1, w3 = 2 w2, then a Brillig block (w4 = w1 + 5 at 32 bits)
    under the predicate w1 * w3: a product term over a witness solved two
    levels after the inputs."""
    o, W, f, b = lib.opcodes, lib.Witness, lib.FieldElement, lib.brillig
    R = b.RegisterIndex
    lin = lambda *t, q=0: lib.Expression(linear_combinations=[(f(c), W(w)) for c, w in t],  # noqa: E731
                                         q_c=f(q))
    return lib.Circuit(
        current_witness_index=4,
        opcodes=[
            o.OpcodeArithmetic(lin((1, 1), (-1, 2), q=1)),
            o.OpcodeArithmetic(lin((2, 2), (-1, 3))),
            o.OpcodeBrillig(o.Brillig(
                inputs=[o.BrilligInputSingle(lin((1, 1)))],
                outputs=[o.BrilligOutputSimple(W(4))], foreign_call_results=[],
                bytecode=[b.OpConst(R(1), b.Value(f(5))),
                          b.OpBinaryIntOp(R(0), b.BinaryIntOp.Add, 32, R(0), R(1)), b.OpStop()],
                predicate=lib.Expression(mul_terms=[(f(1), W(1), W(3))]))),
        ],
        private_parameters={W(1)},
    )


def test_brillig_predicate_waits_for_its_product_terms():
    """The JAX planner reads only the predicate's linear terms, so it puts
    this block at level 1, before w3 is solved (ROADMAP queue 3); the port's
    planner puts it after w3, and the port equals pwg.ACVM."""
    jplan = jplan_circuit(predicate_circuit(JAX_LIB))
    # the JAX planner's fault: the block shares level 0 with w2; w3 is at 1
    assert [bool(lv.brillig) for lv in jplan.levels] == [True, False]
    plan = plan_circuit(predicate_circuit(PORT_CLASSES))
    assert [bool(lv.brillig) for lv in plan.levels] == [False, False, True]
    values = [0, 3, P - 1, 1 << 40]
    res = BatchSolver(plan, device="cpu").solve([{1: v} for v in values])
    for b, v in enumerate(values):
        wm = jacir.WitnessMap({jacir.Witness(1): JFieldElement(v)})
        acvm = ACVM(StubBlackBoxSolver(), predicate_circuit(JAX_LIB).opcodes, wm)
        assert acvm.solve() == ACVMStatus.SOLVED
        want = int(acvm.finalize().get(jacir.Witness(4)))
        assert res.witness_ints(4)[b] == want == (((v + 5) % (1 << 32)) if v * (2 * v + 2) % P else 0)
