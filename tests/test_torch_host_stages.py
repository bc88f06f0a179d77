"""The port's host stages on the CPU: the stages between device segments.

One circuit holds the host-stage kinds a module can share: the sorting
circuit of `build_sort_circuit(n=8)` (a PermutationSort into the AS-Waksman
network it drives, a decimal ToLeRadix, a Brillig block that asks an oracle)
with, appended, a general-radix ToLeRadix (radix 3 into 5 digits, too few for
some instances), a PermutationSort of pairs with duplicates sorted by two
columns, and two straight-line Brillig blocks planned with
``device_brillig_trace=False`` (so host stages), one under a predicate.  It
is planned once by each package and solved over 64 instances, one of them
failing a key's ``Range``; the port is held at tolerance 0 to (1) the JAX
``BatchSolver`` on the CPU, its levels and host stages run one by one (its
``_run_level`` and ``_run_host_stages``, as its segments run them: about 30 s
of compiling, against about 45 s for its jitted segments), (2) the
sequential engine ``acvm_tpu.pwg.ACVM`` and (3) Python ints: witness values,
``ok`` flags and first-failure opcode indices.

The other cases are small circuits of host stages alone: an ``UnsignedDiv`` by
zero (both packages raise ``ZeroDivisionError`` out of the per-instance VM,
while the device trace gives 0: ROADMAP queue 3), a foreign call with no
handler, a Schnorr verification under a challenge hook, a block of the device
Brillig VM (run on it, and instance by instance when asked), a 256-bit Brillig add (reduced mod p, as the VM does;
ROADMAP queue 3), and the two ingest forms.
"""

import types

import jax
import numpy as np
import pytest
import torch

from acvm_tpu import acir as jacir
from acvm_tpu import brillig as jbr
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.blackbox import GrumpkinSolver as JGrumpkinSolver
from acvm_tpu.blackbox import grumpkin as jgk
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.fields.params import BN254_FR as JBN254_FR
from acvm_tpu.pwg import ACVM, ACVMStatus
from acvm_tpu.tpu import BatchSolver as JBatchSolver, plan_circuit as jplan_circuit
from acvm_tpu.utils import bench_circuits as jbench

from acvm_tpu_torch import convert
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.blackbox import grumpkin as gk
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, plan_circuit
from acvm_tpu_torch.gpu.batch_solver import _decode_foreign_call_result
from acvm_tpu_torch.utils import (
    PORT_CLASSES, build_gadget_circuit, build_sort_circuit, oracle_affine, sort_circuit_roles,
    sort_inputs, sort_network_bits,
)
from acvm_tpu_torch.utils.profiling import SolveStats

P = BN254_FR.modulus
BATCH, FAIL_B = 64, 5
JAX_LIB = types.SimpleNamespace(Circuit=jacir.Circuit, Expression=jacir.Expression,
                                Witness=jacir.Witness, FieldElement=JFieldElement, opcodes=jops,
                                brillig=jbr)


def host_config(params, brillig_trace=False):
    """An EngineConfig-like object: Brillig blocks to host stages."""
    return types.SimpleNamespace(field_params=lambda: params, device_hash_kernels=True,
                                 device_brillig_trace=brillig_trace)


def plans(circuit_fn, brillig_trace=False):
    """(port plan, JAX plan) of the circuit each package's classes build."""
    return (plan_circuit(circuit_fn(PORT_CLASSES), config=host_config(BN254_FR, brillig_trace)),
            jplan_circuit(circuit_fn(JAX_LIB), config=host_config(JBN254_FR, brillig_trace)))


def jax_solve(solver, inputs):
    """The JAX BatchSolver's segments one level at a time, then their host
    stages: (W, ok, fail) on the host."""
    W, ok, fail, mem = solver.initial_state(inputs)
    for segment in solver.segments:
        for packed in segment.levels:
            W, ok, fail, mem = solver._run_level(W, ok, fail, mem, packed)
        if segment.host_stages:
            W, ok, fail = solver._run_host_stages(W, ok, fail, segment.host_stages)
    return jax.device_get((W, ok, fail))


def assert_equals_jax(res, jax_state, num_witnesses):
    W, ok, fail = jax_state
    np.testing.assert_array_equal(res.panel.numpy(), convert.panel_from_jax(W, num_witnesses))
    assert res.ok.tolist() == np.asarray(ok).tolist()
    assert res.fail.tolist() == np.asarray(fail).tolist()


def sequential(jcircuit, assignment, handler=None, backend=None):
    """pwg.ACVM on one instance, answering foreign calls with ``handler``:
    (status, acvm)."""
    wm = jacir.WitnessMap({jacir.Witness(w): JFieldElement(int(v)) for w, v in assignment.items()})
    acvm = ACVM(backend or JGrumpkinSolver(), jcircuit.opcodes, wm)
    while acvm.solve() == ACVMStatus.REQUIRES_FOREIGN_CALL:
        call = acvm.get_pending_foreign_call()
        answer = handler(call.function, [[v.to_field() for v in group] for group in call.inputs])
        acvm.resolve_pending_foreign_call(jbr.ForeignCallResult(
            tuple(jbr.FcSingle(jbr.Value(JFieldElement(int(a)))) for a in answer)))
    return acvm.status, acvm


def instance(cols, b):
    return {w: int(a[b]) for w, a in cols.items()}


# ---------------------------------------------------------------------------
# The shared circuit
# ---------------------------------------------------------------------------

N_KEYS, RADIX3_DIGITS, N_PAIRS = 8, 5, 6


def host_circuit(lib):
    """`build_sort_circuit(8)` and, appended: ToLeRadix(x, 3) into 5 digits,
    PermutationSort of 6 pairs (u_i, v_i) by (v, u), and two straight-line
    Brillig blocks over (a, b): int ops at 32, 64 and 128 bits, field Div and
    Mul, SignedDiv at 8 bits, a Mov; the second reads a + 2^40 x (wide
    operands) under the predicate q."""
    base = build_sort_circuit(N_KEYS, lib=lib)
    o, fe, W, b = lib.opcodes, lib.FieldElement, lib.Witness, lib.brillig
    R, I, Fo = b.RegisterIndex, b.BinaryIntOp, b.BinaryFieldOp
    nxt = base.current_witness_index + 1
    x = W(nxt)
    pairs = [(W(nxt + 1 + 2 * i), W(nxt + 2 + 2 * i)) for i in range(N_PAIRS)]
    a, bw, q = W(nxt + 13), W(nxt + 14), W(nxt + 15)
    nxt += 16
    inputs = {x, a, bw, q, *(w for pair in pairs for w in pair)}

    def fresh(k):
        nonlocal nxt
        nxt += k
        return [W(nxt - k + i) for i in range(k)]

    opcodes = list(base.opcodes)
    opcodes.append(o.OpcodeDirective(o.DirToLeRadix(lib.Expression.from_witness(x),
                                                    fresh(RADIX3_DIGITS), 3)))
    opcodes.append(o.OpcodeDirective(o.DirPermutationSort(
        inputs=[[lib.Expression.from_witness(u), lib.Expression.from_witness(v)] for u, v in pairs],
        tuple_size=2, bits=fresh(sort_network_bits(N_PAIRS)), sort_by=[1, 0])))
    code = [b.OpBinaryIntOp(R(2), I.Add, 32, R(0), R(1)),
            b.OpBinaryIntOp(R(3), I.Mul, 64, R(0), R(1)),
            b.OpBinaryIntOp(R(4), I.Sub, 128, R(1), R(0)),
            b.OpBinaryFieldOp(R(5), Fo.Div, R(0), R(1)),
            b.OpBinaryIntOp(R(6), I.SignedDiv, 8, R(0), R(1)),
            b.OpBinaryIntOp(R(7), I.LessThan, 32, R(0), R(1)),
            b.OpBinaryFieldOp(R(0), Fo.Mul, R(5), R(3)),
            b.OpMov(R(1), R(6)),
            b.OpStop()]
    wide = lib.Expression(linear_combinations=[(fe(1), a), (fe(1 << 40), x)])
    for ins, pred in (([lib.Expression.from_witness(a), lib.Expression.from_witness(bw)], None),
                      ([wide, lib.Expression.from_witness(bw)], lib.Expression.from_witness(q))):
        opcodes.append(o.OpcodeBrillig(o.Brillig(
            inputs=[o.BrilligInputSingle(e) for e in ins],
            outputs=[o.BrilligOutputSimple(w) for w in fresh(8)], foreign_call_results=[],
            bytecode=code, predicate=pred)))
    return lib.Circuit(current_witness_index=nxt - 1, opcodes=opcodes,
                       private_parameters=set(base.private_parameters) | inputs)


def host_inputs(circuit, batch=BATCH, seed=3):
    """The sort keys of `sort_inputs` (instance FAIL_B fails a key's Range),
    x in 0..299 (x >= 243 needs a sixth ternary digit: the ToLeRadix fails),
    pairs of values in 0..3 (duplicates), a and b u32 (b zero in every
    eighth instance), q 0 or 1."""
    base = build_sort_circuit(N_KEYS)
    cols, fail_op = sort_inputs(base, batch, fail_instance=FAIL_B)
    rng = np.random.default_rng(seed)
    nxt = base.current_witness_index + 1
    cols[nxt] = rng.integers(0, 300, size=batch, dtype=np.uint64)
    for i in range(2 * N_PAIRS):
        cols[nxt + 1 + i] = rng.integers(0, 4, size=batch, dtype=np.uint64)
    cols[nxt + 13] = rng.integers(0, 1 << 32, size=batch, dtype=np.uint64)
    cols[nxt + 14] = rng.integers(0, 1 << 32, size=batch, dtype=np.uint64)
    cols[nxt + 14][::8] = 0
    cols[nxt + 15] = rng.integers(0, 2, size=batch, dtype=np.uint64)
    return cols, fail_op


@pytest.fixture(scope="module")
def shared():
    plan, jplan = plans(host_circuit)
    circuit = plan.circuit
    cols, fail_op = host_inputs(circuit)
    stats = SolveStats()
    res = BatchSolver(plan, foreign_call_handler=oracle_affine, device="cpu").solve(cols, stats=stats)
    jsolver = JBatchSolver(jplan, foreign_call_handler=oracle_affine)
    return dict(plan=plan, jplan=jplan, circuit=circuit, jcircuit=jplan.circuit, cols=cols,
                fail_op=fail_op, res=res, stats=stats, jsolver=jsolver,
                jax=jax_solve(jsolver, cols))


def radix3_index(circuit):
    return next(i for i, op in enumerate(circuit.opcodes)
                if isinstance(op, ops.OpcodeDirective) and isinstance(op.directive, ops.DirToLeRadix)
                and op.directive.radix == 3)


def test_host_stages_plan_as_the_jax_package_s(shared):
    plan, jplan = shared["plan"], shared["jplan"]
    host = [[(h.opcode_indices, h.reads, h.writes, h.known_before) for h in lv.host]
            for lv in plan.levels]
    jhost = [[(h.opcode_indices, h.reads, h.writes, h.known_before) for h in lv.host]
             for lv in jplan.levels]
    assert host == jhost
    # sort + radix 3 + pair sort + the two Brillig blocks at level 0; the
    # decimal radix and the oracle block read the total, solved at level 0
    assert [len(h) for h in host if h] == [5, 2]
    solver = BatchSolver(plan, foreign_call_handler=oracle_affine, device="cpu")
    assert [len(s.host_stages) for s in solver.segments] == [5, 2, 0]
    assert len(solver.segments) == len(shared["jsolver"].segments) == 3


def test_host_stages_match_jax_batch_solver(shared):
    res = shared["res"]
    assert_equals_jax(res, shared["jax"], shared["circuit"].num_vars())
    x = shared["cols"][build_sort_circuit(N_KEYS).current_witness_index + 1]
    want_fail = [radix3_index(shared["circuit"]) if v >= 3 ** RADIX3_DIGITS else int(FAIL_NONE)
                 for v in x.tolist()]
    want_fail[FAIL_B] = shared["fail_op"]
    assert res.fail.tolist() == want_fail
    assert res.ok.tolist() == [f == int(FAIL_NONE) for f in want_fail]
    assert shared["stats"].host_per_instance_stages == 1  # the oracle block
    assert len(shared["stats"].host_stage_seconds) == 2 and len(shared["stats"].segment_seconds) == 3


def test_host_stages_match_sequential_engine_and_ints(shared):
    """Every instance through pwg.ACVM: a satisfied one gives the same
    witness map, a failing one stops at the same opcode; the sorted keys,
    the decimal digits and the oracle's answer against Python ints."""
    res, circuit, cols = shared["res"], shared["circuit"], shared["cols"]
    ints = {w: res.witness_ints(w) for w in range(1, circuit.num_vars())}
    roles = sort_circuit_roles(N_KEYS)
    (total,), (answer,), digits = roles["total"], roles["answer"], roles["digits"]
    for b in range(BATCH):
        status, acvm = sequential(shared["jcircuit"], instance(cols, b), oracle_affine)
        if res.fail[b] == FAIL_NONE:
            assert status == ACVMStatus.SOLVED, b
            wm = acvm.finalize()
            got = [ints[w][b] for w in range(1, circuit.num_vars())]
            assert got == [int(wm.get(jacir.Witness(w))) for w in range(1, circuit.num_vars())], b
            keys = [int(cols[1 + i][b]) for i in range(N_KEYS)]
            assert ints[total][b] == sum(keys)
            assert [ints[d][b] for d in digits] == [sum(keys) // 10 ** j % 10 for j in range(12)]
            assert ints[answer][b] == (3 * sum(keys) + 1) % P
        else:
            assert status == ACVMStatus.FAILURE
            assert acvm.instruction_pointer == res.fail[b], b
    # the network's outputs are the sorted keys, the failing instance's too
    for b in range(BATCH):
        keys = sorted(int(cols[1 + i][b]) for i in range(N_KEYS))
        assert [ints[w][b] for w in roles["sorted"]] == keys
        assert [ints[d][b] for d in roles["diffs"]] == [hi - lo for lo, hi in zip(keys, keys[1:])]


def test_host_batch_off_gives_the_per_instance_route(shared, monkeypatch):
    """host_batch=False runs every host-stage opcode instance by instance,
    as the JAX package does under ACVM_TPU_NO_HOST_BATCH: the same bits, but
    for the digits of a ToLeRadix that fails, which the batched route writes
    (the low digits) and the sequential solver does not (zeros), in both
    packages."""
    plan, cols = shared["plan"], shared["cols"]
    stats = SolveStats()
    res = BatchSolver(plan, foreign_call_handler=oracle_affine, device="cpu",
                      host_batch=False).solve(cols, stats=stats)
    assert stats.host_per_instance_stages == 7
    monkeypatch.setenv("ACVM_TPU_NO_HOST_BATCH", "1")
    assert_equals_jax(res, jax_solve(shared["jsolver"], cols), shared["circuit"].num_vars())
    batched = shared["res"]
    assert res.ok.tolist() == batched.ok.tolist() and res.fail.tolist() == batched.fail.tolist()
    digits = plan.circuit.opcodes[radix3_index(plan.circuit)].directive.b
    failing = [b for b, f in enumerate(res.fail) if f == radix3_index(plan.circuit)]
    assert failing
    same = np.ones(BATCH, bool)
    same[failing] = False
    a, b_ = res.panel.numpy(), batched.panel.numpy()
    np.testing.assert_array_equal(a[:, same], b_[:, same])
    rows = [int(w) for w in digits]
    mask = np.ones(a.shape[0], bool)
    mask[rows] = False
    np.testing.assert_array_equal(a[mask], b_[mask])
    assert not a[rows][:, failing].any()
    x = cols[build_sort_circuit(N_KEYS).current_witness_index + 1]
    for b in failing:
        assert [batched.witness_ints(w)[b] for w in rows] == [
            int(x[b]) // 3 ** j % 3 for j in range(RADIX3_DIGITS)]


# ---------------------------------------------------------------------------
# Small circuits of host stages alone
# ---------------------------------------------------------------------------


def brillig_circuit(lib, code, n_in=2, n_out=1, fc=()):
    o, W = lib.opcodes, lib.Witness
    return lib.Circuit(
        current_witness_index=n_in + n_out,
        opcodes=[o.OpcodeBrillig(o.Brillig(
            inputs=[o.BrilligInputSingle(lib.Expression.from_witness(W(1 + i))) for i in range(n_in)],
            outputs=[o.BrilligOutputSimple(W(1 + n_in + i)) for i in range(n_out)],
            foreign_call_results=list(fc), bytecode=code, predicate=None))],
        private_parameters={W(1 + i) for i in range(n_in)},
    )


def udiv(lib):
    b = lib.brillig
    return brillig_circuit(lib, [b.OpBinaryIntOp(b.RegisterIndex(0), b.BinaryIntOp.UnsignedDiv, 32,
                                                 b.RegisterIndex(0), b.RegisterIndex(1)), b.OpStop()])


def test_unsigned_div_by_zero_raises_as_the_jax_host_path():
    """A zero divisor makes run_brillig_batch raise HostBatchFallback in both
    packages; the per-instance VM then raises ZeroDivisionError out of the
    solve, in the JAX package, in the port and in pwg.ACVM.  The device
    trace gives 0 (ROADMAP queue 3)."""
    plan, jplan = plans(udiv)
    cols = {1: np.array([7, 9, 10, 3], np.uint64), 2: np.array([2, 3, 0, 5], np.uint64)}
    with pytest.raises(ZeroDivisionError):
        BatchSolver(plan, device="cpu").solve(cols)
    jsolver = JBatchSolver(jplan)
    with pytest.raises(ZeroDivisionError):
        jax_solve(jsolver, cols)
    with pytest.raises(ZeroDivisionError):
        sequential(jplan.circuit, {1: 10, 2: 0})
    traced = BatchSolver(plan_circuit(udiv(PORT_CLASSES)), device="cpu").solve(cols)
    assert traced.witness_ints(3) == [3, 3, 0, 0]
    ok_cols = {1: cols[1], 2: np.array([2, 3, 4, 5], np.uint64)}
    res = BatchSolver(plan, device="cpu").solve(ok_cols)
    assert_equals_jax(res, jax_solve(jsolver, ok_cols), plan.circuit.num_vars())
    assert res.witness_ints(3) == [3, 3, 2, 0]


def oracle_block(lib):
    b = lib.brillig
    r0 = b.RomRegister(b.RegisterIndex(0))
    return brillig_circuit(lib, [b.OpForeignCall("oracle_affine", (r0,), (r0,)), b.OpStop()], n_in=1)


def test_foreign_call_with_and_without_a_handler():
    plan, jplan = plans(oracle_block, brillig_trace=True)  # a foreign call is a host stage anyway
    assert [len(lv.host) for lv in plan.levels] == [1]
    cols = {1: np.array([0, 5, P - 1], dtype=object)}
    stats = SolveStats()
    res = BatchSolver(plan, foreign_call_handler=oracle_affine, device="cpu").solve(cols, stats=stats)
    assert res.ok.all() and res.witness_ints(2) == [1, 16, (3 * (P - 1) + 1) % P]
    assert stats.host_per_instance_stages == 1
    assert_equals_jax(res, jax_solve(JBatchSolver(jplan, foreign_call_handler=oracle_affine), cols), 3)
    res = BatchSolver(plan, device="cpu").solve(cols)  # no handler: every instance fails there
    assert not res.ok.any() and res.fail.tolist() == [0, 0, 0] and res.witness_ints(2) == [0, 0, 0]
    assert_equals_jax(res, jax_solve(JBatchSolver(jplan), cols), 3)


def test_hooked_schnorr_is_a_host_stage():
    """With a challenge hook set, both planners send SchnorrVerify to a host
    stage, solved instance by instance by the backend (GrumpkinSolver, which
    calls the hook); a solver planned for the device before the hook was set
    is refused at solve."""
    def hook(r_x, pub, message):
        return (r_x * 7 + pub[0] + len(message)) % (1 << 64)

    circuit = build_gadget_circuit("schnorr", 1, msg_len=3)
    device_solver = BatchSolver(plan_circuit(circuit), device="cpu")
    gk.set_schnorr_challenge_hook(hook)
    jgk.set_schnorr_challenge_hook(hook)
    try:
        plan = plan_circuit(circuit)
        assert [len(lv.host) for lv in plan.levels] == [1] and not plan.levels[0].schnorr
        jplan = jplan_circuit(jbench.build_gadget_circuit("schnorr", 1, msg_len=3))
        key = 12345
        pub_x, pub_y = gk.schnorr_public_key(key)
        message = b"abc"
        sig = gk.schnorr_sign(key, message)
        forged = bytes([sig[0] ^ 1]) + sig[1:]
        rows = []
        for s in (sig, forged, sig):
            row = {1: int(pub_x), 2: int(pub_y)}
            row.update({3 + i: v for i, v in enumerate(s)})
            row.update({67 + i: v for i, v in enumerate(message)})
            rows.append(row)
        rows[2][2] = int(pub_y) + 1  # off the curve
        stats = SolveStats()
        res = BatchSolver(plan, device="cpu").solve(rows, stats=stats)
        assert res.ok.all() and res.witness_ints(70) == [1, 0, 0]
        assert stats.host_per_instance_stages == 1
        assert_equals_jax(res, jax_solve(JBatchSolver(jplan), rows), 71)
        for b, row in enumerate(rows):
            status, acvm = sequential(jplan.circuit, row)
            assert int(acvm.finalize().get(jacir.Witness(70))) == res.witness_ints(70)[b]
        with pytest.raises(RuntimeError, match="challenge hook"):
            device_solver.solve(rows)
    finally:
        gk.set_schnorr_challenge_hook(None)
        jgk.set_schnorr_challenge_hook(None)


def jump_block(lib):
    """A branchy block: r2 = (r0 < r1) ? r0 : r1 through a JumpIf."""
    b = lib.brillig
    R = b.RegisterIndex
    return brillig_circuit(lib, [
        b.OpBinaryIntOp(R(2), b.BinaryIntOp.LessThan, 32, R(0), R(1)),
        b.OpJumpIf(R(2), 4),
        b.OpMov(R(0), R(1)),
        b.OpStop(),
        b.OpStop(),
    ])


def test_device_vm_block_raises_and_runs_per_instance_only_when_asked():
    """The JAX package runs this block on its device Brillig VM, and so does
    the port now (its plain version here): no per-instance stage.  Under
    host_batch=False it runs instance by instance (the JAX package's route
    under ACVM_TPU_NO_HOST_BATCH): the same panel, and pwg.ACVM's values."""
    plan, _ = plans(jump_block, brillig_trace=True)  # the trace does not take a jump
    cols = {1: np.array([3, 9, 5], np.uint64), 2: np.array([4, 2, 5], np.uint64)}
    stats = SolveStats()
    res = BatchSolver(plan, device="cpu").solve(cols, stats=stats)
    assert res.ok.all() and res.witness_ints(3) == [3, 2, 5] and stats.host_per_instance_stages == 0
    per_stats = SolveStats()
    per = BatchSolver(plan, device="cpu", host_batch=False).solve(cols, stats=per_stats)
    assert torch.equal(per.panel, res.panel) and per_stats.host_per_instance_stages == 1
    for b in range(3):
        status, acvm = sequential(jump_block(JAX_LIB), instance(cols, b))
        assert int(acvm.finalize().get(jacir.Witness(3))) == res.witness_ints(3)[b]


def wide_add(lib):
    b = lib.brillig
    R = b.RegisterIndex
    return brillig_circuit(lib, [b.OpBinaryIntOp(R(0), b.BinaryIntOp.Add, 256, R(0), R(1)),
                                 b.OpBinaryIntOp(R(1), b.BinaryIntOp.Add, 32, R(1), R(1)),
                                 b.OpStop()], n_out=2)


def test_wide_brillig_int_results_are_reduced_as_the_vm_does():
    """A 256-bit Add of p - 1 and 5 is p + 4 mod 2^256: the VM stores it as a
    field element (4).  The JAX host batch keeps p + 4 (ROADMAP queue 3); the
    port equals pwg.ACVM."""
    plan, jplan = plans(wide_add)
    cols = {1: np.array([P - 1, 1], dtype=object), 2: np.array([5, 2], dtype=object)}
    res = BatchSolver(plan, device="cpu").solve(cols)
    W, _, _ = jax_solve(JBatchSolver(jplan), cols)
    jax_ints = convert.panel_from_jax(W, 5)
    assert res.witness_ints(3) == [4, 3] and res.witness_ints(4) == [10, 4]
    from acvm_tpu_torch.fields.kernels import limbs32_to_ints
    assert limbs32_to_ints(jax_ints[3]) == [P + 4, 3]  # the JAX host batch's fault
    for b in range(2):
        status, acvm = sequential(jplan.circuit, instance(cols, b))
        assert [int(acvm.finalize().get(jacir.Witness(w))) for w in (3, 4)] == [
            res.witness_ints(3)[b], res.witness_ints(4)[b]]


# ---------------------------------------------------------------------------
# The two ingest forms
# ---------------------------------------------------------------------------


def test_packed_matrix_form_equals_the_dict_form():
    circuit = build_sort_circuit(4)
    solver = BatchSolver(plan_circuit(circuit), foreign_call_handler=oracle_affine, device="cpu")
    rng = np.random.default_rng(1)
    for dtype in (np.uint8, np.uint16):
        mat = rng.integers(0, np.iinfo(dtype).max + 1, size=(6, 4), dtype=dtype)
        order = [3, 1, 4, 2]  # columns in any order
        res = solver.solve((order, mat))
        want = solver.solve([{w: int(mat[b, k]) for k, w in enumerate(order)} for b in range(6)])
        assert res.ok.all()
        np.testing.assert_array_equal(res.panel.numpy(), want.panel.numpy())
        assert res.witness_maps() == want.witness_maps()
        on_device = solver.solve((order, torch.from_numpy(mat.astype(np.int64)).to(
            torch.uint8 if dtype == np.uint8 else torch.uint16)))
        np.testing.assert_array_equal(on_device.panel.numpy(), want.panel.numpy())
    with pytest.raises(ValueError, match="uint8/uint16"):
        solver.solve(([1, 2, 3, 4], np.zeros((2, 4), np.uint32)))
    with pytest.raises(ValueError, match="uint8/uint16"):
        solver.solve(([1, 2, 3, 4], torch.zeros((2, 4), dtype=torch.int32)))
    with pytest.raises(ValueError, match="duplicate"):
        solver.solve(([1, 2, 2, 4], np.zeros((2, 4), np.uint8)))
    with pytest.raises(ValueError, match="4 columns"):
        solver.solve(([1, 2, 3, 4], np.zeros((2, 3), np.uint8)))
    with pytest.raises(ValueError, match="solver's device"):
        solver.solve(([1, 2, 3, 4], torch.zeros((2, 4), dtype=torch.uint8, device="meta")))


def test_tensor_columns_on_the_cpu():
    """Columns as CPU tensors for a CPU solver: uint8/uint16 ones are
    stacked and scattered as tensors, others come to the host columnar path;
    both give the numpy columns' panel.  A tensor on another device is
    refused."""
    circuit = build_sort_circuit(4)
    solver = BatchSolver(plan_circuit(circuit), foreign_call_handler=oracle_affine, device="cpu")
    rng = np.random.default_rng(2)
    keys = {w: rng.integers(0, 1 << 16, size=5, dtype=np.uint64) for w in range(1, 5)}
    want = solver.solve(keys)
    for dtype in (torch.uint16, torch.int64):
        cols = {w: torch.from_numpy(a.astype(np.int64)).to(dtype) for w, a in keys.items()}
        np.testing.assert_array_equal(solver.solve(cols).panel.numpy(), want.panel.numpy())
    small = {w: a % 256 for w, a in keys.items()}
    cols = {w: torch.from_numpy(a.astype(np.uint8)) for w, a in small.items()}
    np.testing.assert_array_equal(solver.solve(cols).panel.numpy(), solver.solve(small).panel.numpy())
    with pytest.raises(ValueError, match="solver's device"):
        solver.solve({w: torch.zeros(5, dtype=torch.uint8, device="meta") for w in keys})
    with pytest.raises(ValueError, match=r"shape \(4,\)"):
        solver.solve({1: torch.zeros(5, dtype=torch.uint8), 2: torch.zeros(4, dtype=torch.uint8)})


def test_decode_foreign_call_result_matches_the_jax_api():
    from acvm_tpu.api import _decode_foreign_call_result as jdecode

    outputs = [5, "0x0a", [1, 2, P - 1]]
    got, want = _decode_foreign_call_result(outputs), jdecode(outputs)
    assert repr(got) == repr(want).replace("acvm_tpu.", "acvm_tpu_torch.")
