"""The port's device Brillig VM on the CPU (its plain version), tolerance 0.

Two circuits are built once by each package: the slice's program with
unconstrained loops (`build_brillig_vm_circuit(6)`: an insertion sort of 6
keys, an integer square root, a trapping inverse) and the JAX package's three
device-VM fixtures with a predicated copy of one (`build_brillig_vm_edges_circuit`),
over one batch of 64 instances.  Each block's `run_brillig_vm_batch` is held to
the JAX package's (`acvm_tpu.tpu.brillig_vm_device`) and to its sequential VM,
and the whole program through `BatchSolver` to the JAX `BatchSolver` (its
levels and host stages run one by one) and to `acvm_tpu.pwg.ACVM`.

The JAX VM compiles one `lax.while_loop` a block and batch size: every JAX
call here uses the same batch, and its `_run_vm` is called with `unroll=1` in
place of its default 4, which makes the compile of the three slice blocks
about four times shorter (some 20 s against some 110 s on a CPU).  The unroll
does not change a result: each unrolled step gates every write on the
instance being live (`acvm_tpu/tpu/brillig_vm_device.py:292-298`), and the loop
tests its step count against the budget before each group of `unroll` steps;
the budget `64 n_pc + 1024` is a multiple of 4, so both settings stop at the
same step.  No JAX test compares the two settings.  The JAX package's
`tests/test_brillig_vm_device.py::test_divergent_loop_matches_host`,
`::test_binary_search_matches_host` and `::test_call_return_and_trap_flags`
hold the default unroll to the sequential VM on its three fixtures, and
`test_jax_fixtures_match_the_jax_device_vm` here holds `unroll=1` to the same
sequential VM on the same three programs.  The remaining cases hold the port to the
sequential VM and Python ints: the escapes (step budget, call depth, a pointer
past the memory cap) rerun instance by instance, the predicate, array outputs,
and each place where the references disagree (ROADMAP queue 3).
"""

import functools
import math
import types

import numpy as np
import pytest
import torch

from acvm_tpu import acir as jacir
from acvm_tpu import brillig as jbr
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.blackbox import GrumpkinSolver as JGrumpkinSolver
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.pwg import ACVM, ACVMStatus
from acvm_tpu.pwg.brillig_solver import BrilligSolver as JBrilligSolver
from acvm_tpu.pwg.errors import OpcodeResolutionError as JOpcodeResolutionError
from acvm_tpu.tpu import BatchSolver as JBatchSolver, plan_circuit as jplan_circuit
from acvm_tpu.tpu import brillig_vm_device as jvm
from acvm_tpu.tpu import host_batch as jhost_batch

from acvm_tpu_torch import brillig as br
from acvm_tpu_torch import convert
from acvm_tpu_torch.acir import Circuit, Expression, Witness
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.fields.kernels import int_to_limbs32
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, brillig_vm_device as vm, host_batch, plan_circuit
from acvm_tpu_torch.utils import PORT_CLASSES
from acvm_tpu_torch.utils.bench_circuits import (
    brillig_vm_circuit_roles, brillig_vm_edge_inputs, brillig_vm_inputs, build_brillig_vm_circuit,
    build_brillig_vm_edges_circuit, build_brillig_vm_wide_registers_circuit,
)
from acvm_tpu_torch.utils.profiling import SolveStats

P = BN254_FR.modulus
BATCH, N_KEYS = 64, 6
JAX_LIB = types.SimpleNamespace(Circuit=jacir.Circuit, Expression=jacir.Expression,
                                Witness=jacir.Witness, FieldElement=JFieldElement, opcodes=jops,
                                brillig=jbr)


@pytest.fixture(scope="module", autouse=True)
def jax_vm_without_unroll():
    original = jvm._run_vm
    jvm._run_vm = functools.partial(original, unroll=1)
    yield
    jvm._run_vm = original


def object_cols(cols):
    return {int(w): np.asarray(v).astype(object) for w, v in cols.items()}


@pytest.fixture(scope="module")
def slice_circuits():
    """(port circuit, JAX circuit, columns with the sum, expected failures)."""
    circuit = build_brillig_vm_circuit(N_KEYS)
    jcircuit = build_brillig_vm_circuit(N_KEYS, lib=JAX_LIB)
    cols, fails = brillig_vm_inputs(circuit, BATCH)
    full = object_cols(cols)
    full[brillig_vm_circuit_roles(N_KEYS)["total"][0]] = sum(full[1 + i] for i in range(N_KEYS)) % P
    return circuit, jcircuit, cols, full, fails


@pytest.fixture(scope="module")
def edge_circuits():
    cols, expected, trap = brillig_vm_edge_inputs(BATCH)
    return (build_brillig_vm_edges_circuit(), build_brillig_vm_edges_circuit(lib=JAX_LIB), cols,
            expected, trap)


def sequential_block(jbrillig, cols, b):
    """The JAX package's sequential VM on one instance of one block: its
    output values, or None where it fails."""
    wm = jacir.WitnessMap({jacir.Witness(w): JFieldElement(int(v[b])) for w, v in cols.items()})
    try:
        JBrilligSolver.solve(wm, jbrillig, JGrumpkinSolver(), 0)
    except JOpcodeResolutionError:
        return None
    outs = []
    for out in jbrillig.outputs:
        ws = [out.witness] if isinstance(out, jops.BrilligOutputSimple) else out.witnesses
        outs += [int(wm.get(w)) for w in ws]
    return outs


def assert_block_equal(brillig, jbrillig, cols):
    """The port's VM (plain version) against the JAX device VM and, instance
    by instance, the sequential VM: values and trap flags."""
    get = lambda w: cols[int(w)]  # noqa: E731
    values, trapped = vm.run_brillig_vm_batch(brillig, get, BATCH, P, device="cpu")
    jvalues, jtrapped = jvm.run_brillig_vm_batch(jbrillig, get, BATCH, P)
    assert values.keys() == jvalues.keys()
    for w in values:
        assert values[w].tolist() == jvalues[w].tolist(), w
    assert trapped.tolist() == jtrapped.tolist()
    for b in range(BATCH):
        seq = sequential_block(jbrillig, cols, b)
        assert (seq is None) == bool(trapped[b]), b
        got = [int(values[int(w)][b]) for out in brillig.outputs
               for w in ([out.witness] if isinstance(out, ops.BrilligOutputSimple) else out.witnesses)]
        assert seq is None or seq == got, b
    return values, trapped


@pytest.mark.parametrize("block", ["sort", "isqrt", "inverse"])
def test_slice_blocks_match_the_jax_device_vm(slice_circuits, block):
    circuit, jcircuit, _, cols, _ = slice_circuits
    index = brillig_vm_circuit_roles(N_KEYS)["blocks"][["sort", "isqrt", "inverse"].index(block)]
    values, trapped = assert_block_equal(circuit.opcodes[index].brillig,
                                         jcircuit.opcodes[index].brillig, cols)
    keys = [[int(cols[1 + i][b]) for i in range(N_KEYS)] for b in range(BATCH)]
    if block == "sort":  # an array output, compared at 32 bits (2^32 sorts as 0)
        got = np.array([values[w] for w in sorted(values)]).T.tolist()
        assert got == [sorted(k, key=lambda v: v % 2**32) for k in keys]
    elif block == "isqrt":
        assert list(values.values())[0].tolist() == [math.isqrt(sum(k)) for k in keys]
    else:
        assert trapped.tolist() == [k[0] == k[1] for k in keys]
        assert list(values.values())[0].tolist() == [
            0 if k[0] == k[1] else pow(k[0] - k[1], -1, P) for k in keys]


@pytest.mark.parametrize("block", ["sum_loop", "binary_search", "call_trap", "predicated"])
def test_jax_fixtures_match_the_jax_device_vm(edge_circuits, block):
    circuit, jcircuit, cols, expected, trap = edge_circuits
    index = ["sum_loop", "binary_search", "call_trap", "predicated"].index(block)
    values, trapped = assert_block_equal(circuit.opcodes[index].brillig,
                                         jcircuit.opcodes[index].brillig, object_cols(cols))
    (w, got), = values.items()
    assert got.tolist() == expected[w]
    assert trapped.tolist() == (trap.tolist() if block == "call_trap" else [False] * BATCH)


WIDE_ARRAY = 256  # words of the binary search's array: its memory is past the on-chip tier


@pytest.fixture(scope="module")
def wide_search():
    """The binary search over 256 words (`build_brillig_vm_edges_circuit(array=256)`,
    block 1) in both packages, with its columns and Python's answers."""
    cols, expected, _ = brillig_vm_edge_inputs(BATCH, array=WIDE_ARRAY)
    return (build_brillig_vm_edges_circuit(array=WIDE_ARRAY).opcodes[1].brillig,
            build_brillig_vm_edges_circuit(lib=JAX_LIB, array=WIDE_ARRAY).opcodes[1].brillig,
            object_cols(cols), expected[4 + WIDE_ARRAY])


def test_binary_search_over_256_words_matches_every_reference(wide_search):
    """The block whose memory (2 x 256 + 32 cells) the kernel keeps in device
    memory: the plain version against the JAX device VM, its sequential VM,
    pwg.ACVM on the block alone and Python's bisect, instance by instance."""
    brillig, jbrillig, cols, want = wide_search
    program, regs, mem = vm.initial_state(brillig, lambda w: cols[int(w)], BATCH, P, "cpu")
    plan = vm.vm_plan_for(program, regs, mem)
    assert mem.shape[0] == 2 * WIDE_ARRAY + 32 and plan.regs_on_chip and not plan.mem_on_chip
    values, trapped = assert_block_equal(brillig, jbrillig, cols)
    out = 4 + WIDE_ARRAY
    assert values[out].tolist() == want and not trapped.any()
    for b in range(BATCH):
        wm = jacir.WitnessMap({jacir.Witness(w): JFieldElement(int(v[b])) for w, v in cols.items()})
        acvm = ACVM(JGrumpkinSolver(), [jops.OpcodeBrillig(jbrillig)], wm)
        assert acvm.solve() == ACVMStatus.SOLVED
        assert int(acvm.finalize().get(jacir.Witness(out))) == want[b], b


# (registers, memory cells, opcodes) -> (table, registers, memory on chip)
PLANS = {
    "sort": ((10, 64, 22), (True, True, True)),
    "registers_300": ((300, 32, 9), (True, False, False)),
    "memory_544_cells": ((11, 2 * WIDE_ARRAY + 32, 18), (True, True, False)),
    "table_over_48_kb": ((4, 32, 800), (False, True, True)),
    "no_load_or_store": ((10, 0, 18), (True, True, False)),
}
# The fixture blocks of those shapes: run_vm must plan their own state so.
PLAN_BLOCKS = {
    "sort": lambda: build_brillig_vm_circuit(16).opcodes[brillig_vm_circuit_roles(16)["blocks"][0]].brillig,
    "registers_300": lambda: build_brillig_vm_wide_registers_circuit().opcodes[0].brillig,
    "memory_544_cells": lambda: build_brillig_vm_edges_circuit(array=WIDE_ARRAY).opcodes[1].brillig,
}


@pytest.mark.parametrize("batch", [1, 32, 33, 8192])
@pytest.mark.parametrize("case", list(PLANS))
def test_vm_launch_plan(case, batch):
    """One warp a block over the whole batch; the table, then the registers,
    then the memory on chip where each still fits in the 227 KB a block may
    have; the shared bytes are exactly what the kernel lays out.  A fixture
    block of the case's shape (the sort, the 300-register sum loop, the
    256-word binary search) gets the same plan from its own state."""
    (n_regs, mem_cap, n_pc), tiers = PLANS[case]
    plan = vm.vm_launch_plan(n_regs, mem_cap, n_pc, batch)
    assert (plan.table_on_chip, plan.regs_on_chip, plan.mem_on_chip) == tiers
    row = 8 * 4 * plan.threads
    assert plan.shared_bytes == (n_pc * 64 * plan.table_on_chip + 32 * 4 * plan.threads
                                 + row * (n_regs * plan.regs_on_chip + mem_cap * plan.mem_on_chip))
    assert plan.shared_bytes <= 232_448 and plan.threads == 32
    assert plan.blocks * plan.threads >= batch > (plan.blocks - 1) * plan.threads
    if case in PLAN_BLOCKS:
        zeros = lambda w: np.zeros(1, dtype=object)  # noqa: E731
        program, regs, mem = vm.initial_state(PLAN_BLOCKS[case](), zeros, 1, P, "cpu")
        assert (regs.shape[0], mem.shape[0], program.n_pc) == (n_regs, mem_cap, n_pc)
        assert vm.vm_plan_for(program, regs, mem) == vm.vm_launch_plan(n_regs, mem_cap, n_pc, 1)


def jax_solve(solver, inputs):
    """The JAX BatchSolver's levels one at a time, then their host stages."""
    import jax

    W, ok, fail, mem = solver.initial_state(inputs)
    for segment in solver.segments:
        for packed in segment.levels:
            W, ok, fail, mem = solver._run_level(W, ok, fail, mem, packed)
        if segment.host_stages:
            W, ok, fail = solver._run_host_stages(W, ok, fail, segment.host_stages)
    return jax.device_get((W, ok, fail))


def test_slice_matches_the_jax_batch_solver_and_the_sequential_engine(slice_circuits):
    """The whole program through BatchSolver on the CPU: panel, ok and fail
    equal the JAX BatchSolver's; three blocks, no per-instance stage; three
    witness maps equal pwg.ACVM's (the worst-case sort, a trap, a failing
    Range); host_batch=False gives the same panel."""
    circuit, jcircuit, cols, _, fails = slice_circuits
    stats = SolveStats()
    plan = plan_circuit(circuit)
    res = BatchSolver(plan, device="cpu").solve(cols, stats=stats)
    assert stats.host_per_instance_stages == 0
    want = [fails.get(b, int(FAIL_NONE)) for b in range(BATCH)]
    assert res.fail.tolist() == want and res.ok.tolist() == [b not in fails for b in range(BATCH)]
    W, ok, fail = jax_solve(JBatchSolver(jplan_circuit(jcircuit)), cols)
    np.testing.assert_array_equal(res.panel.numpy(), convert.panel_from_jax(W, res.panel.shape[0]))
    assert res.ok.tolist() == np.asarray(ok).tolist() and res.fail.tolist() == np.asarray(fail).tolist()
    for b in (0, 2, 3):
        wm = jacir.WitnessMap({jacir.Witness(w): JFieldElement(int(v[b])) for w, v in cols.items()})
        acvm = ACVM(JGrumpkinSolver(), jcircuit.opcodes, wm)
        status = acvm.solve()
        if b in fails:
            assert status == ACVMStatus.FAILURE and acvm.instruction_pointer == fails[b], b
            continue
        assert status == ACVMStatus.SOLVED
        inst = res.instance_ints(b)
        assert all(inst[int(w)] == int(v) for w, v in acvm.finalize()), b
    per_stats = SolveStats()
    per = BatchSolver(plan, device="cpu", host_batch=False).solve(cols, stats=per_stats)
    assert torch.equal(per.panel, res.panel) and per_stats.host_per_instance_stages == 3


# ---------------------------------------------------------------------------
# Escapes: the block reruns instance by instance
# ---------------------------------------------------------------------------


def one_block(bytecode, n_in=1, n_out=1):
    """A circuit of one block over w1..w_n_in into the next n_out witnesses:
    a host stage on the VM where the bytecode branches, else the trace's."""
    block = ops.OpcodeBrillig(ops.Brillig(
        inputs=[ops.BrilligInputSingle(Expression.from_witness(Witness(1 + i))) for i in range(n_in)],
        outputs=[ops.BrilligOutputSimple(Witness(1 + n_in + i)) for i in range(n_out)],
        foreign_call_results=[], bytecode=bytecode, predicate=None))
    return Circuit(current_witness_index=n_in + n_out, opcodes=[block],
                   private_parameters={Witness(1 + i) for i in range(n_in)})


R, I, V = br.RegisterIndex, br.BinaryIntOp, br.Value.from_int

# r1 = r0 through r0 nested calls: Call(2) recurses while r0 != 0.
RECURSION = [br.OpCall(2), br.OpStop(),
             br.OpJumpIfNot(R(0), 7), br.OpConst(R(2), V(1)),
             br.OpBinaryIntOp(R(0), I.Sub, 64, R(0), R(2)),
             br.OpBinaryIntOp(R(1), I.Add, 64, R(1), R(2)), br.OpCall(2), br.OpReturn()]
# Store r0 at the pointer r0 and load it back: memory grows on write.
STORE_AT = [br.OpStore(R(0), R(0)), br.OpLoad(R(0), R(0)), br.OpJump(3), br.OpStop()]
# The sum loop of the JAX fixture: 1,000 trips run past the budget (1,536).
SUM_LOOP = build_brillig_vm_edges_circuit().opcodes[0].brillig.bytecode


@pytest.mark.parametrize("kind,bytecode,values,expected", [
    ("step_budget", SUM_LOOP, [3, 1000, 7], [6, 500500, 28]),
    ("call_depth", RECURSION, [3, 40, 31], [3, 40, 31]),
    ("pointer_past_cap", STORE_AT, [3, 100, 31], [3, 100, 31]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_escape_reruns_the_block_instance_by_instance(kind, bytecode, values, expected):
    """One instance past a capacity rule (a 1,000-trip loop, 41 open calls, a
    pointer past the 32 cells) makes the whole block raise HostBatchFallback;
    the solver reruns it on the sequential VM, one per-instance stage, and
    gets the sequential VM's values."""
    circuit = one_block(bytecode, n_in=1, n_out=2 if kind == "call_depth" else 1)
    col = np.array(values, dtype=np.uint64)
    with pytest.raises(host_batch.HostBatchFallback):
        vm.run_brillig_vm_batch(circuit.opcodes[0].brillig, lambda w: col.astype(object), 3, P,
                                device="cpu")
    # Without the escaping instance the block runs on the VM.
    fits = np.array([values[0], values[2]], dtype=np.uint64)
    out, trapped = vm.run_brillig_vm_batch(circuit.opcodes[0].brillig, lambda w: fits.astype(object),
                                           2, P, device="cpu")
    assert not trapped.any()
    stats = SolveStats()
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve({1: col}, stats=stats)
    assert res.ok.all() and stats.host_per_instance_stages == 1
    assert res.witness_ints(circuit.current_witness_index) == expected
    assert out[circuit.current_witness_index].tolist() == [expected[0], expected[2]]


def test_step_budget_keyword_and_array_output_past_the_cap():
    brillig = one_block(SUM_LOOP).opcodes[0].brillig
    col = np.array([10, 20], dtype=object)
    out, _ = vm.run_brillig_vm_batch(brillig, lambda w: col, 2, P, device="cpu", max_steps=4 * 20 + 5)
    assert out[2].tolist() == [55, 210]  # 4 n + 5 opcodes: exactly the budget
    with pytest.raises(host_batch.HostBatchFallback, match="capacity escape"):
        vm.run_brillig_vm_batch(brillig, lambda w: col, 2, P, device="cpu", max_steps=4 * 20 + 4)
    # An array output whose pointer register holds 40: 40 + 2 words > 32 cells.
    block = ops.Brillig(
        inputs=[ops.BrilligInputSingle(Expression.from_witness(Witness(1)))],
        outputs=[ops.BrilligOutputArray([Witness(2), Witness(3)])], foreign_call_results=[],
        bytecode=[br.OpJump(1), br.OpStop()], predicate=None)
    with pytest.raises(host_batch.HostBatchFallback, match="beyond the memory cap"):
        vm.run_brillig_vm_batch(block, lambda w: np.array([40, 0], dtype=object), 2, P, device="cpu")
    out, _ = vm.run_brillig_vm_batch(block, lambda w: np.array([30, 0], dtype=object), 2, P,
                                     device="cpu")
    assert out[2].tolist() == [0, 0] and out[3].tolist() == [0, 0]


def test_predicate_zero_everywhere_runs_nothing(edge_circuits, monkeypatch):
    circuit, _, cols, _, _ = edge_circuits
    monkeypatch.setattr(vm, "run_vm", lambda *a, **k: pytest.fail("the VM ran"))
    zero = object_cols(cols)
    zero[15] = np.zeros(BATCH, dtype=object)
    values, trapped = vm.run_brillig_vm_batch(circuit.opcodes[3].brillig, lambda w: zero[int(w)],
                                              BATCH, P, device="cpu")
    assert values[17].tolist() == [0] * BATCH and not trapped.any()


def test_signed_input_columns_do_not_wrap():
    """The uint64 fast path of the column bridge takes only unsigned or
    object columns of values in [0, 2^64); -3 in an int64 column is p - 3
    (the JAX bridge's col.astype(np.uint64) makes it 2^64 - 3), and a
    negative value in an object column is reduced mod p whatever numpy's
    object-to-uint64 cast does with it."""
    limbs = host_batch.cols_to_limbs(
        [np.array([-3, 5], np.int64), np.array([-1, 1 << 70], dtype=object),
         np.array([-1, 5], dtype=object), np.array([7, (1 << 64) - 1], np.uint64)], P)
    want = [[P - 3, 5], [P - 1, 1 << 70], [P - 1, 5], [7, (1 << 64) - 1]]
    assert limbs.shape == (4, 2, 8)
    for c in range(4):
        for b in range(2):
            assert limbs[c, b].tolist() == int_to_limbs32(want[c][b]).tolist()


def test_device_vm_eligible_has_one_home(slice_circuits, edge_circuits):
    assert vm.device_vm_eligible is host_batch.device_vm_eligible
    assert vm.MAX_REGISTERS == jvm.MAX_REGISTERS and vm.CALL_STACK_DEPTH == jvm.CALL_STACK_DEPTH
    for port, jax_ in ((slice_circuits[0], slice_circuits[1]), (edge_circuits[0], edge_circuits[1])):
        for op, jop in zip(port.opcodes, jax_.opcodes):
            if isinstance(op, ops.OpcodeBrillig):
                assert vm.device_vm_eligible(op.brillig) == jvm.device_vm_eligible(jop.brillig) is True
                assert not host_batch.brillig_batchable(op.brillig)
                assert not jhost_batch.brillig_batchable(jop.brillig)


# ---------------------------------------------------------------------------
# Where the references disagree (ROADMAP queue 3)
# ---------------------------------------------------------------------------


def two_input_block(lib, bytecode):
    """One branchy block r0 = f(r0, r1) over w1, w2 into w3."""
    o, E = lib.opcodes, lib.Expression.from_witness
    return o.Brillig(inputs=[o.BrilligInputSingle(E(lib.Witness(1))),
                             o.BrilligInputSingle(E(lib.Witness(2)))],
                     outputs=[o.BrilligOutputSimple(lib.Witness(3))], foreign_call_results=[],
                     bytecode=bytecode, predicate=None)


def disagreement(lib, case):
    b = lib.brillig
    R, I, V = b.RegisterIndex, b.BinaryIntOp, b.Value.from_int
    op = {
        "udiv_by_zero": b.OpBinaryIntOp(R(0), I.UnsignedDiv, 32, R(0), R(1)),
        "load_unwritten": b.OpLoad(R(0), R(1)),
        "wide_add": b.OpBinaryIntOp(R(0), I.Add, 256, R(0), R(1)),
        "signed_div_wide_operand": b.OpBinaryIntOp(R(0), I.SignedDiv, 8, R(0), R(1)),
        "shl_254": b.OpBinaryIntOp(R(0), I.Shl, 254, R(0), R(1)),
    }[case]
    return two_input_block(lib, [op, b.OpJump(2), b.OpStop()])


# case, (w1, w2) a row, the port's outputs (None: trapped), the JAX device VM's,
# and what the sequential VM does.
DISAGREEMENTS = [
    ("udiv_by_zero", [(7, 2), (7, 0)], [3, None], [3, None], ZeroDivisionError),
    ("load_unwritten", [(0, 3), (0, 31)], [0, 0], [0, 0], IndexError),
    ("wide_add", [(P - 1, 5), (2, 3)], [4, 5], [P + 4, 5], [4, 5]),
    ("signed_div_wide_operand", [(456, 7), (200, 7)], [28, 248], [248, 248], [28, 248]),
    ("shl_254", [(7, 251), (5, 1)], [(7 << 251) % P, 10], [7 << 251, 10], AssertionError),
]


@pytest.mark.parametrize("case,rows,port,jax_vm,sequential", DISAGREEMENTS,
                         ids=[d[0] for d in DISAGREEMENTS])
def test_where_the_references_disagree(case, rows, port, jax_vm, sequential):
    """UnsignedDiv by zero traps and unwritten memory reads 0, as in the JAX
    device VM (the sequential VM raises); a 256-bit result is reduced mod p
    and SignedDiv reads an operand past 2^bit_size as it is, as in the
    sequential VM (the JAX device VM keeps p + 4, and masks 456 to 200 =
    -56); a Shl above 128 bits is computed and reduced (the sequential VM
    asserts; the JAX device VM does not reduce)."""
    cols = {1: np.array([r[0] for r in rows], dtype=object), 2: np.array([r[1] for r in rows], dtype=object)}
    get = lambda w: cols[int(w)]  # noqa: E731
    values, trapped = vm.run_brillig_vm_batch(disagreement(PORT_CLASSES, case), get, 2, P, device="cpu")
    assert [None if t else int(v) for v, t in zip(values[3], trapped)] == port
    jvalues, jtrapped = jvm.run_brillig_vm_batch(disagreement(JAX_LIB, case), get, 2, P)
    assert [None if t else int(v) for v, t in zip(jvalues[3], jtrapped)] == jax_vm
    jbrillig = disagreement(JAX_LIB, case)
    for b in range(2):
        wm = jacir.WitnessMap({jacir.Witness(w): JFieldElement(int(v[b])) for w, v in cols.items()})
        if isinstance(sequential, list):
            JBrilligSolver.solve(wm, jbrillig, JGrumpkinSolver(), 0)
            assert int(wm.get(jacir.Witness(3))) == sequential[b]
        elif port[b] is None or case != "udiv_by_zero":
            with pytest.raises(sequential):
                JBrilligSolver.solve(wm, jbrillig, JGrumpkinSolver(), 0)


def test_trace_and_vm_reduce_a_wide_shl_alike():
    """A straight-line Shl at 254 bits by the constant 251 runs on the trace;
    the same block through the VM gives the same bits: 7 * 2^251 mod p (the
    JAX trace and device VM both keep 7 * 2^251, which is above p)."""
    block = [br.OpConst(R(1), V(251)), br.OpBinaryIntOp(R(0), I.Shl, 254, R(0), R(1)), br.OpStop()]
    circuit = one_block(block)
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve({1: np.array([7, 5], np.uint64)})
    assert res.witness_ints(2) == [(7 << 251) % P, (5 << 251) % (1 << 254) % P]
    values, _ = vm.run_brillig_vm_batch(circuit.opcodes[0].brillig,
                                        lambda w: np.array([7, 5], dtype=object), 2, P, device="cpu")
    assert values[2].tolist() == res.witness_ints(2)


def test_int_ops_wider_than_256_bits_run_instance_by_instance():
    """A Sub at 300 bits: the sequential VM gives (2^300 - 1) mod p for 2 - 3;
    the JAX device VM computes at 256 bits and keeps 2^256 - 1.  The port's
    VM does not take such a block: it raises HostBatchFallback and the solver
    runs it instance by instance (ROADMAP queue 3)."""
    def block(lib):
        b = lib.brillig
        R = b.RegisterIndex
        return two_input_block(lib, [b.OpBinaryIntOp(R(0), b.BinaryIntOp.Sub, 300, R(0), R(1)),
                                     b.OpJump(2), b.OpStop()])

    cols = {1: np.array([2, 9], dtype=object), 2: np.array([3, 4], dtype=object)}
    get = lambda w: cols[int(w)]  # noqa: E731
    with pytest.raises(host_batch.HostBatchFallback, match="wider than 256"):
        vm.run_brillig_vm_batch(block(PORT_CLASSES), get, 2, P, device="cpu")
    jvalues, _ = jvm.run_brillig_vm_batch(block(JAX_LIB), get, 2, P)
    assert jvalues[3].tolist() == [(1 << 256) - 1, 5]
    circuit = Circuit(current_witness_index=3, opcodes=[ops.OpcodeBrillig(block(PORT_CLASSES))],
                      private_parameters={Witness(1), Witness(2)})
    stats = SolveStats()
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve(cols, stats=stats)
    assert res.witness_ints(3) == [((1 << 300) - 1) % P, 5] and stats.host_per_instance_stages == 1


def test_straight_line_array_block_runs_on_the_vm_as_a_host_stage():
    """A straight-line block with array inputs and outputs (its output array
    is its input array, at the pointer in r0 moved through an Add of 0): the
    trace refuses it; planned with device_brillig_trace=False it is a host
    stage that the VM runs."""
    block = ops.OpcodeBrillig(ops.Brillig(
        inputs=[ops.BrilligInputArray([Expression.from_witness(Witness(1)),
                                       Expression.from_witness(Witness(2))])],
        outputs=[ops.BrilligOutputArray([Witness(3), Witness(4)])], foreign_call_results=[],
        bytecode=[br.OpConst(R(1), V(0)), br.OpBinaryIntOp(R(0), I.Add, 32, R(0), R(1)),
                  br.OpStop()],
        predicate=None))
    circuit = Circuit(current_witness_index=4, opcodes=[block],
                      private_parameters={Witness(1), Witness(2)})
    with pytest.raises(NotImplementedError, match="device_brillig_trace=False"):
        BatchSolver(plan_circuit(circuit), device="cpu")
    config = types.SimpleNamespace(field_params=lambda: BN254_FR, device_hash_kernels=True,
                                   device_brillig_trace=False)
    stats = SolveStats()
    res = BatchSolver(plan_circuit(circuit, config=config), device="cpu").solve(
        {1: np.array([3, P - 1], dtype=object), 2: np.array([4, 5], dtype=object)}, stats=stats)
    assert res.witness_ints(3) == [3, P - 1] and res.witness_ints(4) == [4, 5]
    assert stats.host_per_instance_stages == 0
