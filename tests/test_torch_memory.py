"""The port's memory blocks (``MemoryInit`` / ``MemoryOp``) on the CPU.

`build_array_circuit` at a small size (2 blocks x 16 entries x 4 rounds) is
solved by `acvm_tpu_torch` and held, at tolerance 0, to (1) Python ints (the
memory rules written out below, with the batched solvers' convention that a
failing instance goes on: an out-of-bounds read gives 0, an out-of-bounds
write is skipped), (2) the sequential engine `acvm_tpu.pwg.ACVM` and (3) the
JAX `BatchSolver` on the CPU: witness values, `ok` flags, first-failure
opcode indices and the memory blocks' final state (through
`convert.memory_from_jax`).  The JAX solver's levels run one by one (its
`_run_level`, as its jitted segments run them), which returns the memory
state and compiles in about 20 s on a CPU, against about a minute for its
jitted segment.

The batch holds one instance for each way a memory opcode fails, and one
where the JAX package differs from `pwg.ACVM` (ROADMAP queue 3): an index
of 2^32 or more under a zero predicate fails there and not in `pwg.ACVM`,
which the port follows.
"""

import types

import jax
import numpy as np
import pytest

from acvm_tpu import acir as jacir
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.blackbox import StubBlackBoxSolver
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.pwg import ACVM, ACVMStatus
from acvm_tpu.tpu import BatchSolver as JBatchSolver, plan_circuit as jplan_circuit

from acvm_tpu_torch import convert
from acvm_tpu_torch.acir import Expression
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, plan_circuit
from acvm_tpu_torch.fields.kernels import limbs32_to_ints
from acvm_tpu_torch.utils import PORT_CLASSES, array_inputs, build_array_circuit, columnar_instance

P = BN254_FR.modulus
BATCH = 8
SMALL = dict(num_blocks=3, block_size=16, rounds=4, final_reads=2, num_seeds=4)
JAX_LIB = types.SimpleNamespace(Circuit=jacir.Circuit, Expression=jacir.Expression,
                                Witness=jacir.Witness, FieldElement=JFieldElement, opcodes=jops)


def evaluate(circuit, inputs):
    """Python ints, opcode by opcode: arithmetic gates and memory blocks.
    Returns (witnesses, blocks, first failing opcode or None)."""
    w, mem, failed = dict(inputs), {}, None

    def value(e):
        v = e.q_c.value + sum(c.value * w[int(x)] for c, x in e.linear_combinations)
        return (v + sum(c.value * w[int(x)] * w[int(y)] for c, x, y in e.mul_terms)) % P

    for index, op in enumerate(circuit.opcodes):
        bad = False
        if isinstance(op, ops.OpcodeArithmetic):
            e = op.expr
            unknown = [int(x) for _, x in e.linear_combinations if int(x) not in w]
            if unknown:  # c x + rest = 0, one unknown of coefficient c
                (c, x), = [(c, x) for c, x in e.linear_combinations if int(x) not in w]
                rest = Expression(e.mul_terms, [t for t in e.linear_combinations if t[1] != x], e.q_c)
                w[int(x)] = -value(rest) * pow(c.value, -1, P) % P
            else:
                bad = value(e) != 0
        elif isinstance(op, ops.OpcodeMemoryInit):
            mem[op.block_id.id] = [w[int(x)] for x in op.init]
        else:
            block, m = mem[op.block_id.id], op.op
            idx = value(m.index)
            active = op.predicate is None or value(op.predicate) != 0
            in_bounds = idx < len(block)
            bad = idx >= 1 << 64 or (active and not in_bounds)
            target = m.value.linear_combinations[0][1] if (
                not m.value.mul_terms and len(m.value.linear_combinations) == 1
                and m.value.q_c.value == 0 and m.value.linear_combinations[0][0].value == 1) else None
            if value(m.operation) == 0:
                if target is None or int(target) in w:
                    bad = True  # "must read into a specified witness"
                else:
                    w[int(target)] = block[idx] if active and in_bounds else 0
            elif active:
                if target is not None and int(target) not in w:
                    bad, v = True, 0  # the value to write is not known
                else:
                    v = value(m.value)
                if in_bounds:
                    block[idx] = v
        if bad and failed is None:
            failed = index
    return w, mem, failed


def sequential(jcircuit, assignment):
    """pwg.ACVM on one instance: (status, acvm).  Where the reference panics
    (a read into a known witness, an index of 2^64 or more) pwg.ACVM raises,
    and the status is "panic"; either way a failure stops at
    ``acvm.instruction_pointer``."""
    wm = jacir.WitnessMap()
    for k, v in assignment.items():
        wm.insert(jacir.Witness(k), JFieldElement(v))
    acvm = ACVM(StubBlackBoxSolver(), jcircuit.opcodes, wm)
    try:
        return acvm.solve(), acvm
    except (AssertionError, ValueError):
        return "panic", acvm


def mem_ops(circuit):
    return [(i, op) for i, op in enumerate(circuit.opcodes) if isinstance(op, ops.OpcodeMemoryOp)]


def col(e):
    return int(e.linear_combinations[0][1])


# instance -> what it exercises
EDGES = {2: "index one past the block", 3: "index 2^32 + 1 under an active predicate",
         4: "the writing selector is 0: a read into a known witness",
         5: "the reading selector is 7: a write of the unknown value",
         6: "index 2^40 under a zero predicate (no failure)", 7: "index 2^64"}


@pytest.fixture(scope="module")
def arrays():
    circuit = build_array_circuit(**SMALL)
    cols, fail_op = array_inputs(circuit, BATCH, fail_instance=2)
    cols = {k: v.astype(object) for k, v in cols.items()}
    mops = mem_ops(circuit)
    (i_pred, pred_op), (i_read, read_op), (i_write, write_op) = mops[-3:]
    cols[col(pred_op.op.index)][3] = (1 << 32) + 1
    cols[col(pred_op.predicate)][3] = 1
    cols[col(write_op.op.operation)][4] = 0
    cols[col(read_op.op.operation)][5] = 7
    cols[col(pred_op.op.index)][6] = 1 << 40
    cols[col(pred_op.predicate)][6] = 0
    i_last, last = mops[-4]
    cols[col(last.op.index)][7] = 1 << 64
    fails = {2: fail_op, 3: i_pred, 4: i_write, 5: i_read, 6: None, 7: i_last}
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve(cols)
    return dict(circuit=circuit, jcircuit=build_array_circuit(**SMALL, lib=JAX_LIB), cols=cols,
                fails=fails, res=res)


@pytest.fixture(scope="module")
def jax_arrays(arrays):
    solver = JBatchSolver(jplan_circuit(arrays["jcircuit"]))
    W, ok, fail, mem = solver.initial_state(arrays["cols"])
    for segment in solver.segments:
        for packed in segment.levels:
            W, ok, fail, mem = solver._run_level(W, ok, fail, mem, packed)
    return jax.device_get((W, ok, fail, mem))


def test_array_circuit_shape():
    c = build_array_circuit()
    assert len(c.opcodes) == 8 * 1024 + 8 + 32 * 8 * 3 + 8 * 4 + 3 == 9003
    assert c.current_witness_index == 9320
    small = build_array_circuit(**SMALL)
    solver = BatchSolver(plan_circuit(small), device="cpu")
    assert solver.plan.memory_block_sizes == {0: 16, 1: 16, 2: 16}
    assert solver.memory_slots == {0: (16, 0), 1: (16, 1), 2: (16, 2)}
    # a round's read, product and write over the three blocks: the reads of
    # one level gather together, as do the writes
    groups = [[(buf["kind"], buf["k"].tolist() if buf["kind"] == "op" else buf["k"])
               for buf in lv.get("memory", [])] for seg in solver.segments for lv in seg.levels]
    assert [("op", [0, 1, 2])] in groups
    assert solver.panel_bytes(10) == (small.num_vars() + 3 * 16) * 10 * 32


@pytest.mark.parametrize("instance", range(BATCH))
def test_array_matches_sequential_engine(arrays, instance):
    res, want_fail = arrays["res"], arrays["fails"].get(instance)
    status, acvm = sequential(arrays["jcircuit"], columnar_instance(arrays["cols"], instance))
    got = res.instance_ints(instance)
    if want_fail is None:
        assert status == ACVMStatus.SOLVED, EDGES.get(instance)
        assert res.ok[instance] and res.fail[instance] == FAIL_NONE
        expected = list(acvm.finalize())
        assert len(expected) == arrays["circuit"].current_witness_index
    else:
        assert status in (ACVMStatus.FAILURE, "panic"), EDGES[instance]
        assert acvm.instruction_pointer == want_fail == res.fail[instance]
        assert not res.ok[instance]
        expected = list(acvm.witness_map)  # what it solved before it failed
    assert all(got[int(w)] == int(v) for w, v in expected)


def test_array_matches_ints(arrays):
    res, blocks = arrays["res"], arrays["res"].memory_blocks()
    for b in range(BATCH):
        w, mem, failed = evaluate(arrays["circuit"], columnar_instance(arrays["cols"], b))
        assert failed == arrays["fails"].get(b), b
        got = res.instance_ints(b)
        if failed is None:
            assert len(w) == arrays["circuit"].current_witness_index
        assert all(got[k] == v for k, v in w.items()), b
        for block_id, values in mem.items():
            assert limbs32_to_ints(blocks[block_id][:, b].numpy()) == values


def test_array_matches_jax_batch_solver(arrays, jax_arrays):
    res = arrays["res"]
    W, ok, fail, mem = jax_arrays
    nw = arrays["circuit"].current_witness_index + 1
    # Where an instance fails at an index of 2^32 or more (instances 3 and 7)
    # the JAX package reads the entry at the index's low 32 bits; the port
    # reads 0, as it does at any index out of bounds.  Nothing else differs.
    differ = np.argwhere((res.W != np.asarray(W)[:, :nw]).any(-1)).tolist()
    mops = mem_ops(arrays["circuit"])
    assert differ == [[3, col(mops[-3][1].op.value)], [7, col(mops[-4][1].op.value)]]
    assert res.instance_ints(3)[differ[0][1]] == res.instance_ints(7)[differ[1][1]] == 0
    memory = convert.memory_from_jax(mem)
    assert memory.keys() == res.memory_blocks().keys()
    for block_id, slab in res.memory_blocks().items():
        assert np.array_equal(slab.numpy(), memory[block_id])
    # The JAX package fails instance 6 (index 2^40, predicate 0); pwg.ACVM and
    # the port do not.  Every other flag and index is equal.
    same = [b for b in range(BATCH) if b != 6]
    assert np.array_equal(res.ok[same], np.asarray(ok)[same])
    assert np.array_equal(res.fail[same], np.asarray(fail)[same])
    assert res.ok[6] and not ok[6]


def test_memory_opcodes_of_a_level_together_equal_one_at_a_time(arrays):
    """The memory opcodes of a level on blocks of one size gather and scatter
    together; one opcode at a time gives the same bits."""
    solver = BatchSolver(plan_circuit(arrays["circuit"]), device="cpu", group_stages=False)
    assert all(buf["kind"] == "init" or buf["k"].numel() == 1
               for seg in solver.segments for lv in seg.levels for buf in lv.get("memory", []))
    res = solver.solve(arrays["cols"])
    assert np.array_equal(res.W, arrays["res"].W) and np.array_equal(res.fail, arrays["res"].fail)
    for block_id, slab in res.memory_blocks().items():
        assert np.array_equal(slab.numpy(), arrays["res"].memory_blocks()[block_id].numpy())


def test_memory_state_round_trips_through_jax_layout(arrays):
    blocks = {k: v.numpy() for k, v in arrays["res"].memory_blocks().items()}
    jax_form = convert.memory_to_jax(blocks)
    assert jax_form["1"].shape == (BATCH, 16, 16)
    back = convert.memory_from_jax(jax_form)
    assert all(np.array_equal(back[k], v) for k, v in blocks.items())


def one_block_circuit(lib, is_write):
    """Block 0 of 4 entries (w1..w4); one opcode on it at index w5 under the
    predicate w6 (a read into w7, or a write of w1), then reads of entries 0-3
    into w8..w11.  ``lib`` as in ``build_array_circuit``."""
    o, W = lib.opcodes, lib.Witness
    lin = lib.Expression.from_witness
    index, pred = lin(W(5)), lin(W(6))
    op = (o.MemOp.write_to_mem_index(index, lin(W(1))) if is_write
          else o.MemOp.read_at_mem_index(index, W(7)))
    reads = [o.OpcodeMemoryOp(o.BlockId(0), o.MemOp.read_at_mem_index(
        lib.Expression.from_field(lib.FieldElement(j)), W(8 + j)), None) for j in range(4)]
    return lib.Circuit(
        current_witness_index=11,
        opcodes=[o.OpcodeMemoryInit(o.BlockId(0), [W(i) for i in range(1, 5)]),
                 o.OpcodeMemoryOp(o.BlockId(0), op, pred), *reads],
        private_parameters={W(i) for i in range(1, 7)},
    )


INDICES = [0, 3, 4, (1 << 32) - 1, 1 << 32, (1 << 32) + 2, (1 << 64) - 1, 1 << 64, P - 1]


@pytest.mark.parametrize("is_write", [False, True], ids=["read", "write"])
def test_memory_index_at_limb_edges(is_write):
    """The index is limb 0; an index of 2^32 or more is out of bounds where
    the predicate holds, and one of 2^64 or more fails whatever the predicate
    (pwg.ACVM's try_to_u64)."""
    circuit, jcircuit = one_block_circuit(PORT_CLASSES, is_write), one_block_circuit(JAX_LIB, is_write)
    inputs = [{1: 11, 2: 22, 3: 33, 4: 44, 5: idx, 6: pred} for idx in INDICES for pred in (0, 5)]
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve(inputs)
    for b, inp in enumerate(inputs):
        w, _, failed = evaluate(circuit, inp)
        fails = inp[5] >= 1 << 64 or (inp[6] != 0 and inp[5] >= 4)
        assert failed == (1 if fails else None), inp
        assert res.fail[b] == (1 if fails else FAIL_NONE) and res.ok[b] == (not fails)
        got = res.instance_ints(b)
        assert all(got[k] == v for k, v in w.items()), inp
        status, acvm = sequential(jcircuit, inp)
        if fails:
            assert status in (ACVMStatus.FAILURE, "panic") and acvm.instruction_pointer == 1, inp
        else:
            assert status == ACVMStatus.SOLVED, inp
            assert all(got[int(k)] == int(v) for k, v in acvm.finalize())
