"""Batches streamed past one pass, the command line, and the port's imports.

Streaming (``BatchSolver(max_batch_per_pass=...)``): a small circuit with a
memory block, a host stage between two device segments and two failing
instances, at B = 10 in passes of 3, must give the ok / fail of one pass, and
``solve_chunks`` each pass's panel and memory as one pass's columns, tolerance
0.  A small arithmetic circuit streamed so must give the flags of the JAX
``BatchSolver`` streamed through passes of 3 (its
``ACVM_TPU_MAX_BATCH_PER_PASS``).

The CLI (``acvm_tpu_torch.cli.main``, in process): ``info``, ``compile`` and
``execute`` write what the JAX package's CLI writes on the same input,
``solve --device cpu`` solves, and ``--mesh`` and ``bench`` raise.

Imports: every module of the port loads with JAX made unimportable, and
loads nothing of ``acvm_tpu``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from acvm_tpu import cli as jcli
from acvm_tpu.acir import Circuit as JCircuit, Expression as JExpression, Witness as JWitness
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.tpu import BatchSolver as JBatchSolver, plan_circuit as jplan_circuit

from acvm_tpu_torch import cli
from acvm_tpu_torch.acir import Circuit, Expression, Witness
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.acir.serialization import decompress_witness, serialize_circuit
from acvm_tpu_torch.fields import FieldElement
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, plan_circuit
from acvm_tpu_torch.utils.profiling import SolveStats

import golden_vectors as gv

REPO = Path(__file__).resolve().parents[1]
B, PASS = 10, 3
INDEX_FAIL, RADIX_FAIL = 4, 7


def memory_radix_circuit():
    """w3 = w1 * w1; block 0 = [w1, w3, w1]; w4 = block[w2] (instance
    INDEX_FAIL reads one past the block, opcode 2); ToLeRadix(w1, 10) into
    three digits w5-w7, a host stage (instance RADIX_FAIL's w1 has four
    digits, opcode 3); w8 = w4 + w5, on the device after it."""
    one = FieldElement(1)
    x = lambda i: Expression.from_witness(Witness(i))  # noqa: E731
    opcodes = [
        ops.OpcodeArithmetic(Expression(mul_terms=[(one, Witness(1), Witness(1))])
                             - x(3)),
        ops.OpcodeMemoryInit(ops.BlockId(0), [Witness(1), Witness(3), Witness(1)]),
        ops.OpcodeMemoryOp(ops.BlockId(0), ops.MemOp.read_at_mem_index(x(2), Witness(4)), None),
        ops.OpcodeDirective(ops.DirToLeRadix(x(1), [Witness(5), Witness(6), Witness(7)], 10)),
        ops.OpcodeArithmetic(x(4) + x(5) - x(8)),
    ]
    return Circuit(current_witness_index=8, opcodes=opcodes,
                   private_parameters={Witness(1), Witness(2)})


def memory_radix_inputs():
    rng = np.random.default_rng(11)
    inputs = [{1: int(rng.integers(0, 1000)), 2: int(rng.integers(0, 3))} for _ in range(B)]
    inputs[INDEX_FAIL][2] = 3
    inputs[RADIX_FAIL][1] = 5000
    return inputs


def test_streamed_solve_equals_one_pass():
    plan = plan_circuit(memory_radix_circuit())
    inputs = memory_radix_inputs()
    one = BatchSolver(plan, device="cpu").solve(inputs)
    assert one.fail.tolist() == [FAIL_NONE] * INDEX_FAIL + [2] + [FAIL_NONE] * 2 + [3] + \
        [FAIL_NONE] * 2
    solver = BatchSolver(plan, device="cpu", max_batch_per_pass=PASS)
    assert len(solver.segments) == 2 and solver.max_batch_per_pass() == PASS
    stats = SolveStats()
    streamed = solver.solve(inputs, stats=stats)
    assert np.array_equal(streamed.ok, one.ok) and np.array_equal(streamed.fail, one.fail)
    assert stats.passes == 4 and stats.batch == B and len(stats.host_stage_seconds) == 4
    with pytest.raises(RuntimeError, match="streamed solve"):
        streamed.panel
    # solve_chunks: each pass's panel and memory block are one pass's columns.
    chunks = list(solver.solve_chunks(inputs))
    assert [c.panel.shape[1] for c in chunks] == [3, 3, 3, 1]
    for k, chunk in enumerate(chunks):
        lo, hi = k * PASS, min(k * PASS + PASS, B)
        assert torch.equal(chunk.panel, one.panel[:, lo:hi])
        assert torch.equal(chunk.memory_blocks()[0], one.memory_blocks()[0][:, lo:hi])
        assert np.array_equal(chunk.fail, one.fail[lo:hi])
    # The columnar and packed-matrix forms slice alike.
    cols = {w: np.array([d[w] for d in inputs], dtype=np.int64) for w in (1, 2)}
    assert np.array_equal(solver.solve(cols).fail, one.fail)
    matrix = np.array([[d[1] % 256, d[2]] for d in inputs], dtype=np.uint8)
    want = BatchSolver(plan, device="cpu").solve(([1, 2], matrix))
    assert np.array_equal(solver.solve(([1, 2], matrix)).fail, want.fail)
    # Non-uniform dicts (instance 1 gives no w2, so it is 0) are packed as
    # (witness, instance) pairs and scattered: one pass's panel, pass by pass.
    ragged = [dict(d) for d in inputs]
    del ragged[1][2]
    filled = [dict(d) for d in ragged]
    filled[1][2] = 0
    whole = BatchSolver(plan, device="cpu").solve(ragged)
    assert torch.equal(whole.panel, BatchSolver(plan, device="cpu").solve(filled).panel)
    assert np.array_equal(solver.solve(ragged).fail, whole.fail)
    for k, chunk in enumerate(solver.solve_chunks(ragged)):
        assert torch.equal(chunk.panel, whole.panel[:, k * PASS : k * PASS + PASS])
    with pytest.raises(IndexError, match="out of range"):
        solver.solve([{1: 1}, {plan.num_witnesses: 2}])


def test_pass_size_follows_its_arguments():
    plan = plan_circuit(memory_radix_circuit())
    solver = BatchSolver(plan, device="cpu")
    assert solver.max_batch_per_pass() is None  # a CPU solver: one pass
    assert solver.panel_bytes(1) == (plan.num_witnesses + 3) * 32
    from acvm_tpu_torch.gpu.batch_solver import (
        PASS_PEAK_OVER_ESTIMATE, STEP_BASE_ROWS, TEMP_ROWS_PER_UNIT)

    # The upload of w1 and w2; level 0 (w3 = w1 * w1), then its segment's host
    # stage (the radix: reads w1, writes w5-w7); the block's init (3
    # entries), its read, and w8.
    units = solver.step_units()
    assert units == [{"inputs": 2}, {"arith_static": 1}, {"host": 4}, {"memory_init": 3},
                     {"memory": 1}, {"arith_static": 1}]
    assert solver.temp_rows() == STEP_BASE_ROWS + max(
        sum(TEMP_ROWS_PER_UNIT[k] * n for k, n in u.items()) for u in units)
    per_instance = solver.pass_bytes(1)
    assert per_instance == solver.panel_bytes(1) + int(solver.temp_rows() * 32)
    assert solver.pass_bytes(1000) == solver.panel_bytes(1000) + int(solver.temp_rows() * 32000)
    budget = BatchSolver(plan, device="cpu", pass_budget_bytes=per_instance * 5000)
    assert budget.max_batch_per_pass() == int(5000 / PASS_PEAK_OVER_ESTIMATE) // 1024 * 1024
    small = BatchSolver(plan, device="cpu", pass_budget_bytes=per_instance * 7)
    assert small.max_batch_per_pass() == int(7 / PASS_PEAK_OVER_ESTIMATE)
    assert BatchSolver(plan, device="cpu", pass_budget_bytes=1).max_batch_per_pass() == 1
    with pytest.raises(ValueError, match="max_batch_per_pass"):
        BatchSolver(plan, device="cpu", max_batch_per_pass=0)


def test_step_units_count_each_kind():
    """What a pass's estimate counts: every traced Brillig block and the
    binary ops of its bytecode, and a host stage's columns beside its device
    VM block's registers and memory."""
    from acvm_tpu_torch import brillig as br
    from acvm_tpu_torch.utils import build_brillig_vm_circuit, build_uint_ops_circuit

    circuit = build_uint_ops_circuit()[0]
    units = BatchSolver(plan_circuit(circuit), device="cpu").step_units()
    blocks = [op.brillig for op in circuit.opcodes if isinstance(op, ops.OpcodeBrillig)]
    assert sum(u["brillig"] for u in units) == len(blocks) > 0
    assert sum(u["brillig_ops"] for u in units) == sum(
        isinstance(op, (br.OpBinaryIntOp, br.OpBinaryFieldOp)) for b in blocks for op in b.bytecode)
    vm = BatchSolver(plan_circuit(build_brillig_vm_circuit(16)), device="cpu")
    cols = [len({w for st in seg.host_stages for w in (st.reads or st.known_before)}
                | {w for st in seg.host_stages for w in st.writes})
            for seg in vm.segments if seg.host_stages]
    # The sort's 10 registers and 2 x 16 + 32 memory cells; then the larger
    # of the isqrt's and the inverse's blocks: 10 registers and 32 cells.
    assert [u["host"] for u in vm.step_units() if "host" in u] == [cols[0] + 74, cols[1] + 42]


def arith_circuit(Circuit, Expression, Witness, FieldElement, ops):
    """w3 = w1 * w2 + 1, then w3 == w4 checked, in one package's classes."""
    one = FieldElement(1)
    return Circuit(current_witness_index=4, opcodes=[
        ops.OpcodeArithmetic(Expression(mul_terms=[(one, Witness(1), Witness(2))], q_c=one)
                             - Expression.from_witness(Witness(3))),
        ops.OpcodeArithmetic(Expression.from_witness(Witness(3))
                             - Expression.from_witness(Witness(4))),
    ], private_parameters={Witness(1), Witness(2), Witness(4)})


def test_streamed_flags_equal_the_jax_package_s(monkeypatch):
    rng = np.random.default_rng(5)
    inputs = [{1: int(a), 2: int(b), 4: int(a) * int(b) + 1}
              for a, b in rng.integers(0, 1 << 40, (9, 2))]
    inputs[5][4] += 1
    port = BatchSolver(plan_circuit(arith_circuit(Circuit, Expression, Witness, FieldElement, ops)),
                       device="cpu", max_batch_per_pass=PASS).solve(inputs)
    monkeypatch.setenv("ACVM_TPU_MAX_BATCH_PER_PASS", str(PASS))
    jax_solver = JBatchSolver(jplan_circuit(
        arith_circuit(JCircuit, JExpression, JWitness, JFieldElement, jops)))
    assert jax_solver.max_batch_per_pass() == PASS
    want = jax_solver.solve(inputs)
    assert port.ok.tolist() == [b != 5 for b in range(9)]
    assert np.array_equal(port.ok, want.ok) and np.array_equal(port.fail, want.fail)


# -- the command line -----------------------------------------------------------


@pytest.fixture
def circuit_file(tmp_path):
    path = tmp_path / "addition.acir.gz"
    path.write_bytes(gv.ADDITION_CIRCUIT)
    return str(path)


def test_cli_info_and_compile_as_the_jax_cli(circuit_file, tmp_path, capsys):
    cli.main(["info", "--circuit", circuit_file])
    out = capsys.readouterr().out
    jcli.main(["info", "--circuit", circuit_file])
    assert out == capsys.readouterr().out
    assert json.loads(out)["kinds"] == {"arithmetic": 1}
    wide = tmp_path / "wide.acir.gz"
    from acvm_tpu_torch.utils import build_wide_arith_circuit

    wide.write_bytes(serialize_circuit(build_wide_arith_circuit(8, 2, 32, seed=2)))
    for source in (circuit_file, str(wide)):
        for width in ("3", "4"):
            ours, theirs = tmp_path / "ours.gz", tmp_path / "theirs.gz"
            cli.main(["compile", "--circuit", source, "--width", width, "--output", str(ours)])
            jcli.main(["compile", "--circuit", source, "--width", width, "--output", str(theirs)])
            capsys.readouterr()
            assert ours.read_bytes() == theirs.read_bytes()


def test_cli_execute_as_the_jax_cli(circuit_file, tmp_path, capsys):
    cli.main(["execute", "--circuit", circuit_file, "--witness-json", '{"1": 1, "2": "0x02"}'])
    out = capsys.readouterr().out
    jcli.main(["execute", "--circuit", circuit_file, "--witness-json", '{"1": 1, "2": "0x02"}'])
    assert out == capsys.readouterr().out
    assert int(json.loads(out)["3"], 16) == 3
    win = tmp_path / "in.gz"
    from acvm_tpu_torch.acir import WitnessMap
    from acvm_tpu_torch.acir.serialization import compress_witness

    win.write_bytes(compress_witness(WitnessMap({Witness(1): FieldElement(5),
                                                 Witness(2): FieldElement(7)})))
    ours, theirs = tmp_path / "ours.gz", tmp_path / "theirs.gz"
    cli.main(["execute", "--circuit", circuit_file, "--witness", str(win), "--output", str(ours)])
    jcli.main(["execute", "--circuit", circuit_file, "--witness", str(win), "--output", str(theirs)])
    assert ours.read_bytes() == theirs.read_bytes()
    assert decompress_witness(ours.read_bytes()).get(Witness(3)) == FieldElement(12)


def test_cli_solve_on_the_cpu_and_what_raises(circuit_file, capsys):
    cli.main(["solve", "--circuit", circuit_file, "--witness-json", '{"1": 1, "2": 2}',
              "--batch", "4", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["satisfied"] == 4 and out["device"] == "cpu"
    with pytest.raises(SystemExit):
        cli.main(["solve", "--circuit", circuit_file, "--witness-json", '{"1": 1, "2": 2, "3": 4}',
                  "--batch", "2", "--device", "cpu"])
    # --mesh shards over the CPU, one entry; --distributed without a job's
    # environment has no coordinator to join.
    capsys.readouterr()
    cli.main(["solve", "--circuit", circuit_file, "--witness-json", '{"1": 1, "2": 2}',
              "--batch", "3", "--device", "cpu", "--mesh"])
    out = json.loads(capsys.readouterr().out)
    assert out["satisfied"] == 3 and out["shards"] == 1
    with pytest.raises(ValueError, match="coordinator"):
        cli.main(["solve", "--circuit", circuit_file, "--device", "cpu", "--distributed"])
    with pytest.raises(NotImplementedError, match="queue 1 item 1"):
        cli.main(["bench"])
    cli.main(["--log-level", "INFO", "info", "--circuit", circuit_file])
    import logging

    assert logging.getLogger("acvm_tpu_torch").level == logging.INFO
    cli.main(["--log-level", "ERROR", "info", "--circuit", circuit_file])


def test_the_port_imports_no_jax():
    """Every module of acvm_tpu_torch, and chip_smoke.py, load with `jax`
    made unimportable, and load nothing of acvm_tpu."""
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
import acvm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(acvm_tpu_torch.__path__, "acvm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules if m == "acvm_tpu" or m.startswith("acvm_tpu."))
print(len(names), loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    count, loaded = out.stdout.split(" ", 1)
    assert int(count) >= 60 and loaded.strip() == "[]"
    for name in ("acir.serialization", "compiler", "compiler.csat", "compiler.fallback",
                 "compiler.general_opt", "compiler.range_opt", "config", "api", "cli",
                 "stdlib.blake2s", "stdlib.hash_to_field", "stdlib.keccak256",
                 "stdlib.logic_fallbacks", "utils.benchtime", "utils.logging", "native",
                 "parallel", "parallel.mesh", "parallel.distributed", "parallel.launcher",
                 "fields.mxu_ops"):
        assert (REPO / "acvm_tpu_torch" / (name.replace(".", "/") + ".py")).exists() or \
            (REPO / "acvm_tpu_torch" / name.replace(".", "/") / "__init__.py").exists(), name
