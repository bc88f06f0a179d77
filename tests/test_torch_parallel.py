"""The port's mesh and multi-process glue (acvm_tpu_torch/parallel) on the
CPU: the batch sharded over repeated CPU entries and over the ranks of a gloo
job, held to the unsharded solve and the JAX package's sequential engine;
``pedersen_msm_sharded`` to ``msm_fixed_tables`` and the host curve; the
wiring through ``EngineConfig`` and the CLI.  Tolerance 0."""

import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from acvm_tpu.acir import Witness as JWitness
from acvm_tpu.acir import WitnessMap as JWitnessMap
from acvm_tpu.acir.circuit import Circuit as JCircuit
from acvm_tpu.blackbox import StubBlackBoxSolver
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.pwg import ACVM as JACVM
from acvm_tpu.pwg import ACVMStatus
from acvm_tpu_torch import cli
from acvm_tpu_torch.acir import Circuit, Expression, Witness
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.blackbox.ec import grumpkin
from acvm_tpu_torch.blackbox.grumpkin import derive_generator
from acvm_tpu_torch.config import EngineConfig
from acvm_tpu_torch.fields import FieldElement
from acvm_tpu_torch.fields.kernels import ints_to_limbs32, limbs32_to_ints
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.fields.torch_ops import LimbContext
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, ec, plan_circuit
from acvm_tpu_torch.parallel import (
    batch_sharding, launcher, make_mesh, shard_batch, shard_bounds, shard_state)
from acvm_tpu_torch.utils import (
    array_inputs, build_array_circuit, build_wide_arith_circuit, random_inputs)

REPO = Path(__file__).resolve().parents[1]
P = BN254_FR.modulus


@pytest.fixture(scope="module")
def case():
    """The wide arithmetic circuit (static denominators: the plain inversion
    is slow on the CPU) and one gate whose runtime denominator is an input:
    instance 2 of each batch gets a zero there and fails."""
    base = build_wide_arith_circuit(num_inputs=8, num_levels=2, gates_per_level=12,
                                    dyn_fraction=0.0, seed=21)
    w = base.current_witness_index + 1
    fe = FieldElement
    gate = ops.OpcodeArithmetic(Expression(
        mul_terms=[(fe(1), Witness(1), Witness(w))], linear_combinations=[(fe(1), Witness(2))],
        q_c=fe(0)))
    circuit = Circuit(current_witness_index=w, opcodes=list(base.opcodes) + [gate],
                      private_parameters=set(base.private_parameters))
    return circuit, plan_circuit(circuit)


def inputs_for(circuit, B):
    inputs = random_inputs(circuit, B, seed=B)
    if B > 2:
        inputs[2][1] = 0
    return inputs


def sequential(circuit, assignment):
    wm = JWitnessMap()
    for w, v in assignment.items():
        wm.insert(JWitness(w), JFieldElement(v))
    acvm = JACVM(StubBlackBoxSolver(), JCircuit.read(circuit.write()).opcodes, wm)
    return acvm.solve(), acvm


_UNSHARDED = {}


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 5, 7])
def test_sharded_solve_equals_unsharded_and_the_sequential_engine(case, k, B):
    circuit, plan = case
    inputs = inputs_for(circuit, B)
    if B not in _UNSHARDED:
        _UNSHARDED[B] = BatchSolver(plan, device="cpu").solve(inputs)
    ref = _UNSHARDED[B]
    res = BatchSolver(plan, mesh=make_mesh(["cpu"] * k)).solve(inputs)
    assert len(res.parts) == sum(hi > lo for lo, hi in shard_bounds(B, k))
    assert np.array_equal(res.ok, ref.ok) and np.array_equal(res.fail, ref.fail)
    assert torch.equal(res.panel, ref.panel) and np.array_equal(res.W, ref.W)
    last = plan.num_witnesses - 1
    assert res.witness_ints(last) == ref.witness_ints(last)
    assert [res.instance_ints(b) for b in range(B)] == [ref.instance_ints(b) for b in range(B)]
    assert [wm == rm for wm, rm in zip(res.witness_maps(), ref.witness_maps())] == [True] * B
    for b in {0, B - 1, min(2, B - 1)}:
        status, acvm = sequential(circuit, inputs[b])
        if b == 2:
            assert status != ACVMStatus.SOLVED and not res.ok[b] and res.fail[b] != FAIL_NONE
            continue
        assert status == ACVMStatus.SOLVED and res.ok[b] and res.fail[b] == FAIL_NONE
        solved = acvm.finalize()
        assert res.instance_ints(b)[1:] == [int(solved.get(JWitness(w)))
                                            for w in range(1, plan.num_witnesses)]


def test_sharded_streamed_and_empty_shards(case):
    circuit, plan = case
    inputs = inputs_for(circuit, 7)
    ref = BatchSolver(plan, device="cpu").solve(inputs)
    streamed = BatchSolver(plan, mesh=make_mesh(["cpu"] * 2), max_batch_per_pass=2).solve(inputs)
    assert np.array_equal(streamed.ok, ref.ok) and np.array_equal(streamed.fail, ref.fail)
    with pytest.raises(RuntimeError, match="not retained"):
        streamed.panel
    empty = BatchSolver(plan, mesh=make_mesh(["cpu"] * 3)).solve(inputs[:0])
    assert empty.ok.shape == (0,) and empty.panel.shape == (plan.num_witnesses, 0, 8)
    with pytest.raises(ValueError, match="device"):
        BatchSolver(plan, mesh=make_mesh(["cpu"]), device="meta")


def test_sharded_memory_blocks_equal_unsharded():
    circuit = build_array_circuit(num_blocks=2, block_size=8, rounds=2, final_reads=1, num_seeds=4)
    plan = plan_circuit(circuit)
    inputs, _ = array_inputs(circuit, 5)
    ref = BatchSolver(plan, device="cpu").solve(inputs)
    res = BatchSolver(plan, mesh=make_mesh(["cpu"] * 2)).solve(inputs)
    assert np.array_equal(res.ok, ref.ok) and torch.equal(res.panel, ref.panel)
    want, got = ref.memory_blocks(), res.memory_blocks()
    assert sorted(got) == sorted(want) and want
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_mesh_helpers():
    mesh = make_mesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.axis_names == ("data",) and not mesh.distributed
    assert shard_bounds(7, 3) == [(0, 3), (3, 6), (6, 7)]
    assert shard_bounds(2, 3) == [(0, 1), (1, 2), (2, 2)]
    assert batch_sharding(mesh, 4) == [(0, 2), (2, 4), (4, 4)]
    parts = shard_batch({"a": torch.arange(5), "b": [torch.arange(10).reshape(5, 2)]}, mesh)
    assert [p["a"].tolist() for p in parts] == [[0, 1], [2, 3], [4]]
    assert parts[2]["b"][0].tolist() == [[8, 9]]
    W = torch.arange(2 * 5 * 8, dtype=torch.int32).reshape(2, 5, 8)
    mem = {4: torch.zeros((1, 4, 5, 8), dtype=torch.int32)}
    states = shard_state((W, torch.ones(5, dtype=torch.bool), torch.zeros(5), mem), mesh)
    assert [s[0].shape[1] for s in states] == [2, 2, 1] and states[1][3][4].shape == (1, 4, 2, 8)
    assert torch.equal(torch.cat([s[0] for s in states], dim=1), W)
    with pytest.raises(ValueError, match="axis"):
        batch_sharding(mesh, 4, "model")


def test_pedersen_msm_sharded_equals_msm_and_the_host_curve():
    """2 generators, batch 3, 8 windows: tests/test_multichip.py's case."""
    ctx = LimbContext(BN254_FR, "cpu")
    gens = [derive_generator(0, i) for i in range(2)]
    tables = torch.stack([ec.window_table(g, 8, device="cpu") for g in gens])
    rng = np.random.RandomState(3)
    scalars_int = [[int(rng.randint(1, 1 << 30)) for _ in range(2)] for _ in range(3)]
    scalars = torch.from_numpy(ints_to_limbs32(
        [scalars_int[b][g] for g in range(2) for b in range(3)]).reshape(2, 3, 8))
    mx, my = ec.pt_to_affine(ctx, ec.msm_fixed_tables(ctx, tables, scalars))
    for k in (1, 2, 3):
        ax, ay = ec.pedersen_msm_sharded(ctx, tables, scalars, make_mesh(["cpu"] * k))
        assert torch.equal(ax, mx) and torch.equal(ay, my)
    xs, ys = limbs32_to_ints(mx.numpy()), limbs32_to_ints(my.numpy())
    for b in range(3):
        expected = None
        for g, s in zip(gens, scalars_int[b]):
            expected = grumpkin.add(expected, grumpkin.mul(s, g))
        assert (xs[b], ys[b]) == expected


WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import numpy as np, torch
    from acvm_tpu_torch.parallel import distributed
    distributed.initialize_from_env()
    import torch.distributed as dist
    from acvm_tpu_torch.fields.kernels import ints_to_limbs32
    from acvm_tpu_torch.fields.params import BN254_FR
    from acvm_tpu_torch.fields.torch_ops import LimbContext
    from acvm_tpu_torch.gpu import BatchSolver, ec, plan_circuit
    from acvm_tpu_torch.utils import (
    array_inputs, build_array_circuit, build_wide_arith_circuit, random_inputs)
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    circuit = build_wide_arith_circuit(num_inputs=8, num_levels=2, gates_per_level=12,
                                       dyn_fraction=0.5, seed=21)
    plan = plan_circuit(circuit)
    mesh = distributed.global_mesh()
    inputs = random_inputs(circuit, 7)  # the global batch, the same on every rank
    mine = distributed.process_batch_slice(7)
    res = BatchSolver(plan, mesh=mesh).solve(inputs)
    ref = BatchSolver(plan, device="cpu").solve(inputs)
    last = plan.num_witnesses - 1
    assert np.array_equal(res.ok, ref.ok) and np.array_equal(res.fail, ref.fail)
    assert res.witness_ints(last) == ref.witness_ints(last)
    for b in (0, 6):  # one instance of each rank's shard, read by both ranks in turn
        assert res.instance_ints(b) == ref.instance_ints(b)
    assert torch.equal(res.panel, ref.panel)
    ctx = LimbContext(BN254_FR, "cpu")
    from acvm_tpu_torch.blackbox.grumpkin import derive_generator
    tables = torch.stack([ec.window_table(derive_generator(0, i), 8, device="cpu")
                          for i in range(3)])
    scalars = torch.from_numpy(ints_to_limbs32(range(1, 7)).reshape(3, 2, 8))
    want = ec.pt_to_affine(ctx, ec.msm_fixed_tables(ctx, tables, scalars))
    got = ec.pedersen_msm_sharded(ctx, tables, scalars, mesh)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    print(json.dumps({{"rank": dist.get_rank(), "slice": [mine.start, mine.stop],
                      "ok": res.ok.tolist()}}))
    dist.destroy_process_group()
""")


def test_two_rank_gloo_job_through_the_launcher():
    results = launcher.launch_local(2, ["-c", WORKER.format(repo=str(REPO))], platform="cpu",
                                    timeout=240)
    lines = [json.loads(r.stdout.strip().splitlines()[-1]) for r in results]
    assert [line["rank"] for line in lines] == [0, 1]
    assert [line["slice"] for line in lines] == [[0, 4], [4, 7]]
    assert lines[0]["ok"] == lines[1]["ok"] and len(lines[0]["ok"]) == 7


def test_launcher_raises_with_the_failing_rank_s_output():
    failing = "import os, sys; r = int(os.environ['ACVM_TPU_PROCESS_ID']); " \
              "print('rank', r); sys.exit(3 if r == 1 else 0)"
    with pytest.raises(RuntimeError, match="(?s)rank 1 \\(rc=3\\).*rank 1"):
        launcher.launch_local(2, ["-c", failing], platform="cpu", timeout=60)


def test_config_and_cli_shard_the_batch(case, tmp_path, capsys, monkeypatch):
    circuit, plan = case
    config = EngineConfig(device="cpu", mesh_shape=(1,))
    solver = config.solver(plan)
    assert solver.mesh is not None and solver.mesh.size == 1
    inputs = inputs_for(circuit, 4)
    assert np.array_equal(solver.solve(inputs).ok, BatchSolver(plan, device="cpu").solve(inputs).ok)
    with pytest.raises(ValueError, match="distinct"):
        EngineConfig(device="cpu", mesh_shape=(2,)).solver(plan)
    path = tmp_path / "c.acir.gz"
    from acvm_tpu_torch.acir.serialization import serialize_circuit

    small = Circuit(current_witness_index=3, opcodes=[ops.OpcodeArithmetic(Expression(
        linear_combinations=[(FieldElement(1), Witness(1)), (FieldElement(1), Witness(2)),
                             (-FieldElement(1), Witness(3))]))],
        private_parameters={Witness(1), Witness(2)})
    path.write_bytes(serialize_circuit(small))
    cli.main(["solve", "--circuit", str(path), "--witness-json", '{"1": 1, "2": 2}',
              "--batch", "5", "--device", "cpu", "--mesh"])
    out = json.loads(capsys.readouterr().out)
    assert out["satisfied"] == 5 and out["shards"] == 1
    import torch.distributed as dist

    monkeypatch.setenv("ACVM_TPU_COORDINATOR", f"localhost:{launcher._free_port()}")
    monkeypatch.setenv("ACVM_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("ACVM_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("ACVM_TPU_PLATFORM", "cpu")
    try:
        cli.main(["solve", "--circuit", str(path), "--witness-json", '{"1": 1, "2": 2}',
                  "--batch", "3", "--device", "cpu", "--distributed"])
        out = json.loads(capsys.readouterr().out)
        assert out["satisfied"] == 3 and out["shards"] == 1 and dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
