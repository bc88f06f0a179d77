"""The port's integer and directive levels on the CPU: range checks, AND/XOR,
the Quotient directive, power-of-two ToLeRadix and zero-out.

`build_u32_circuit` (the shape of compiled Noir u32 code) is solved by
`acvm_tpu_torch` and held to (1) the sequential engine `acvm_tpu.pwg.ACVM`,
(2) the JAX `BatchSolver` on the CPU (built from the JAX package's classes by
the same builder and seed, so the same circuit) and (3) Python ints: witness
values, `ok` flags and first-failure opcode indices equal bit for bit.  The
JAX solver compiles its programs in about 20 s on a CPU, so it runs once, in
a module fixture.  Each mechanism is then held to Python ints on its own at
the edges of the 32-bit limbs.
"""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvm_tpu import acir as jacir
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.blackbox import StubBlackBoxSolver
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.pwg import ACVM, ACVMStatus
from acvm_tpu.tpu import BatchSolver as JBatchSolver, plan_circuit as jplan_circuit
from acvm_tpu.tpu import intops as jintops

from acvm_tpu_torch import brillig as br
from acvm_tpu_torch import pwg as port_pwg
from acvm_tpu_torch.acir import Circuit, Expression, Witness, WitnessMap
from acvm_tpu_torch.blackbox import GrumpkinSolver
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.convert import limbs16_to_limbs32, limbs32_to_limbs16
from acvm_tpu_torch.fields import kernels as fk
from acvm_tpu_torch.fields.field import FieldElement
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, plan_circuit
from acvm_tpu_torch.gpu import intops
from acvm_tpu_torch.utils.profiling import SolveStats
from acvm_tpu_torch.utils import (
    PORT_CLASSES,
    build_quotient_circuit,
    build_u32_circuit,
    divmod_edge_operands,
    quotient_edge_inputs,
    u32_inputs,
)

P = BN254_FR.modulus
BATCH = 8
BAD_INSTANCE, BAD_INPUT = 3, 5  # input 5 of instance 3 is 2^32 + 5
JAX_LIB = types.SimpleNamespace(Circuit=jacir.Circuit, Expression=jacir.Expression,
                                Witness=jacir.Witness, FieldElement=JFieldElement, opcodes=jops)
fe = FieldElement


def sequential(jcircuit, assignment):
    wm = jacir.WitnessMap()
    for k, v in assignment.items():
        wm.insert(jacir.Witness(k), JFieldElement(v))
    acvm = ACVM(StubBlackBoxSolver(), jcircuit.opcodes, wm)
    return acvm.solve(), acvm


@pytest.fixture(scope="module")
def u32():
    kw = dict(num_rounds=2, units_per_round=8)
    circuit, jcircuit = build_u32_circuit(**kw), build_u32_circuit(**kw, lib=JAX_LIB)
    inputs = u32_inputs(circuit, BATCH)
    inputs[BAD_INSTANCE][BAD_INPUT] = (1 << 32) + 5
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve(inputs)
    return dict(circuit=circuit, jcircuit=jcircuit, inputs=inputs, res=res)


@pytest.fixture(scope="module")
def jax_u32(u32):
    return JBatchSolver(jplan_circuit(u32["jcircuit"])).solve(u32["inputs"])


def test_u32_circuit_shape():
    c = build_u32_circuit(num_inputs=4, num_rounds=3, units_per_round=5)
    assert len(c.opcodes) == 4 + 3 * 5 * 12 and c.current_witness_index == 4 + 3 * 5 * 9
    kinds = [type(op.call if isinstance(op, ops.OpcodeBlackBoxFuncCall) else
                  getattr(op, "directive", op)).__name__ for op in c.opcodes[4:16]]
    assert kinds == ["OpcodeArithmetic", "DirQuotient", "OpcodeArithmetic", "BBRange", "BBRange",
                     "BBAnd", "BBXor", "DirToLeRadix"] + ["BBRange"] * 4
    plan = plan_circuit(build_u32_circuit(num_rounds=2, units_per_round=8))
    assert sum(bool(lv.quotient) for lv in plan.levels) == 2


@pytest.mark.parametrize("instance", range(BATCH))
def test_u32_matches_sequential_engine(u32, instance):
    res = u32["res"]
    status, acvm = sequential(u32["jcircuit"], u32["inputs"][instance])
    if instance == BAD_INSTANCE:
        assert status == ACVMStatus.FAILURE
        assert acvm.error.opcode_location.acir_index == BAD_INPUT - 1  # its Range opcode
        assert not res.ok[instance] and int(res.fail[instance]) == BAD_INPUT - 1
        return
    assert status == ACVMStatus.SOLVED
    assert res.ok[instance] and res.fail[instance] == FAIL_NONE
    got = res.instance_ints(instance)
    expected = list(acvm.finalize())
    assert len(expected) == u32["circuit"].current_witness_index
    assert all(got[int(w)] == int(v) for w, v in expected)


def test_u32_matches_jax_batch_solver_and_ints(u32, jax_u32):
    res, nw = u32["res"], u32["circuit"].current_witness_index + 1
    assert np.array_equal(res.W, jax_u32.W[:, :nw])
    assert np.array_equal(res.ok, jax_u32.ok) and np.array_equal(res.fail, jax_u32.fail)
    # Python ints, unit by unit: the wrap, the masks and the bytes.
    for b in (0, BAD_INSTANCE):
        w = res.instance_ints(b)
        for i in range(0, len(u32["circuit"].opcodes) - 128, 12):
            arith, quot, _, _, _, band, bxor, radix = u32["circuit"].opcodes[128 + i : 136 + i]
            (_, u, v), = arith.expr.mul_terms  # x * y, in witness order
            (_, y), (_, s) = arith.expr.linear_combinations
            assert w[int(s)] == (w[int(u)] * w[int(v)] + w[int(y)] + arith.expr.q_c.value) % P
            q, r = int(quot.directive.quotient.q), int(quot.directive.quotient.r)
            assert (w[q], w[r]) == divmod(w[int(s)], 1 << 32)
            lhs, rhs = int(band.call.lhs.witness), int(band.call.rhs.witness)
            a = w[int(band.call.output)]
            assert a == w[lhs] & w[rhs] & 0xFFFFFFFF
            z = w[int(bxor.call.output)]
            assert z == (a ^ w[int(bxor.call.rhs.witness)]) & 0xFFFFFFFF
            assert [w[int(d)] for d in radix.directive.b] == list(z.to_bytes(4, "little"))


def solve_one(circuit, inputs):
    return BatchSolver(plan_circuit(circuit), device="cpu").solve(inputs)


@pytest.mark.parametrize("bits", [0, 1, 31, 32, 33, 64, 253, 254])
def test_range_at_limb_edges(bits):
    circuit = Circuit(
        current_witness_index=2,
        opcodes=[ops.OpcodeBlackBoxFuncCall(ops.BBRange(ops.FunctionInput(Witness(2), 8))),
                 ops.OpcodeBlackBoxFuncCall(ops.BBRange(ops.FunctionInput(Witness(1), bits)))],
        private_parameters={Witness(1), Witness(2)},
    )
    values = [(1 << bits) - 1, 1 << bits, P - 1, 0, (1 << max(bits - 1, 0)) | 1 << 31]
    inputs = [{1: v, 2: 7} for v in values] + [{1: 0, 2: 256}]
    res = solve_one(circuit, inputs)
    want = [(v % P).bit_length() <= bits for v in values]
    assert res.ok.tolist() == want + [False]
    assert res.fail.tolist() == [int(FAIL_NONE) if ok else 1 for ok in want] + [0]


def and_xor_circuit(lib, bits):
    """AND(w1, w2) -> w3 and XOR(w1, w2) -> w4 at ``bits``, from either package."""
    o, w = lib.opcodes, lib.Witness

    def fi(i):
        return o.FunctionInput(w(i), bits)

    return lib.Circuit(
        current_witness_index=4,
        opcodes=[o.OpcodeBlackBoxFuncCall(o.BBAnd(fi(1), fi(2), w(3))),
                 o.OpcodeBlackBoxFuncCall(o.BBXor(fi(1), fi(2), w(4)))],
        private_parameters={w(1), w(2)},
    )


@pytest.mark.parametrize("bits", [1, 8, 31, 32, 33, 64, 128, 254])
def test_and_xor_at_limb_edges(bits):
    rng = random.Random(bits)
    top31 = sum(1 << (32 * j + 31) for j in range(8)) % P  # bit 31 of every limb
    pairs = [(top31, P - 1), (P - 1, 0), (3 << 252, (1 << 252) - 1), (top31, top31 >> 1)]
    pairs += [(rng.randrange(P) | 1 << 31, rng.randrange(P) | 1 << 63) for _ in range(4)]
    res = solve_one(and_xor_circuit(PORT_CLASSES, bits), [{1: a, 2: b} for a, b in pairs])
    assert res.ok.all()
    m = (1 << bits) - 1
    assert res.witness_ints(3) == [(a & m) & (b & m) for a, b in pairs]
    assert res.witness_ints(4) == [((a & m) ^ (b & m)) % P for a, b in pairs]
    if bits == 254:  # the XOR reaches p there and is reduced, as FieldElement does
        assert any((a ^ b) >= P for a, b in pairs)
    for b, (x, y) in enumerate(pairs[:3]):
        status, acvm = sequential(and_xor_circuit(JAX_LIB, bits), {1: x, 2: y})
        assert status == ACVMStatus.SOLVED
        assert [int(acvm.finalize().get(jacir.Witness(w))) for w in (3, 4)] == [
            res.witness_ints(3)[b], res.witness_ints(4)[b]]


def radix_circuit(radix, n_full, n_short):
    """opcode 0: w1 into n_full digits (w2 ...); opcode 1: w1 into n_short."""
    full = [Witness(2 + i) for i in range(n_full)]
    short = [Witness(2 + n_full + i) for i in range(n_short)]
    lin = Expression(linear_combinations=[(fe(1), Witness(1))])
    return Circuit(
        current_witness_index=1 + n_full + n_short,
        opcodes=[ops.OpcodeDirective(ops.DirToLeRadix(lin, full, radix)),
                 ops.OpcodeDirective(ops.DirToLeRadix(lin, short, radix))],
        private_parameters={Witness(1)},
    ), full, short


@pytest.mark.parametrize("radix", [2, 4, 8, 16, 256])
def test_to_le_radix_across_limbs(radix):
    k = radix.bit_length() - 1
    n_full = 264 // k + 1  # past bit 256: those digits are zero
    n_short = 40 // k  # a 40-bit capacity
    circuit, full, short = radix_circuit(radix, n_full, n_short)
    rng = random.Random(radix)
    values = [P - 1, 0, (1 << 40) - 1, 1 << 40, sum(1 << (32 * j + 31) for j in range(7)),
              rng.randrange(P), rng.randrange(1 << 40)]
    res = solve_one(circuit, [{1: v} for v in values])
    fits = [v < 1 << (k * n_short) for v in values]
    assert res.ok.tolist() == fits
    assert res.fail.tolist() == [int(FAIL_NONE) if f else 1 for f in fits]
    for d, w in enumerate(full):
        assert res.witness_ints(int(w)) == [(v >> (k * d)) % radix for v in values], d
    # the batched path writes the low digits of a value that does not fit
    for d, w in enumerate(short):
        assert res.witness_ints(int(w)) == [(v >> (k * d)) % radix for v in values], d


def unported_opcode(kind):
    def fi(w, bits):
        return ops.FunctionInput(Witness(w), bits)

    if kind == "hashes":
        return ops.OpcodeBlackBoxFuncCall(ops.BBSha256([fi(1, 8)], [Witness(2 + i) for i in range(32)]))
    if kind == "ecdsa":
        return ops.OpcodeBlackBoxFuncCall(ops.BBEcdsaSecp256k1(
            [fi(1, 8)] * 32, [fi(1, 8)] * 32, [fi(1, 8)] * 64, [fi(1, 8)] * 32, Witness(2)))
    # Brillig blocks the planner cannot trace go to a host stage: a jump, or a
    # foreign call.
    if kind == "brillig_jump":
        bytecode = [br.OpJump(1), br.OpStop()]
    else:
        bytecode = [br.OpForeignCall("oracle", (br.RomRegister(br.RegisterIndex(0)),), ()),
                    br.OpStop()]
    return ops.OpcodeBrillig(ops.Brillig(
        inputs=[], outputs=[ops.BrilligOutputSimple(Witness(2))], foreign_call_results=[],
        bytecode=bytecode, predicate=None))


@pytest.mark.parametrize("kind,what", [("hashes", "hash gadgets"), ("ecdsa", "ECDSA verification"),
                                       ("brillig_jump", "host stages"),
                                       ("brillig_foreign_call", "host stages")])
def test_other_unported_kinds_still_raise(kind, what):
    """ECDSA planned for the device packs its level as an ECDSA group (its
    solves are held to the JAX package in tests/test_torch_ecdsa.py).  The SHA-256 opcode solves
    on the device's hash level (the plain digest here) and equals pwg.ACVM.
    The two Brillig blocks are host stages: the jump runs on the device
    Brillig VM (its plain version here), as the JAX package's host path runs
    it, and equals the per-instance route and pwg.ACVM; the foreign call runs
    on the host, and with no handler its instance fails there."""
    circuit = Circuit(current_witness_index=40, opcodes=[unported_opcode(kind)],
                      private_parameters={Witness(1)})
    if kind == "hashes":
        res = BatchSolver(plan_circuit(circuit), device="cpu").solve([{1: 3}, {1: 4}])
        assert res.ok.all() and (res.fail == FAIL_NONE).all()
        for b, value in enumerate((3, 4)):
            acvm = port_pwg.ACVM(GrumpkinSolver(), circuit.opcodes,
                                 WitnessMap({Witness(1): FieldElement(value)}))
            assert acvm.solve() == port_pwg.ACVMStatus.SOLVED
            solved = list(acvm.finalize())
            assert len(solved) == 33 and all(res.instance_ints(b)[int(w)] == int(v) for w, v in solved)
        return
    if kind == "brillig_jump":
        stats, per_stats = SolveStats(), SolveStats()
        res = BatchSolver(plan_circuit(circuit), device="cpu").solve([{1: 3}, {1: 4}], stats=stats)
        per = BatchSolver(plan_circuit(circuit), device="cpu", host_batch=False).solve(
            [{1: 3}, {1: 4}], stats=per_stats)
        assert res.ok.all() and res.witness_ints(2) == [0, 0] and stats.host_per_instance_stages == 0
        assert torch.equal(per.panel, res.panel) and per_stats.host_per_instance_stages == 1
        acvm = port_pwg.ACVM(GrumpkinSolver(), circuit.opcodes,
                             WitnessMap({Witness(1): FieldElement(3)}))
        assert acvm.solve() == port_pwg.ACVMStatus.SOLVED
        assert int(acvm.finalize().get(Witness(2))) == 0
        return
    if kind == "brillig_foreign_call":
        res = BatchSolver(plan_circuit(circuit), device="cpu").solve([{1: 3}, {1: 4}])
        assert not res.ok.any() and res.fail.tolist() == [0, 0]
        return
    assert kind == "ecdsa" and what == "ECDSA verification"
    groups = [g for seg in BatchSolver(plan_circuit(circuit), device="cpu").segments
              for lv in seg.levels for g in lv.get(kind, [])]
    assert [g["curve"] for g in groups] == ["secp256k1"]
    assert groups[0]["sig"].tolist() == [[1] * 64] and groups[0]["out_idx"].tolist() == [2]


def test_to_le_radix_of_other_radices_and_permutation_sort_raise():
    lin = Expression(linear_combinations=[(fe(1), Witness(1))])
    radix10 = Circuit(
        current_witness_index=3,
        opcodes=[ops.OpcodeDirective(ops.DirToLeRadix(lin, [Witness(2), Witness(3)], 10))],
        private_parameters={Witness(1)},
    )
    sort = Circuit(
        current_witness_index=3,
        opcodes=[ops.OpcodeDirective(ops.DirPermutationSort(
            inputs=[[lin], [Expression(linear_combinations=[(fe(1), Witness(2))])]],
            tuple_size=1, bits=[Witness(3)], sort_by=[0]))],
        private_parameters={Witness(1), Witness(2)},
    )
    # Host stages now: both solve as the sequential solvers do.  w1 = 37 and
    # w2 = 5 sort as (w2, w1), one switch set.
    for circuit, want in ((radix10, [7, 3]), (sort, [1])):
        res = BatchSolver(plan_circuit(circuit), device="cpu").solve([{1: 37, 2: 5}])
        assert res.ok.all() and res.instance_ints(0)[3 - len(want) + 1:] == want
    res = BatchSolver(plan_circuit(radix10), device="cpu").solve([{1: 100}])  # needs 3 digits
    assert not res.ok[0] and res.fail[0] == 0


def test_quotient_edges_and_compound_expressions():
    inputs = quotient_edge_inputs(P)
    res = solve_one(build_quotient_circuit(), inputs)
    assert res.ok.all()

    def quotient(a, b, pred=1):
        a, b = a % P, b % P
        return (0, 0) if pred % P == 0 or b == 0 else divmod(a, b)

    want = [quotient(x[1], x[2]) for x in inputs]
    assert list(zip(res.witness_ints(4), res.witness_ints(5))) == want
    want = [quotient(x[1] * x[2] + 3 * x[1] + 7, x[2] + 1, x[3]) for x in inputs]
    assert list(zip(res.witness_ints(6), res.witness_ints(7))) == want
    for b, assignment in enumerate(inputs):
        status, acvm = sequential(build_quotient_circuit(JAX_LIB), assignment)
        assert status == ACVMStatus.SOLVED
        assert [int(acvm.finalize().get(jacir.Witness(w))) for w in (4, 5, 6, 7)] == [
            res.witness_ints(w)[b] for w in (4, 5, 6, 7)]


def test_zero_out_writes_zeros():
    fi = [ops.FunctionInput(Witness(1), 254)]
    outs = [Witness(2), Witness(3)]
    circuit = Circuit(
        current_witness_index=4,
        opcodes=[
            ops.OpcodeBlackBoxFuncCall(ops.BBRecursiveAggregation(
                verification_key=fi, proof=fi, public_inputs=[], key_hash=fi[0],
                input_aggregation_object=None, output_aggregation_object=outs)),
            ops.OpcodeArithmetic(Expression(linear_combinations=[
                (fe(1), Witness(2)), (fe(1), Witness(1)), (-fe(1), Witness(4))])),
        ],
        private_parameters={Witness(1)},
    )
    solver = BatchSolver(plan_circuit(circuit), device="cpu")
    W, ok, fail, mem = solver.initial_state([{1: 11}, {1: P - 1}])
    W[2:4] = 123  # junk where the outputs go: the level must overwrite it
    W, ok, fail, mem = solver.run_segments((W, ok, fail, mem))
    assert fk.limbs32_to_ints(W[2:4].numpy()) == [0] * 4
    assert fk.limbs32_to_ints(W[4].numpy()) == [11, P - 1] and ok.all()


def test_long_divmod_plain_on_the_kernel_edge_set():
    a, b = divmod_edge_operands(P)
    assert len(a) > 256
    ta = torch.from_numpy(fk.ints_to_limbs32(a).copy())
    tb = torch.from_numpy(fk.ints_to_limbs32(b).copy())
    for bits in (256, 64):
        q, r = intops.long_divmod(ta, tb, num_bits=bits)
        m = (1 << bits) - 1
        want = [divmod(x & m, y) if y else (0, 0) for x, y in zip(a, b)]
        assert list(zip(fk.limbs32_to_ints(q.numpy()), fk.limbs32_to_ints(r.numpy()))) == want
    with pytest.raises(ValueError, match="num_bits"):
        intops.long_divmod(ta, tb, num_bits=257)
    with pytest.raises(TypeError, match="int32"):
        intops.long_divmod(ta.to(torch.int64), tb)


@pytest.mark.parametrize("bits", [256, 64, 8])
def test_long_divmod_plain_short_division(bits, monkeypatch):
    """Divisors all below 2^47 (a zero among them) take the int64 short
    division; one divisor of 2^47 sends the whole tensor bit-serial.  Both
    against Python ints, dividends up to 2^256 - 1."""
    rng = random.Random(bits)
    short_b = [0, 1, 2, 3, 7, (1 << 16) - 1, 1 << 16, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
               (1 << 47) - 1] + [rng.randrange(1, 1 << 47) for _ in range(5)]
    dividends = [0, 1, (1 << 256) - 1, P - 1, (1 << 64) - 1, 1 << 63, (1 << 47) - 1, 1 << 47,
                 (1 << 48) + 5] + [rng.getrandbits(256) for _ in range(5)]
    taken = []
    short = intops._short_divmod_plain
    monkeypatch.setattr(intops, "_short_divmod_plain",
                        lambda *args: taken.append(1) or short(*args))
    m = (1 << bits) - 1
    for divisors, want_short in ((short_b, True), (short_b + [1 << 47], False)):
        a = [x for x in dividends for _ in divisors]
        b = divisors * len(dividends)
        taken.clear()
        q, r = intops.long_divmod_plain(torch.from_numpy(fk.ints_to_limbs32(a).copy()),
                                        torch.from_numpy(fk.ints_to_limbs32(b).copy()), bits)
        assert bool(taken) == want_short
        want = [divmod(x & m, y) if y else (0, 0) for x, y in zip(a, b)]
        assert list(zip(fk.limbs32_to_ints(q.numpy()), fk.limbs32_to_ints(r.numpy()))) == want


M32 = (1 << 32) - 1


def divmod_words(a, b):
    """``csrc/divmod.cu`` step for step in Python ints: (q, r) and the names
    of the branches the division took."""
    x = [a >> 32 * i & M32 for i in range(8)]
    y = [b >> 32 * i & M32 for i in range(8)]
    m = max((i + 1 for i in range(8) if x[i]), default=0)
    n = max((i + 1 for i in range(8) if y[i]), default=0)
    if n == 0:
        return 0, 0, {"b = 0"}
    if m < n:
        return 0, a, {"a shorter than b"}
    s = 32 - y[n - 1].bit_length()
    hit = {f"n = {n}", f"m = n + {m - n}", f"shift {s}", (m, n)}
    u = [(a << s) >> 32 * i & M32 for i in range(9)]
    v = [(b << s) >> 32 * i & M32 for i in range(8)]
    d1 = v[n - 1]
    q = [0] * 9
    if n == 1:
        rem = u[m]  # below 2^s <= d1: its digit is 0
        assert rem < d1
        for j in range(m - 1, -1, -1):
            q[j], rem = divmod(rem << 32 | u[j], d1)
        u = [rem] + [0] * 8
    for j in range(m - n, -1, -1) if n > 1 else ():
        u2, u1, u0 = u[j + n], u[j + n - 1], u[j + n - 2]
        if u2 == d1:
            qhat, rhat = M32, u1 + d1
            hit.add("estimate at its limit")
        else:
            qhat, rhat = divmod(u2 << 32 | u1, d1)
        corrected = 0
        while rhat <= M32 and qhat * v[n - 2] > (rhat << 32 | u0):
            qhat, rhat, corrected = qhat - 1, rhat + d1, corrected + 1
        assert corrected <= 2
        hit.add(f"corrected {corrected}")
        k = 0
        for i in range(n):
            p = qhat * v[i] + k
            k = (p >> 32) + (u[j + i] < p & M32)
            u[j + i] = (u[j + i] - p) & M32
        top, u[j + n] = u[j + n], (u[j + n] - k) & M32
        if top < k:
            hit.add("add back")
            qhat -= 1
            t = sum(u[j + i] << 32 * i for i in range(n + 1)) + sum(w << 32 * i for i, w in enumerate(v[:n]))
            u[j: j + n + 1] = [t >> 32 * i & M32 for i in range(n + 1)]
        q[j] = qhat
    r = sum(((u[i] | u[i + 1] << 32) >> s & M32) << 32 * i for i in range(8))
    return sum(w << 32 * i for i, w in enumerate(q[:8])), r, hit


DIVMOD_WIDTHS = (256, 254, 128, 64, 32, 8)  # the Quotient's and Brillig's


def test_divmod_model_on_the_edge_set_reaches_every_branch():
    hit = set()
    for x, y in zip(*divmod_edge_operands(P)):
        q, r, branches = divmod_words(x, y)
        assert (q, r) == (divmod(x, y) if y else (0, 0)), (x, y)
        hit |= branches
        if y > 1 and x in (y - 1, y + 1):
            hit.add(f"a = b {x - y:+d}")
    assert {"corrected 1", "corrected 2", "add back", "estimate at its limit", "shift 0",
            "shift 31", "n = 1", "n = 8", "m = n + 0", "m = n + 1", "b = 0", "a shorter than b",
            "a = b -1", "a = b +1"} <= hit
    assert {(m, n) for m in range(1, 9) for n in range(1, m + 1)} <= hit


def test_long_divmod_at_quotient_and_brillig_widths_matches_ints_and_jax():
    a, b = divmod_edge_operands(P)
    ta = torch.from_numpy(fk.ints_to_limbs32(a).copy())
    tb = torch.from_numpy(fk.ints_to_limbs32(b).copy())
    # The JAX function in one compiled call: its loop reads only the bits of a
    # below num_bits, so at 256 bits over dividends masked to each width it is
    # the division at that width.
    masked = [[x & (1 << bits) - 1 for x in a] for bits in DIVMOD_WIDTHS]
    jq, jr = jintops.long_divmod(jnp.asarray(limbs32_to_limbs16(fk.ints_to_limbs32(sum(masked, [])))),
                                 jnp.asarray(limbs32_to_limbs16(fk.ints_to_limbs32(b * len(masked)))))
    jq = limbs16_to_limbs32(np.asarray(jq)).reshape(len(masked), len(a), 8)
    jr = limbs16_to_limbs32(np.asarray(jr)).reshape(len(masked), len(a), 8)
    for w, (bits, am) in enumerate(zip(DIVMOD_WIDTHS, masked)):
        q, r = intops.long_divmod(ta, tb, num_bits=bits)
        want = [divmod(x, y) if y else (0, 0) for x, y in zip(am, b)]
        assert list(zip(fk.limbs32_to_ints(q.numpy()), fk.limbs32_to_ints(r.numpy()))) == want, bits
        assert [divmod_words(x, y)[:2] for x, y in zip(am, b)] == want, bits
        assert np.array_equal(q.numpy(), jq[w]) and np.array_equal(r.numpy(), jr[w]), bits
