"""The port's hash gadgets on the CPU: SHA-256, BLAKE2s, Keccak-256 of a static
and of a runtime length, and hash-to-field.

Each plain digest of `acvm_tpu_torch.gpu.gadgets` is held to the JAX
package's (`acvm_tpu.tpu.gadgets`, called un-jitted: plain Python over `jnp`,
so no XLA compile of a 64-round unrolled graph) and to `hashlib` or the host
Keccak on the same seeded bytes, at the lengths where the padding changes.
The port's packed hash groups are held to the JAX `_pack_level`'s after the
16- to 32-bit limb conversion.  `build_membership_circuit(2)` is solved over 6
instances by the port's `BatchSolver(device="cpu")` and held to the JAX
`BatchSolver` (its levels run one by one in one module fixture, the file's one
JAX solve), to `pwg.ACVM` and to the same circuit planned with
`device_hash_kernels=False`: witness values, `ok` flags and first-failure
indices, tolerance 0 (bytes and field elements).

Where the references disagree the port follows `pwg.ACVM`, and a test names
each case: a variable-length Keccak's size is read by its low 128 bits
(`FieldElement.to_u128`), where the JAX device route fails the instance on any
bit at or above 2^32; a hash input read at more than 256 bits gives the 32
bytes of the element (`fetch_nearest_bytes`), where the JAX planner names
16-bit limbs past the element's 16.
"""

import hashlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvm_tpu import acir as jacir
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.blackbox import GrumpkinSolver as JGrumpkinSolver
from acvm_tpu.blackbox.hashes import keccak256 as jkeccak256
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.pwg import ACVM, ACVMStatus
from acvm_tpu.tpu import BatchSolver as JBatchSolver, gadgets as jgadgets, plan_circuit as jplan_circuit

from acvm_tpu_torch import convert
from acvm_tpu_torch.acir import Circuit, Witness
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.blackbox.hashes import keccak256
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, gadgets, plan_circuit
from acvm_tpu_torch.utils import (
    build_membership_circuit,
    columnar_instance,
    membership_circuit_roles,
    membership_inputs,
    membership_outputs,
)

P = BN254_FR.modulus
DEPTH, BATCH = 2, 6
JAX_LIB = types.SimpleNamespace(Circuit=jacir.Circuit, Expression=jacir.Expression,
                                Witness=jacir.Witness, FieldElement=JFieldElement, opcodes=jops)
ROLES = membership_circuit_roles(DEPTH)
# Instance -> what it holds: a path bit of 2 (fails level 0's boolean check),
# memo_len 233 (past the 232-byte message: fails at the keccak_var opcode),
# memo_len 2^128 + 100 (the low 128 bits: 100 bytes, solved), and lengths
# either side of Keccak's 136-byte rate.
BAD_BIT, LONG, WIDE = 1, 2, 3
MEMO_LENS = {LONG: 233, WIDE: (1 << 128) + 100, 4: 135, 5: 137}


def jax_solve(solver, inputs):
    """The JAX BatchSolver's levels one at a time: (W, ok, fail) on the host."""
    W, ok, fail, mem = solver.initial_state(inputs)
    for segment in solver.segments:
        for packed in segment.levels:
            W, ok, fail, mem = solver._run_level(W, ok, fail, mem, packed)
        assert not segment.host_stages
    return jax.device_get((W, ok, fail))


def sequential(jcircuit, assignment):
    """The JAX package's pwg.ACVM on one instance: (status, acvm)."""
    wm = jacir.WitnessMap({jacir.Witness(w): JFieldElement(int(v)) for w, v in assignment.items()})
    acvm = ACVM(JGrumpkinSolver(), jcircuit.opcodes, wm)
    return acvm.solve(), acvm


def assert_equals_sequential(jcircuit, cols, res, instances):
    """Solved instances: every witness of the sequential engine; failing
    ones: the opcode it stops at."""
    for b in instances:
        status, acvm = sequential(jcircuit, columnar_instance(cols, b))
        if status == ACVMStatus.SOLVED:
            assert res.ok[b] and res.fail[b] == FAIL_NONE, b
            got = res.instance_ints(b)
            want = list(acvm.finalize())
            assert [got[int(w)] for w, _ in want] == [int(v) for _, v in want], b
        else:
            assert status == ACVMStatus.FAILURE and not res.ok[b], b
            # a failed black-box call carries no location: the engine stops on it
            location = getattr(acvm.error, "opcode_location", None)
            index = acvm.instruction_pointer if location is None else location.acir_index
            assert int(res.fail[b]) == index, b


def random_bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


# ---------------------------------------------------------------------------
# The plain digests
# ---------------------------------------------------------------------------

DIGESTS = {  # kind: (port, JAX, host)
    "sha256": (gadgets.sha256_digest, jgadgets.sha256_digest, lambda m: hashlib.sha256(m).digest()),
    "blake2s": (gadgets.blake2s_digest, jgadgets.blake2s_digest, lambda m: hashlib.blake2s(m).digest()),
    "keccak256": (gadgets.keccak256_digest, jgadgets.keccak256_digest, keccak256),
}
LENGTHS = {"sha256": (0, 1, 55, 56, 63, 64, 119, 120), "blake2s": (0, 1, 63, 64, 65, 128),
           "keccak256": (0, 1, 135, 136, 137, 271, 272)}


@pytest.mark.parametrize("kind,M", [(k, m) for k, ms in LENGTHS.items() for m in ms])
def test_plain_digest_equals_jax_and_host(kind, M):
    port, jax_fn, host = DIGESTS[kind]
    msg = random_bytes((3, M), seed=M)
    got = port(torch.from_numpy(msg))
    assert got.dtype == torch.int32 and got.shape == (3, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fn(jnp.asarray(msg, dtype=jnp.uint32))))
    assert [bytes(d.tolist()) for d in got.numpy()] == [host(bytes(r.tolist())) for r in msg]


@pytest.mark.parametrize("M", [136, 272])
def test_keccak_var_digest_equals_jax_and_host(M):
    """Lengths 0 ... M over 17 instances: either side of every rate block."""
    lengths = sorted({n for n in (0, 1, 135, 136, 137, M - 1, M, *range(0, M, 29)) if n <= M})
    msg = random_bytes((len(lengths), M), seed=M + 1)
    got = gadgets.keccak256_var_digest(torch.from_numpy(msg), torch.tensor(lengths))
    want = jgadgets.keccak256_var_digest(jnp.asarray(msg, dtype=jnp.uint32),
                                         jnp.asarray(lengths, dtype=jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [bytes(d.tolist()) for d in got.numpy()] == [
        keccak256(bytes(r[:n].tolist())) for r, n in zip(msg, lengths)]


@pytest.mark.parametrize("bad", [-1, 137])
def test_keccak_var_length_outside_the_message_raises(bad):
    """A length past M (or below 0) is refused by both wrappers, not hashed
    over bytes beyond the message."""
    msg = torch.from_numpy(random_bytes((3, 136), seed=5))
    with pytest.raises(ValueError, match="lengths must lie in 0 ... 136"):
        gadgets.keccak256_var_digest(msg, torch.tensor([0, bad, 136]))
    W = torch.zeros((40, 3, 8), dtype=torch.int32)
    tables = [torch.zeros((1, 136), dtype=torch.int32) for _ in range(3)]
    out_idx = torch.arange(8, 40, dtype=torch.int32).reshape(1, 32)
    with pytest.raises(ValueError, match="lengths must lie in 0 ... 136"):
        gadgets.hash_rows("keccak_var", W, *tables, out_idx,
                          length=torch.tensor([[0, bad, 136]], dtype=torch.int32))
    # Keccak-f alone, on the same lanes, against the JAX permutation.
    lanes = np.random.default_rng(3).integers(0, 1 << 32, size=(2, 25, 4), dtype=np.uint64)
    lo, hi = gadgets.keccak_f1600_plain(*(torch.from_numpy(lanes[i].astype(np.int64)) for i in (0, 1)))
    jlanes = jgadgets.keccak_f1600_batched(
        [(jnp.asarray(lanes[0, i], dtype=jnp.uint32), jnp.asarray(lanes[1, i], dtype=jnp.uint32))
         for i in range(25)])
    assert np.array_equal(lo.numpy(), np.stack([np.asarray(a) for a, _ in jlanes]))
    assert np.array_equal(hi.numpy(), np.stack([np.asarray(b) for _, b in jlanes]))


def test_hash_rows_to_field_matches_host():
    """hash_rows off a panel: bytes of arbitrary limbs and shifts, and the
    hash-to-field row against `hash_to_field_128_security`."""
    from acvm_tpu_torch.blackbox.hashes import hash_to_field_128_security
    from acvm_tpu_torch.fields import kernels as fk

    rng = np.random.default_rng(5)
    NW, B, M = 12, 5, 70
    W = torch.from_numpy(rng.integers(-2**31, 2**31, size=(NW, B, 8)).astype(np.int32))
    src_w = torch.from_numpy(rng.integers(0, 10, size=(2, M)).astype(np.int32))
    src_limb = torch.from_numpy(rng.integers(0, 8, size=(2, M)).astype(np.int32))
    src_shift = torch.from_numpy(8 * rng.integers(0, 4, size=(2, M)).astype(np.int32))
    out = gadgets.hash_rows("hash_to_field", W.clone(), src_w, src_limb, src_shift,
                            torch.tensor([[10], [11]], dtype=torch.int32), modulus=P)
    words = W.numpy().view(np.uint32)
    for g in range(2):
        for b in range(B):
            msg = bytes(int(words[w, b, l] >> s) & 0xFF for w, l, s in
                        zip(src_w[g].tolist(), src_limb[g].tolist(), src_shift[g].tolist()))
            assert fk.limbs32_to_ints(out[10 + g, b][None].numpy()) == [
                int(hash_to_field_128_security(msg))]
    np.testing.assert_array_equal(out[:10].numpy(), W[:10].numpy())


# ---------------------------------------------------------------------------
# The membership program, both packages
# ---------------------------------------------------------------------------


def membership_columns():
    cols = {w: a.astype(object) for w, a in membership_inputs(
        build_membership_circuit(DEPTH), BATCH).items()}
    cols[ROLES["bits"][0]][BAD_BIT] = 2
    for b, n in MEMO_LENS.items():
        cols[ROLES["memo_len"][0]][b] = n
    return cols


@pytest.fixture(scope="module")
def membership():
    circuit = build_membership_circuit(DEPTH)
    jcircuit = build_membership_circuit(DEPTH, lib=JAX_LIB)
    cols = membership_columns()
    plan, jplan = plan_circuit(circuit), jplan_circuit(jcircuit)
    jsolver = JBatchSolver(jplan)
    return dict(circuit=circuit, jcircuit=jcircuit, cols=cols, plan=plan, jsolver=jsolver,
                res=BatchSolver(plan, device="cpu").solve(cols), jax=jax_solve(jsolver, cols))


def test_membership_circuit_shape(membership):
    plan, circuit = membership["plan"], membership["circuit"]
    assert len(circuit.opcodes) == 236 + 98 * DEPTH and circuit.num_vars() - 1 == 331 + 129 * DEPTH
    kinds = [(g.kind, len(g.byte_src)) for lv in plan.levels for g in lv.hashes]
    assert kinds == [("blake2s", 32), ("hash_to_field", 64)] + [("sha256", 64)] * DEPTH + [
        ("keccak_var", 232), ("keccak256", 64)]
    assert not any(lv.host for lv in plan.levels)


def test_membership_equals_jax_batch_solver(membership):
    """Every witness, flag and first-failure index of the JAX BatchSolver,
    but for the instance whose size is 2^128 + 100: the JAX device route
    fails it, the port solves it (see the next test but one)."""
    res, (W, ok, fail) = membership["res"], membership["jax"]
    nw = membership["circuit"].num_vars()
    np.testing.assert_array_equal(res.panel.numpy(), convert.panel_from_jax(W, nw))
    want_ok, want_fail = np.asarray(ok).tolist(), np.asarray(fail).tolist()
    assert (want_ok[WIDE], want_fail[WIDE]) == (False, ROLES["keccak_var_opcode"][0])
    want_ok[WIDE], want_fail[WIDE] = True, int(FAIL_NONE)
    assert res.ok.tolist() == want_ok and res.fail.tolist() == want_fail


def test_membership_equals_sequential_engine_and_host_hashes(membership):
    res, cols = membership["res"], membership["cols"]
    assert res.fail.tolist() == [int(FAIL_NONE), ROLES["bool_check_opcodes"][0],
                                 ROLES["keccak_var_opcode"][0]] + [int(FAIL_NONE)] * 3
    assert_equals_sequential(membership["jcircuit"], cols, res, range(BATCH))
    for b in range(BATCH):
        want, got = membership_outputs(columnar_instance(cols, b), DEPTH), res.instance_ints(b)
        for role in ("leaf", "path", "root", "signal", "binding"):
            if want[role] is not None:
                assert bytes(got[w] for w in ROLES[role]) == want[role], (b, role)
        assert got[ROLES["nullifier"][0]] == want["nullifier"]
    assert membership_outputs(columnar_instance(cols, WIDE), DEPTH)["signal"] == keccak256(
        bytes(res.instance_ints(WIDE)[w] for w in ROLES["root"] + ROLES["memo"])[:100])


def test_membership_hashes_as_host_stages_give_the_same_panel(membership):
    config = types.SimpleNamespace(field_params=lambda: BN254_FR, device_hash_kernels=False,
                                   device_brillig_trace=True)
    plan = plan_circuit(membership["circuit"], config=config)
    assert not any(lv.hashes for lv in plan.levels)
    res = BatchSolver(plan, device="cpu").solve(membership["cols"])
    ref = membership["res"]
    assert res.ok.tolist() == ref.ok.tolist() and res.fail.tolist() == ref.fail.tolist()
    solved = torch.from_numpy(ref.ok)
    # A failing instance stops at its failing opcode on the host: compare the
    # solved instances whole, and the failing ones up to that opcode.
    assert torch.equal(res.panel[:, solved], ref.panel[:, solved])


def test_hash_packs_equal_the_jax_package_s(membership):
    """The packed groups of every hash level, the 16-bit limb layout of the
    JAX pack turned into the port's 32-bit one: limb j // 4, shift 8 (j % 4)
    for byte j of a witness."""
    ports = [g for seg in BatchSolver(membership["plan"], device="cpu").segments
             for lv in seg.levels for g in lv.get("hashes", [])]
    jaxs = [g for seg in membership["jsolver"].segments for lv in seg.levels for g in lv.get("hashes", [])]
    assert len(ports) == len(jaxs) == 4 + DEPTH
    for port, jpk in zip(ports, jaxs):
        byte = 2 * np.asarray(jpk["src_limb"]) + np.asarray(jpk["src_shift"]) // 8
        assert port["kind"] == jpk["kind"]
        np.testing.assert_array_equal(port["src_w"].numpy(), jpk["src_w"])
        np.testing.assert_array_equal(port["src_limb"].numpy(), byte // 4)
        np.testing.assert_array_equal(port["src_shift"].numpy(), 8 * (byte % 4))
        np.testing.assert_array_equal(port["out_idx"].numpy().reshape(-1), jpk["out_idx"])
        np.testing.assert_array_equal(port["size_w"].numpy(), jpk["size_w"])
        np.testing.assert_array_equal(port["op_idx"].numpy(), jpk["op_idx"])


# ---------------------------------------------------------------------------
# Inputs read at other widths, and the two disagreements
# ---------------------------------------------------------------------------


def hash_circuit(lib, widths, kind="sha256"):
    """One hash gadget over witnesses 1..n read at ``widths``; keccak_var's
    size is witness n + 1."""
    o, W = lib.opcodes, lib.Witness
    n = len(widths)
    inputs = [o.FunctionInput(W(1 + i), bits) for i, bits in enumerate(widths)]
    outs = [W(n + 2 + k) for k in range(32)]
    if kind == "keccak_var":
        call = o.BBKeccak256VariableLength(inputs=inputs, var_message_size=o.FunctionInput(W(n + 1), 32),
                                           outputs=outs)
    else:
        call = o.BBSha256(inputs=inputs, outputs=outs)
    return lib.Circuit(current_witness_index=n + 33, opcodes=[o.OpcodeBlackBoxFuncCall(call)],
                       private_parameters={W(1 + i) for i in range(n + (kind == "keccak_var"))})


@pytest.mark.parametrize("widths", [(1, 12, 16, 64, 254), (254, 1), (8,) * 3])
def test_hash_inputs_read_at_their_bits_equal_sequential_engine(widths):
    """fetch_nearest_bytes: ceil(bits / 8) little-endian bytes of the whole
    value, the bits above num_bits not masked."""
    port_lib = types.SimpleNamespace(Circuit=Circuit, Witness=Witness, opcodes=ops)
    circuit, jcircuit = hash_circuit(port_lib, widths), hash_circuit(JAX_LIB, widths)
    rng = np.random.default_rng(len(widths))
    cols = {1 + i: np.array([int(v) % P for v in rng.integers(0, 1 << 62, size=4)] + [P - 1, 0],
                            dtype=object) * 7919 % P for i in range(len(widths))}
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve(cols)
    assert res.ok.all()
    assert_equals_sequential(jcircuit, cols, res, range(6))


def test_hash_input_read_at_more_than_256_bits_gives_32_bytes():
    """pwg.ACVM hashes the element's 32 bytes (`fetch_nearest_bytes` of 300
    bits); the JAX planner gives 38 bytes, its last six from 16-bit limbs 16-18
    past the element, which its device route reads as 0xFF.  The port
    follows pwg.ACVM."""
    port_lib = types.SimpleNamespace(Circuit=Circuit, Witness=Witness, opcodes=ops)
    widths = (300, 8)
    circuit, jcircuit = hash_circuit(port_lib, widths), hash_circuit(JAX_LIB, widths)
    cols = {1: np.array([P - 1, 12345], dtype=object), 2: np.array([7, 8], dtype=object)}
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve(cols)
    assert_equals_sequential(jcircuit, cols, res, range(2))
    for b in range(2):
        msg = cols[1][b].to_bytes(32, "little") + bytes([cols[2][b]])
        assert bytes(res.instance_ints(b)[w] for w in range(4, 36)) == hashlib.sha256(msg).digest()
    jplan = jplan_circuit(jcircuit)
    assert [len(g.byte_src) for lv in jplan.levels for g in lv.hashes] == [39]
    W, ok, _ = jax_solve(JBatchSolver(jplan), cols)
    jdigest = convert.panel_from_jax(W, 36)[4:36, :, 0].T
    want = [hashlib.sha256(cols[1][b].to_bytes(32, "little") + b"\xff" * 6 + bytes([cols[2][b]])).digest()
            for b in range(2)]
    assert [bytes(d.tolist()) for d in jdigest] == want and np.asarray(ok).all()


def test_keccak_var_size_reads_its_low_128_bits():
    """A size of 2^128 + 100 over a 120-byte message: pwg.ACVM reads its low
    128 bits (`to_u128`) and hashes 100 bytes; the JAX BatchSolver fails the
    instance (any bit at or above 2^32); the port gives what pwg.ACVM gives.
    Sizes past the message fail in all three, at the opcode."""
    port_lib = types.SimpleNamespace(Circuit=Circuit, Witness=Witness, opcodes=ops)
    widths = (8,) * 120
    circuit = hash_circuit(port_lib, widths, "keccak_var")
    jcircuit = hash_circuit(JAX_LIB, widths, "keccak_var")
    rng = np.random.default_rng(9)
    sizes = [100, (1 << 128) + 100, 121, (1 << 32) + 5, 120, 0]
    cols = {1 + i: rng.integers(0, 256, size=len(sizes)).astype(object) for i in range(120)}
    cols[121] = np.array(sizes, dtype=object)
    res = BatchSolver(plan_circuit(circuit), device="cpu").solve(cols)
    assert res.ok.tolist() == [True, True, False, False, True, True]
    assert res.fail.tolist() == [int(FAIL_NONE)] * 2 + [0, 0] + [int(FAIL_NONE)] * 2
    assert_equals_sequential(jcircuit, cols, res, range(len(sizes)))
    for b in (0, 1):
        msg = bytes(int(cols[1 + i][b]) for i in range(100))
        assert bytes(res.instance_ints(b)[w] for w in range(122, 154)) == jkeccak256(msg)
    _, jok, jfail = jax_solve(JBatchSolver(jplan_circuit(jcircuit)), cols)
    assert np.asarray(jok).tolist() == [True, False, False, False, True, True]
    assert np.asarray(jfail).tolist()[1] == 0
