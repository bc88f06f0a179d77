"""The port's kernels against their plain versions on the card.

The CPU tests reach only the plain versions; these run the CUDA kernels, so
they carry the ``gpu`` marker and skip where there is no CUDA device.  They
import nothing of JAX:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import hashlib
import types

import numpy as np
import pytest
import torch

from acvm_tpu_torch import build
from acvm_tpu_torch.fields import kernels as fk
from acvm_tpu_torch.fields.params import BLS12_381_FR, BN254_FR
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, intops, plan_circuit
from acvm_tpu_torch.utils import (
    array_inputs,
    brillig_ops_inputs,
    build_array_circuit,
    build_brillig_ops_circuit,
    build_gadget_circuit,
    build_quotient_circuit,
    build_sha256_circuit,
    build_sort_circuit,
    build_u32_circuit,
    build_uint_ops_circuit,
    build_wide_arith_circuit,
    divmod_edge_operands,
    divmod_word_grid,
    gadget_inputs_columnar,
    oracle_affine,
    quotient_edge_inputs,
    random_inputs,
    sha256_inputs,
    sort_inputs,
    u32_inputs,
    with_repeated_constraints,
)
from acvm_tpu_torch.utils.ec_points import exceptional_panel, window_entry_panel

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def elements(n, params, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % params.modulus for _ in range(n)]
    vals[:3] = [0, 1, params.modulus - 1]
    return torch.from_numpy(fk.ints_to_limbs32(vals).copy())


@pytest.mark.parametrize("dyn_fraction", [0.0, 0.5])
def test_solver_on_card_equals_solver_on_cpu(card, dyn_fraction):
    circuit = build_wide_arith_circuit(num_inputs=8, num_levels=3, gates_per_level=64,
                                       dyn_fraction=dyn_fraction)
    inputs = random_inputs(circuit, 100)  # a ragged batch: not a multiple of the block
    inputs[7] = {w: 0 for w in inputs[7]}  # every runtime denominator vanishes
    plan = plan_circuit(circuit)
    build.reset_launches()
    gpu = BatchSolver(plan).solve(inputs)
    wanted = ("level", "mul", "batch_inv", "dot") if dyn_fraction else ("level",)
    assert all(build.LAUNCHES[k] > 0 for k in wanted), build.LAUNCHES
    cpu = BatchSolver(plan, device="cpu").solve(inputs)
    assert torch.equal(gpu.panel.cpu(), cpu.panel)
    assert np.array_equal(gpu.ok, cpu.ok) and np.array_equal(gpu.fail, cpu.fail)
    assert bool(gpu.ok[7]) == (dyn_fraction == 0.0)


@pytest.mark.parametrize("params", [BN254_FR, BLS12_381_FR], ids=lambda p: p.name)
def test_field_kernels_equal_plain_versions(card, params):
    a, b = elements(1000, params, 1), elements(1000, params, 2)
    for reduce in (True, False):
        assert torch.equal(fk.mont_mul(a.to(card), b.to(card), params, reduce=reduce).cpu(),
                           fk.mont_mul_plain(a, b, params, reduce))
    assert torch.equal(fk.mont_mul(a.to(card), b[5].to(card), params).cpu(),
                       fk.mont_mul_plain(a, b[5], params))
    for exponent in (0, 1, 2, 15, 16, 12345, params.modulus - 2, (1 << 256) - 1):
        assert torch.equal(fk.mont_pow(a[:70].to(card), exponent, params).cpu(),
                           fk.mont_pow_plain(a[:70], exponent, params))


@pytest.mark.parametrize("params", [BN254_FR, BLS12_381_FR], ids=lambda p: p.name)
def test_batch_inv_kernel_equals_plain_version(card, params):
    """One lane a chunk of one column: zeros at a chunk's first and last row,
    an all-zero chunk, p - 1, a ragged last chunk, G = 1 and 2, other axes."""
    a = elements(70 * 12, params, 3).reshape(70, 12, 8)
    a[16, 1] = a[31, 1] = a[69, 2] = 0
    a[32:48, 3] = 0
    a[:, 4] = a[0, 2]  # p - 1 down a column
    for axis, x in ((0, a), (1, a.transpose(0, 1)), (-2, a.permute(1, 0, 2))):
        for max_scan in (16, 7, 70, 1):
            got = fk.mont_batch_inv(x.to(card), params, axis, max_scan)
            assert torch.equal(got.cpu(), fk.mont_batch_inv_plain(x, params, axis, max_scan))
    for G in (1, 2):
        assert torch.equal(fk.mont_batch_inv(a[:G].to(card), params, 0, 16).cpu(),
                           fk.mont_batch_inv_plain(a[:G], params, 0, 16))


@pytest.mark.parametrize("params", [BN254_FR, BLS12_381_FR, "secp256k1"], ids=lambda p: getattr(p, "name", p))
def test_batch_inv_tiles_equal_plain_version(card, params):
    """The block geometry at 32, 64 and 256 lanes a block, forced: a tile all
    zeros, G x L not a multiple of the tile (ragged chunks, ragged columns),
    G = 1, L = 1, strided axes, and the wide mode."""
    if params == "secp256k1":
        from acvm_tpu_torch.gpu import ecdsa

        params = ecdsa.curve_fields("secp256k1")[0]
    a = elements(75 * 300, params, 5).reshape(75, 300, 8)
    a[:16, :32] = 0                      # the first tile of 16-row chunks, all zeros
    a[16:32, 40] = a[74, 299] = 0
    for G, L, g in ((75, 300, 16), (75, 300, 7), (75, 33, 75), (1, 300, 4), (75, 1, 16), (1, 1, 1)):
        x = a[:G, :L].contiguous()
        for lanes in (32, 64, 256):
            plan = fk.batch_inv_plan(G, L, g, 132)._replace(lanes=lanes)
            got = fk.batch_inv_launch(x.to(card), params, plan)
            assert torch.equal(got.cpu(), fk.mont_batch_inv_plain(x, params, 0, g)), (G, L, g, lanes)
    got = fk.mont_batch_inv(a.to(card).transpose(0, 1), params, 1, 16)   # a strided view
    assert torch.equal(got.cpu(), fk.mont_batch_inv_plain(a.transpose(0, 1), params, 1, 16))


@pytest.mark.parametrize("t1,t2,with_scale", [(1, 0, False), (0, 1, True), (3, 2, True), (19, 0, False)])
def test_dot_kernel_equals_plain_version(card, t1, t2, with_scale):
    E, B = 5, 70
    p = BN254_FR

    def rand(shape, seed):
        t = elements(int(np.prod(shape)), p, seed).reshape(*shape, 8)
        return t

    lv = rand((E, t1, B), 3) if t1 else None
    lc = rand((E, t1), 4) if t1 else None
    m1 = rand((E, t2, B), 5) if t2 else None
    m2 = rand((E, t2, B), 6) if t2 else None
    mc = rand((E, t2), 7) if t2 else None
    if t1 > 1:
        lc[2, 1] = 0  # a padding term
    qc = rand((E,), 8)
    sc = rand((E,), 9) if with_scale else None
    dev = lambda t: None if t is None else t.to(card)
    got = fk.mont_dot(dev(lv), dev(lc), dev(m1), dev(m2), dev(mc), dev(qc), dev(sc), p)
    assert torch.equal(got.cpu(), fk.mont_dot_plain(lv, lc, m1, m2, mc, qc, sc, p))


def test_level_kernel_equals_plain_version_at_wide_gates(card):
    """Gates of 15-32 linear terms at p - 1 (where a lazy one-chain sum would
    overflow), of 5 and 6, a product term, padding terms and a ragged batch."""
    from acvm_tpu_torch.gpu import fused_level as fl

    p = BN254_FR.modulus
    NW, B, t1, t2 = 60, 70, 32, 1
    panel = elements(NW * B, BN254_FR, 11).reshape(NW, B, 8)
    panel[1:21] = torch.from_numpy(fk.ints_to_limbs32([p - 1] * (20 * B)).copy()).reshape(20, B, 8)
    E = 7
    lin_idx = np.zeros((E, t1), np.int32)
    lin_c = np.zeros((E, t1), dtype=object)
    for g, n in enumerate((15, 18, 19, 32, 2, 5, 6)):
        lin_idx[g, :n] = 1 + np.arange(n) % 20
        lin_c[g, :n] = p - 1
    mul_idx = np.array([[[3, 30]], [[0, 0]], [[31, 32]], [[0, 0]], [[33, 34]], [[0, 0]], [[3, 3]]],
                       np.int32)
    mul_c = np.array([[p - 1], [0], [12345], [0], [p - 2], [0], [p - 1]], dtype=object)
    num = dict(
        lin_idx=lin_idx, mul_idx=mul_idx,
        lin_coeff=fk.ints_to_limbs32(lin_c.reshape(-1)).reshape(E, t1, 8),
        mul_coeff=fk.ints_to_limbs32(mul_c.reshape(-1)).reshape(E, t2, 8),
        qc=fk.ints_to_limbs32([p - 1] * E),
    )
    desc = torch.from_numpy(fl.pack_level_desc(dict(num=num, u_idx=np.arange(40, 40 + E, dtype=np.int32))))
    want = fl.fused_level_plain(panel.clone(), desc, BN254_FR, t1, t2)
    got = fl.fused_level_call(panel.to(card), desc.to(card), BN254_FR, t1, t2)
    assert torch.equal(got.cpu(), want)


def test_pt_add_kernel_equals_plain_version(card):
    """Exceptional pairs and window entries, a ragged batch; the even/odd
    views of one panel, two separate panels, a panel gathered as (N, B, 3, 8),
    and the result written over an operand."""
    from acvm_tpu_torch.gpu import ec, ec_fused

    B = 70
    table = ec._window_table_np(ec.grumpkin.generator(), 4)
    panel = np.concatenate([exceptional_panel(B), window_entry_panel(table, 6, B)])
    P = torch.from_numpy(panel)
    want = ec_fused.pt_add_pairs_plain(P)
    build.reset_launches()
    assert torch.equal(ec_fused.pt_add_pairs(P.to(card)).cpu(), want)
    even, odd = P[0::2].contiguous().to(card), P[1::2].contiguous().to(card)
    assert torch.equal(ec_fused.pt_add_panels(even, odd).cpu(), want)
    gathered = P.permute(0, 2, 1, 3).contiguous().to(card).permute(0, 2, 1, 3)
    assert not gathered.is_contiguous()
    assert torch.equal(ec_fused.pt_add_pairs(gathered).cpu(), want)
    assert ec_fused.pt_add_panels(even, odd, out=even) is even
    assert torch.equal(even.cpu(), want)
    assert build.LAUNCHES["pt_add"] == 4
    doubled = ec_fused.pt_add_panels(odd, odd, out=odd)  # acc + acc of the ladder
    assert torch.equal(doubled.cpu(), ec_fused.pt_add_panels_plain(P[1::2], P[1::2]))
    whole = P.to(card)
    with pytest.raises(ValueError, match="overlaps"):
        ec_fused.pt_add_panels(whole[0::2], whole[1::2], out=whole[:4])


def test_pt_ladder_kernel_equals_plain_version(card):
    """One launch of the ladder kernel against the 512 additions of its plain
    version: X, Y and Z equal on edge scalars (0, 1, 2, n - 1, n, n + 1,
    2^256 - 1), bases with Z = 1, a random Z and at infinity, a ragged batch."""
    from acvm_tpu_torch.fields.torch_ops import LimbContext
    from acvm_tpu_torch.gpu import ec, ec_fused

    n = ec.grumpkin.params.n
    B = 70
    edge = [0, 1, 2, n - 1, n, n + 1, (1 << 256) - 1]
    rng = np.random.default_rng(13)
    scalars = edge * 3 + [int.from_bytes(rng.bytes(32), "little") for _ in range(B - 3 * len(edge))]
    panel = exceptional_panel(9 * len(edge))  # lane b: case b % 9
    lanes = [9 * i + case for case in (0, 1, 6) for i in range(len(edge))]  # generic, generic_z, p_infinity
    base = np.concatenate([panel[0][:, lanes], exceptional_panel(B - len(lanes))[1]], axis=1)
    ctx = LimbContext(BN254_FR, card)
    point = tuple(torch.from_numpy(c.copy()).to(card) for c in base)
    k = torch.from_numpy(fk.ints_to_limbs32(scalars).copy()).to(card)
    build.reset_launches()
    got = ec_fused.scalar_mul_fused(ctx, point, k)
    assert build.LAUNCHES["pt_ladder"] == 1 and build.LAUNCHES["pt_add"] == 0
    want = ec_fused.scalar_mul_fused_plain(ctx, point, k)
    assert build.LAUNCHES["pt_add"] == 512
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ec.pt_is_inf(got)[:2 * len(edge) : len(edge)].all()  # 0 * P


def ladder_lanes(B, seed):
    """Scalars and bases for the ladder's team geometry (8 instances a warp):
    lanes 0-7, one warp, take different branches (0, 1, n and n + 1 on a
    generic base, a base at infinity, P = Q at another Z, a 2^256 - 1
    scalar, 28 leading zero bits), the rest random scalars on random bases."""
    from acvm_tpu_torch.gpu import ec

    n = ec.grumpkin.params.n
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(B)]
    scalars[:8] = [0, 1, n, n + 1, 12345, n + 1, (1 << 256) - 1, 0x0FFFFFFF << 200][: min(B, 8)]
    panel = exceptional_panel(max(B, 9), seed)  # lane b: case b % 9
    cases = [0, 0, 0, 0, 6, 1, 1, 0]            # generic, generic_z, p_infinity (at infinity)
    base = panel[0][:, :B].copy()
    base[:, :8] = panel[0][:, cases[: min(B, 8)]]
    base[:, 8:][:, np.arange(8, B) % 9 == 6] = panel[1][:, 0:1]  # no more bases at infinity
    return scalars, base


@pytest.mark.parametrize("B", [1, 3, 33, 2050])
def test_pt_ladder_team_geometry_equals_plain_version(card, B):
    """Four threads an instance, eight a warp: a batch of one, a ragged
    team, a ragged warp past the first, 2,050 lanes (257 warps); the first
    warp's teams take different branches."""
    from acvm_tpu_torch.fields.torch_ops import LimbContext
    from acvm_tpu_torch.gpu import ec_fused

    scalars, base = ladder_lanes(B, 17 + B)
    ctx = LimbContext(BN254_FR, card)
    point = tuple(torch.from_numpy(c.copy()).to(card) for c in base)
    k = torch.from_numpy(fk.ints_to_limbs32(scalars).copy()).to(card)
    build.reset_launches()
    got = ec_fused.scalar_mul_fused(ctx, point, k)
    assert build.LAUNCHES["pt_ladder"] == 1
    want = ec_fused.scalar_mul_fused_plain(ctx, point, k)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_pt_ladder_every_base_at_infinity_and_schnorr_shape(card):
    """Every base at infinity (junk in X, Y): every lane is infinity, as the
    plain version has it; then the Schnorr path's own shape, affine bases
    with Z = R and scalars uniform below n."""
    import random

    from acvm_tpu_torch.fields.torch_ops import LimbContext
    from acvm_tpu_torch.gpu import ec, ec_fused
    from acvm_tpu_torch.utils.ec_points import mont_jacobian

    n = ec.grumpkin.params.n
    ctx = LimbContext(BN254_FR, card)
    rnd = random.Random(23)
    B = 33
    base = np.stack([mont_jacobian(None, 0, (rnd.randrange(BN254_FR.modulus), 7)) for _ in range(B)], axis=1)
    point = tuple(torch.from_numpy(c.copy()).to(card) for c in base)
    k = torch.from_numpy(fk.ints_to_limbs32([rnd.randrange(1 << 256) for _ in range(B)]).copy()).to(card)
    got = ec_fused.scalar_mul_fused(ctx, point, k)
    assert all(torch.equal(g, w) for g, w in zip(got, ec_fused.scalar_mul_fused_plain(ctx, point, k)))
    assert ec.pt_is_inf(got).all()
    B = 64
    keys = [ec.grumpkin.mul_g(rnd.randrange(1, n)) for _ in range(B)]
    base = np.stack([mont_jacobian(key, 1) for key in keys], axis=1)
    point = tuple(torch.from_numpy(c.copy()).to(card) for c in base)
    k = torch.from_numpy(fk.ints_to_limbs32([rnd.randrange(n) for _ in range(B)]).copy()).to(card)
    got = ec_fused.scalar_mul_fused(ctx, point, k)
    assert all(torch.equal(g, w) for g, w in zip(got, ec_fused.scalar_mul_fused_plain(ctx, point, k)))


@pytest.mark.parametrize("t,with_scale", [(1, False), (3, True), (32, False)])
def test_v1_kernels_equal_plain_versions(card, t, with_scale):
    E, B = 5, 70
    p = BN254_FR
    vals = elements(E * t * B, p, 3).reshape(E, t, B, 8)
    coeff = elements(E * t, p, 4).reshape(E, t, 8)
    if t > 1:
        coeff[2, 1] = 0  # a padding term
    qc = elements(E, p, 8)
    sc = elements(E, p, 9) if with_scale else None
    build.reset_launches()
    got = fk.mont_dot_v1(vals.to(card), coeff.to(card), qc.to(card),
                         None if sc is None else sc.to(card), p)
    assert torch.equal(got.cpu(), fk.mont_dot_v1_plain(vals, coeff, qc, sc, p))
    a, b = elements(1000, p, 1), elements(1000, p, 2)
    assert torch.equal(fk.mont_mul_v1(a.to(card), b.to(card)).cpu(), fk.mont_mul_v1_plain(a, b))
    assert torch.equal(fk.mont_mul_v1(a.to(card), b[5].to(card)).cpu(),
                       fk.mont_mul_v1_plain(a, b[5]))
    assert torch.equal(fk.mont_mul_v1(a.to(card), b.to(card)).cpu(), fk.mont_mul(a.to(card), b.to(card), p).cpu())
    assert build.LAUNCHES["dot_v1"] == 1 and build.LAUNCHES["mul_v1"] == 3


@pytest.mark.parametrize("kind,batch", [("fixed_base", 70), ("pedersen", 70), ("schnorr", 3)])
def test_gadget_solver_on_card_equals_solver_on_cpu(card, kind, batch):
    circuit = build_gadget_circuit(kind, 2, msg_len=10)
    cols = gadget_inputs_columnar(circuit, batch, kind)
    if kind == "schnorr":  # one forged signature
        w = int(circuit.opcodes[1].call.signature[5].witness)
        cols[w] = cols[w].copy()
        cols[w][1] ^= 1
    if kind == "fixed_base":  # one scalar limb past 2^128
        w = int(circuit.opcodes[0].call.high.witness)
        cols[w] = cols[w].astype(object)
        cols[w][2] = 1 << 130
    plan = plan_circuit(circuit)
    build.reset_launches()
    gpu = BatchSolver(plan).solve(cols)
    assert build.LAUNCHES["pt_add"] > 0, build.LAUNCHES
    assert build.LAUNCHES["pt_ladder"] == (1 if kind == "schnorr" else 0), build.LAUNCHES
    cpu = BatchSolver(plan, device="cpu").solve(cols)
    assert torch.equal(gpu.panel.cpu(), cpu.panel)
    assert np.array_equal(gpu.ok, cpu.ok) and np.array_equal(gpu.fail, cpu.fail)
    assert gpu.ok.all() == (kind != "fixed_base")


def test_dot_kernel_v1_route_on_card_equals_v2(card):
    circuit = with_repeated_constraints(
        build_wide_arith_circuit(num_inputs=8, num_levels=3, gates_per_level=64, dyn_fraction=0.5),
        20)
    inputs = random_inputs(circuit, 100)
    plan = plan_circuit(circuit)
    v2 = BatchSolver(plan).solve(inputs)
    assert v2.ok.all()
    build.reset_launches()
    v1 = BatchSolver(plan, dot_kernel="v1").solve(inputs)
    assert build.LAUNCHES["dot_v1"] > 0 and build.LAUNCHES["mul_v1"] > 0
    assert build.LAUNCHES["dot"] == 0, build.LAUNCHES
    assert torch.equal(v1.panel, v2.panel) and np.array_equal(v1.fail, v2.fail)


@pytest.mark.parametrize("num_bits", [256, 254, 128, 64, 32, 8])
def test_divmod_kernel_equals_plain_version_and_ints(card, num_bits):
    ea, eb = divmod_edge_operands(BN254_FR.modulus)
    ga, gb = divmod_word_grid(16)
    a, b = ea + ga, eb + gb
    ta = torch.from_numpy(fk.ints_to_limbs32(a).copy()).to(card)
    tb = torch.from_numpy(fk.ints_to_limbs32(b).copy()).to(card)
    build.reset_launches()
    q, r = intops.long_divmod(ta, tb, num_bits=num_bits)
    assert build.LAUNCHES["divmod"] == 1
    pq, pr = intops.long_divmod_plain(ta, tb, num_bits=num_bits)
    assert torch.equal(q, pq) and torch.equal(r, pr)
    m = (1 << num_bits) - 1
    want = [divmod(x & m, y) if y else (0, 0) for x, y in zip(a, b)]
    assert list(zip(fk.limbs32_to_ints(q.cpu().numpy()), fk.limbs32_to_ints(r.cpu().numpy()))) == want
    # a broadcast divisor, as a Quotient level by a constant gives it
    q2, r2 = intops.long_divmod(ta.reshape(-1, 1, 8), tb[:1])
    assert torch.equal(q2, intops.long_divmod_plain(ta.reshape(-1, 1, 8), tb[:1])[0])


def test_integer_solver_on_card_equals_solver_on_cpu(card):
    circuit = build_u32_circuit(num_inputs=16, num_rounds=2, units_per_round=64)
    inputs = u32_inputs(circuit, 100)
    inputs[7][3] = (1 << 32) + 5  # fails its Range, opcode 2
    plan = plan_circuit(circuit)
    build.reset_launches()
    intops.PLAIN_ON_CARD["long_divmod"] = 0
    gpu = BatchSolver(plan).solve(inputs)
    assert build.LAUNCHES["divmod"] == 2 and intops.PLAIN_ON_CARD["long_divmod"] == 0
    cpu = BatchSolver(plan, device="cpu").solve(inputs)
    assert torch.equal(gpu.panel.cpu(), cpu.panel)
    assert np.array_equal(gpu.ok, cpu.ok) and np.array_equal(gpu.fail, cpu.fail)
    assert int(gpu.fail[7]) == 2 and gpu.ok.sum() == 99
    # Quotient under a predicate, over compound expressions, at its edges
    plan = plan_circuit(build_quotient_circuit())
    inputs = quotient_edge_inputs(BN254_FR.modulus)
    build.reset_launches()
    gpu = BatchSolver(plan).solve(inputs)
    assert build.LAUNCHES["divmod"] == 1 and intops.PLAIN_ON_CARD["long_divmod"] == 0
    cpu = BatchSolver(plan, device="cpu").solve(inputs)
    assert torch.equal(gpu.panel.cpu(), cpu.panel) and gpu.ok.all() and cpu.ok.all()


def test_brillig_and_memory_solver_on_card_equals_solver_on_cpu(card):
    """Straight-line Brillig blocks (every op on edge values, the stdlib's
    UIntGadget) and memory blocks (the array circuit with a failing
    instance): panel, flags and memory blocks equal to the CPU solve."""
    array = build_array_circuit(num_blocks=3, block_size=16, rounds=4, final_reads=2, num_seeds=4)
    uint, _ = build_uint_ops_circuit()
    cases = [(build_brillig_ops_circuit(), brillig_ops_inputs(256)),
             (array, array_inputs(array, 100, fail_instance=7)[0]),
             (uint, [{1: x, 2: y} for x, y in ((5, 3), (0xFFFFFFFF, 2), (7, 0), (0, 1))])]
    build.reset_launches()
    intops.PLAIN_ON_CARD["long_divmod"] = 0
    for circuit, inputs in cases:
        plan = plan_circuit(circuit)
        gpu = BatchSolver(plan).solve(inputs)
        cpu = BatchSolver(plan, device="cpu").solve(inputs)
        assert torch.equal(gpu.panel.cpu(), cpu.panel)
        assert np.array_equal(gpu.ok, cpu.ok) and np.array_equal(gpu.fail, cpu.fail)
        blocks = cpu.memory_blocks()
        assert all(torch.equal(v.cpu(), blocks[k]) for k, v in gpu.memory_blocks().items())
    assert intops.PLAIN_ON_CARD["long_divmod"] == 0
    assert all(build.LAUNCHES[k] > 0 for k in ("dot", "divmod", "pow", "mul", "level")), build.LAUNCHES


def test_sha256_fallback_on_card_equals_hashlib(card):
    circuit, B = build_sha256_circuit(32), 64
    cols = sha256_inputs(B)
    intops.PLAIN_ON_CARD["long_divmod"] = 0
    res = BatchSolver(plan_circuit(circuit)).solve(cols)
    assert res.ok.all() and intops.PLAIN_ON_CARD["long_divmod"] == 0
    digests = [res.witness_ints(33 + i) for i in range(32)]
    for b in range(B):
        message = bytes(int(cols[i + 1][b]) for i in range(32))
        assert bytes(d[b] for d in digests) == hashlib.sha256(message).digest(), b


@pytest.mark.parametrize("host_batch", [True, False])
def test_host_stages_on_card_equal_solver_on_cpu(card, host_batch):
    """The sorting circuit at n = 16 over 64 instances, one failing a key's
    Range: device segments around the sort, the decimal radix and the oracle
    block; panel and flags equal to the CPU solve, the sorted keys to
    Python's."""
    circuit = build_sort_circuit(16)
    cols, fail_op = sort_inputs(circuit, 64, fail_instance=9)
    plan = plan_circuit(circuit)
    build.reset_launches()
    gpu = BatchSolver(plan, foreign_call_handler=oracle_affine, host_batch=host_batch).solve(cols)
    assert build.LAUNCHES["level"] > 0 and build.LAUNCHES["dot"] > 0, build.LAUNCHES
    cpu = BatchSolver(plan, foreign_call_handler=oracle_affine, device="cpu").solve(cols)
    assert np.array_equal(gpu.ok, cpu.ok) and np.array_equal(gpu.fail, cpu.fail)
    assert gpu.fail.tolist() == [fail_op if b == 9 else int(FAIL_NONE) for b in range(64)]
    if host_batch:
        assert torch.equal(gpu.panel.cpu(), cpu.panel)
    answer = circuit.current_witness_index
    total = [sum(int(cols[1 + i][b]) for i in range(16)) for b in range(64)]
    assert gpu.witness_ints(answer) == [(3 * t + 1) % BN254_FR.modulus for t in total]


def test_device_resident_byte_columns(card):
    """uint8 and uint16 columns on the card, columnar and as a packed
    matrix, give the host columns' panel on the SHA-256 fallback."""
    circuit, B = build_sha256_circuit(32), 64
    cols = sha256_inputs(B)
    solver = BatchSolver(plan_circuit(circuit))
    want = solver.solve(cols)
    for dtype in (np.uint8, np.uint16):
        dev_cols = {w: torch.from_numpy(a.astype(dtype)).to(card) for w, a in cols.items()}
        got = solver.solve(dev_cols)
        assert torch.equal(got.panel, want.panel) and np.array_equal(got.ok, want.ok)
        order = sorted(cols, reverse=True)
        matrix = np.stack([cols[w].astype(dtype) for w in order], axis=1)
        assert torch.equal(solver.solve((order, torch.from_numpy(matrix).to(card))).panel, want.panel)
        assert torch.equal(solver.solve((order, matrix)).panel, want.panel)
    with pytest.raises(ValueError, match="solver's device"):
        solver.solve({w: torch.from_numpy(a) for w, a in cols.items()})  # on the host


def vm_blocks():
    """(block, columns, batch) for every block of the VM circuits and the
    Brillig-ops circuit, then the three state tiers at ragged batches: the
    sort (registers and memory on chip) on 77 instances, the binary search
    over 256 words (its memory in device memory) on 100, and a register file
    of 300 rows (all in device memory) on 33, its instance 3 past the step
    budget."""
    from acvm_tpu_torch.utils import (
        brillig_vm_circuit_roles, brillig_vm_edge_inputs, brillig_vm_inputs,
        build_brillig_vm_circuit, build_brillig_vm_edges_circuit,
        build_brillig_vm_wide_registers_circuit,
    )

    circuit = build_brillig_vm_circuit(16)
    cols, _ = brillig_vm_inputs(circuit, 512)
    cols = dict(cols)
    cols[brillig_vm_circuit_roles(16)["total"][0]] = sum(cols[1 + i].astype(object) for i in range(16))
    blocks = [(circuit.opcodes[i].brillig, cols, 512) for i in brillig_vm_circuit_roles(16)["blocks"]]
    edge_cols, _, _ = brillig_vm_edge_inputs(512, escape_instance=3)
    blocks += [(op.brillig, edge_cols, 512) for op in build_brillig_vm_edges_circuit().opcodes]
    ops_cols = brillig_ops_inputs(256)
    blocks += [(op.brillig, ops_cols, 256) for op in build_brillig_ops_circuit().opcodes]
    sort = circuit.opcodes[brillig_vm_circuit_roles(16)["blocks"][0]].brillig
    wide_cols, _, _ = brillig_vm_edge_inputs(100, array=256)
    return blocks + [
        (sort, cols, 77),
        (build_brillig_vm_edges_circuit(array=256).opcodes[1].brillig, wide_cols, 100),
        (build_brillig_vm_wide_registers_circuit().opcodes[0].brillig, edge_cols, 33),
    ]


def test_brillig_vm_kernel_equals_plain_version(card):
    """Every block of the VM circuits (an escape by the step budget among
    them), every Brillig op at 1-256 bits and the three state tiers at ragged
    batches: registers, memory, status and steps of the kernel equal the
    plain version's on the card."""
    from acvm_tpu_torch.gpu import brillig_vm_device as bvm

    build.reset_launches()
    blocks = vm_blocks()
    tiers = set()
    for k, (brillig, cols, batch) in enumerate(blocks):
        get = lambda w: np.asarray(cols[int(w)][:batch]).astype(object)  # noqa: E731
        program, regs, mem = bvm.initial_state(brillig, get, batch, BN254_FR.modulus, card)
        plan = bvm.vm_plan_for(program, regs, mem)
        tiers.add((plan.regs_on_chip, plan.mem_on_chip))
        budget = bvm.step_budget(program.n_pc)
        regs_p, mem_p = regs.clone(), mem.clone()
        status, steps = bvm.run_vm(program, regs, mem, budget)
        status_p, steps_p = bvm.run_vm_plain(program, regs_p, mem_p, budget)
        assert torch.equal(regs, regs_p) and torch.equal(mem, mem_p), k
        assert torch.equal(status, status_p) and torch.equal(steps, steps_p), k
    assert build.LAUNCHES["brillig_vm"] == len(blocks)
    assert tiers == {(True, True), (True, False), (False, False)}


def test_brillig_vm_solver_on_card_equals_solver_on_cpu(card):
    """The program with unconstrained loops over 256 instances: three
    brillig_vm launches, no per-instance stage, panel and flags equal to
    the CPU solve."""
    from acvm_tpu_torch.utils import brillig_vm_inputs, build_brillig_vm_circuit
    from acvm_tpu_torch.utils.profiling import SolveStats

    circuit = build_brillig_vm_circuit(16)
    cols, fails = brillig_vm_inputs(circuit, 256)
    plan = plan_circuit(circuit)
    build.reset_launches()
    stats = SolveStats()
    gpu = BatchSolver(plan).solve(cols, stats=stats)
    assert build.LAUNCHES["brillig_vm"] == 3 and stats.host_per_instance_stages == 0
    cpu = BatchSolver(plan, device="cpu").solve(cols)
    assert torch.equal(gpu.panel.cpu(), cpu.panel)
    assert np.array_equal(gpu.ok, cpu.ok) and np.array_equal(gpu.fail, cpu.fail)
    assert gpu.fail.tolist() == [fails.get(b, int(FAIL_NONE)) for b in range(256)]


@pytest.mark.parametrize("M", [0, 1, 32, 55, 56, 64, 65, 119, 120, 135, 136, 137, 232, 272])
def test_hash_kernels_equal_plain_versions(card, M):
    """Each digest kernel on a (B, M) byte matrix against its plain version
    and the host hashes; keccak's var form over lengths 0 ... M."""
    from acvm_tpu_torch.blackbox.hashes import keccak256
    from acvm_tpu_torch.gpu import gadgets

    B = 300  # a ragged batch: not a multiple of the block
    msg = torch.from_numpy(np.random.default_rng(M).integers(0, 256, size=(B, M))).to(card)
    build.reset_launches()
    for fn, plain, host in ((gadgets.sha256_digest, gadgets.sha256_digest_plain, hashlib.sha256),
                            (gadgets.blake2s_digest, gadgets.blake2s_digest_plain, hashlib.blake2s),
                            (gadgets.keccak256_digest, gadgets.keccak256_digest_plain, None)):
        got = fn(msg)
        assert torch.equal(got, plain(msg)), fn.__name__
        host = host or (lambda m: types.SimpleNamespace(digest=lambda: keccak256(m)))
        for b in (0, B - 1):
            assert bytes(got[b].tolist()) == host(bytes(msg[b].tolist())).digest(), fn.__name__
    length = torch.from_numpy(np.random.default_rng(M + 1).integers(0, M + 1, size=B)).to(card)
    length[:2] = torch.tensor([0, M])
    got = gadgets.keccak256_var_digest(msg, length)
    assert torch.equal(got, gadgets.keccak256_var_digest_plain(msg, length))
    assert bytes(got[7].tolist()) == keccak256(bytes(msg[7, :int(length[7])].tolist()))
    assert (build.LAUNCHES["sha256"], build.LAUNCHES["blake2s"], build.LAUNCHES["keccak"]) == (1, 1, 2)


def test_keccak_var_length_past_the_message_raises_before_launch(card):
    """A length of M + 1 on the card raises, in both wrappers, and launches
    no kernel that would read past the message."""
    from acvm_tpu_torch.gpu import gadgets

    M = 232
    msg = torch.zeros((4, M), dtype=torch.int32, device=card)
    length = torch.tensor([0, 1, M, M + 1], dtype=torch.int32, device=card)
    build.reset_launches()
    with pytest.raises(ValueError, match="lengths must lie in"):
        gadgets.keccak256_var_digest(msg, length)
    W = torch.zeros((M + 40, 4, 8), dtype=torch.int32, device=card)
    tables = [torch.zeros((1, M), dtype=torch.int32, device=card) for _ in range(3)]
    out_idx = torch.arange(M, M + 32, dtype=torch.int32, device=card).reshape(1, 32)
    with pytest.raises(ValueError, match="lengths must lie in"):
        gadgets.hash_rows("keccak_var", W, *tables, out_idx, length=length.reshape(1, 4))
    assert build.LAUNCHES["keccak"] == 0


@pytest.mark.parametrize("params", [BN254_FR, BLS12_381_FR], ids=lambda p: p.name)
def test_hash_rows_kernels_equal_plain_versions(card, params):
    """Each kernel off a panel, through random (row, limb, shift) tables,
    against hash_rows_plain: every kind, hash-to-field in both fields."""
    from acvm_tpu_torch.gpu import gadgets

    rng = np.random.default_rng(11)
    NW, B, G = 140, 333, 3
    for kind, M, n_out in (("sha256", 64, 32), ("blake2s", 33, 32), ("keccak256", 140, 32),
                           ("keccak_var", 232, 32), ("hash_to_field", 64, 1)):
        W = torch.from_numpy(rng.integers(-2**31, 2**31, size=(NW, B, 8)).astype(np.int32))
        tables = [torch.from_numpy(t.astype(np.int32)) for t in (
            rng.integers(0, 30, size=(G, M)), rng.integers(0, 8, size=(G, M)),
            8 * rng.integers(0, 4, size=(G, M)))]
        out_idx = torch.from_numpy(rng.permutation(np.arange(30, NW))[:G * n_out].reshape(G, n_out)
                                   .astype(np.int32))
        length = (torch.from_numpy(rng.integers(0, M + 1, size=(G, B)).astype(np.int32))
                  if kind == "keccak_var" else None)
        modulus = params.modulus if kind == "hash_to_field" else None
        want = gadgets.hash_rows_plain(kind, W.clone(), *tables, out_idx, length, modulus)
        on_card = [t.to(card) for t in (W, *tables, out_idx)]
        got = gadgets.hash_rows(kind, *on_card, length=None if length is None else length.to(card),
                                modulus=modulus)
        assert torch.equal(got.cpu(), want), kind


def test_hash_solver_on_card_equals_solver_on_cpu(card):
    """The membership program (depth 2) over 70 instances, three of them at
    the edges (a path bit of 2, memo_len 233, memo_len 2^128 + 100), and the
    gadget circuits: one hash launch a group, no plain digest, panel and
    flags equal to the CPU solve."""
    from acvm_tpu_torch.gpu import gadgets
    from acvm_tpu_torch.utils import (build_membership_circuit, membership_circuit_roles,
                                      membership_inputs)

    circuit, roles = build_membership_circuit(2), membership_circuit_roles(2)
    cols = {w: a.astype(object) for w, a in membership_inputs(circuit, 70).items()}
    cols[roles["bits"][0]][1] = 2
    cols[roles["memo_len"][0]][2] = 233
    cols[roles["memo_len"][0]][3] = (1 << 128) + 100
    cases = [(circuit, cols, {"blake2s": 2, "sha256": 2, "keccak": 2})]
    for kind, name in (("sha256", "sha256"), ("blake2s", "blake2s"), ("keccak256", "keccak")):
        gadget = build_gadget_circuit(kind, 3, 64)
        cases.append((gadget, gadget_inputs_columnar(gadget, 70, kind), {name: 1}))
    for circ, inputs, launches in cases:
        plan = plan_circuit(circ)
        build.reset_launches()
        for k in gadgets.PLAIN_ON_CARD:
            gadgets.PLAIN_ON_CARD[k] = 0
        gpu = BatchSolver(plan).solve(inputs)
        assert {k: build.LAUNCHES[k] for k in launches} == launches, build.LAUNCHES
        assert not any(gadgets.PLAIN_ON_CARD.values()), gadgets.PLAIN_ON_CARD
        cpu = BatchSolver(plan, device="cpu").solve(inputs)
        assert torch.equal(gpu.panel.cpu(), cpu.panel)
        assert np.array_equal(gpu.ok, cpu.ok) and np.array_equal(gpu.fail, cpu.fail)
    assert gpu is not None and cpu.ok.all()


# The message stage of sha256.cu, blake2s.cu and keccak.cu (csrc/hash.cuh): one-warp
# blocks, the tables in shared memory (whole up to 1,024 bytes, staged a
# block at a time past it: M = 1,500), each compression block's words copied
# by cp.async into a two-stage ring (it wraps from three blocks on), zero-filled
# past a keccak_var length.
STAGED_CASES = ([("sha256", M) for M in (1, 55, 56, 63, 64, 119, 120, 1000, 1500)]
                + [("keccak", M) for M in (1, 135, 136, 137, 272, 1000, 1500)]
                + [("blake2s", M) for M in (0, 1, 32, 55, 56, 63, 64, 65, 127, 128, 129, 1000, 1500)])


def _var_lengths(B, M, seed):
    """keccak_var lengths 0 ... M, the padding's edges first."""
    edges = [v for v in (0, 1, 135, 136, 137, M) if v <= M]
    length = np.random.default_rng(seed).integers(0, M + 1, size=B)
    length[:min(B, len(edges))] = edges[:B]
    return torch.from_numpy(length.astype(np.int32))


@pytest.mark.parametrize("kernel,M", STAGED_CASES, ids=lambda v: str(v))
def test_staged_hash_kernels_equal_plain_versions_and_host_hashes(card, kernel, M):
    """The matrix form at B = 1, 31, 33 and 8,192 (a ragged last block, one
    block, a full card) against the plain version (tolerance 0) and hashlib /
    the host Keccak; the panel form through hash_rows at G = 3 x B = 5 and
    G = 1 x B = 33 against hash_rows_plain."""
    from acvm_tpu_torch.blackbox.hashes import keccak256
    from acvm_tpu_torch.gpu import gadgets

    host = {"sha256": hashlib.sha256, "blake2s": hashlib.blake2s}.get(kernel) or (
        lambda m: types.SimpleNamespace(digest=lambda: keccak256(m)))
    kinds = {"sha256": ("sha256",), "blake2s": ("blake2s", "hash_to_field")}.get(
        kernel, ("keccak256", "keccak_var"))
    build.reset_launches()
    for B in (1, 31, 33, 8192):
        msg = torch.from_numpy(np.random.default_rng(M + B).integers(0, 256, size=(B, M))).to(card)
        if kernel in ("sha256", "blake2s"):
            digest, plain = ((gadgets.sha256_digest, gadgets.sha256_digest_plain) if kernel == "sha256"
                             else (gadgets.blake2s_digest, gadgets.blake2s_digest_plain))
            got = digest(msg)
            assert torch.equal(got, plain(msg)), B
            for b in (0, B - 1):
                assert bytes(got[b].tolist()) == host(bytes(msg[b].tolist())).digest(), (B, b)
            continue
        got = gadgets.keccak256_digest(msg)
        assert torch.equal(got, gadgets.keccak256_digest_plain(msg)), B
        assert bytes(got[B - 1].tolist()) == keccak256(bytes(msg[B - 1].tolist()))
        length = _var_lengths(B, M, M + B).to(card)
        got = gadgets.keccak256_var_digest(msg, length)
        assert torch.equal(got, gadgets.keccak256_var_digest_plain(msg, length)), B
        for b in range(min(B, 7)):
            assert bytes(got[b].tolist()) == keccak256(bytes(msg[b, :int(length[b])].tolist())), (B, b)
    rng = np.random.default_rng(M)
    for kind in kinds:
        n_out = 1 if kind == "hash_to_field" else 32
        modulus = BN254_FR.modulus if kind == "hash_to_field" else None
        for G, B in ((3, 5), (1, 33)):
            NW = 30 + n_out * G
            W = torch.from_numpy(rng.integers(-2**31, 2**31, size=(NW, B, 8)).astype(np.int32))
            tables = [torch.from_numpy(t.astype(np.int32)) for t in (
                rng.integers(0, 30, size=(G, M)), rng.integers(0, 8, size=(G, M)),
                8 * rng.integers(0, 4, size=(G, M)))]
            out_idx = torch.from_numpy((30 + rng.permutation(n_out * G)).reshape(G, n_out).astype(np.int32))
            length = (torch.stack([_var_lengths(B, M, M + g) for g in range(G)])
                      if kind == "keccak_var" else None)
            want = gadgets.hash_rows_plain(kind, W.clone(), *tables, out_idx, length, modulus)
            got = gadgets.hash_rows(kind, *(t.to(card) for t in (W, *tables, out_idx)),
                                    length=None if length is None else length.to(card), modulus=modulus)
            assert torch.equal(got.cpu(), want), (kind, G, B)
    launches = {"sha256": 4 + 2, "blake2s": 4 + 2 * 2, "keccak": 2 * 4 + 2 * 2}
    assert build.LAUNCHES[kernel] == launches[kernel], build.LAUNCHES


def test_staged_hash_kernels_on_the_membership_groups(card):
    """The membership program (depth 4) over 8,192 instances solved on the
    card, then every hash group of its plan again through hash_rows and
    hash_rows_plain on the solved panel: equal, tolerance 0 (sha256 at
    1 x 8,192 x 64, keccak_var at 232 bytes with the path's own lengths,
    keccak256 of 64 bytes, and blake2s's two groups beside them)."""
    from acvm_tpu_torch.gpu import gadgets
    from acvm_tpu_torch.utils import build_membership_circuit, membership_inputs

    circuit = build_membership_circuit(4)
    solver = BatchSolver(plan_circuit(circuit), device=card)
    res = solver.solve(membership_inputs(circuit, 8192))
    assert res.ok.all()
    W = res.panel
    P = BN254_FR.modulus
    groups = [g for seg in solver.segments for lv in seg.levels for g in lv.get("hashes", [])]
    assert sorted({g["kind"] for g in groups}) == [
        "blake2s", "hash_to_field", "keccak256", "keccak_var", "sha256"]
    for g in groups:
        kind = g["kind"]
        tables = (g["src_w"], g["src_limb"], g["src_shift"], g["out_idx"])
        length = None
        if kind == "keccak_var":
            size = W.index_select(0, g["size_w"])[..., 0].to(torch.int64) & 0xFFFFFFFF
            length = size.clamp(max=g["src_w"].shape[1]).to(torch.int32)
        modulus = P if kind == "hash_to_field" else None
        got = gadgets.hash_rows(kind, W.clone(), *tables, length=length, modulus=modulus)
        want = gadgets.hash_rows_plain(kind, W.clone(), *tables, length, modulus)
        assert torch.equal(got, want), kind
        assert torch.equal(got, W), kind  # the solve wrote the same rows


# ---------------------------------------------------------------------------
# The wide field and ECDSA (secp256k1, secp256r1)
# ---------------------------------------------------------------------------

WIDE_FIELDS = [(curve, i) for curve in ("secp256k1", "secp256r1") for i in (0, 1)]


@pytest.mark.parametrize("curve,which", WIDE_FIELDS, ids=lambda v: str(v))
def test_wide_field_kernels_equal_plain_versions(card, curve, which):
    """mul_wide (b any 256-bit value, and broadcast), pow_wide on the
    exponents the schedule treats apart, batch_inv_wide on zeros at chunk
    edges and a ragged last chunk: each against its plain version."""
    from acvm_tpu_torch.gpu import ecdsa

    params = ecdsa.curve_fields(curve)[which]
    a, b = elements(1000, params, 1), elements(1000, params, 2)
    b[7:20] = -1  # 2^256 - 1 in every limb
    build.reset_launches()
    assert torch.equal(fk.mont_mul(a.to(card), b.to(card), params).cpu(), fk.mont_mul_plain(a, b, params))
    assert torch.equal(fk.mont_mul(a.to(card), b[5].to(card), params).cpu(),
                       fk.mont_mul_plain(a, b[5], params))
    for exponent in (0, 1, 2, 15, 16, 12345, params.modulus - 2, (1 << 256) - 1):
        assert torch.equal(fk.mont_pow(a[:70].to(card), exponent, params).cpu(),
                           fk.mont_pow_plain(a[:70], exponent, params))
    x = a[:70 * 12].reshape(70, 12, 8).clone()
    x[16, 1] = x[31, 1] = x[69, 2] = 0
    x[32:48, 3] = 0
    for max_scan in (16, 7, 1):
        assert torch.equal(fk.mont_batch_inv(x.to(card), params, 0, max_scan).cpu(),
                           fk.mont_batch_inv_plain(x, params, 0, max_scan))
    assert build.LAUNCHES["mul_wide"] == 2 and build.LAUNCHES["pow_wide"] == 8
    assert build.LAUNCHES["batch_inv_wide"] == 3 and build.LAUNCHES["mul"] == build.LAUNCHES["pow"] == 0


@pytest.mark.parametrize("curve,which", WIDE_FIELDS, ids=lambda v: str(v))
def test_inv_wide_kernel_equals_plain_version_and_pow_wide(card, curve, which):
    """inv_wide (constant-time divsteps) against its plain version, pow_wide
    at e = M - 2 and Python ints: the edge lanes 0, R, M - 1, 1, 2, R^-1 and
    the longest divstep run of 300 draws first, a ragged count; one launch,
    no pow_wide, and LimbContext's mont_inv on the card the same."""
    from acvm_tpu_torch.fields.torch_ops import LimbContext
    from acvm_tpu_torch.gpu import ecdsa

    params = ecdsa.curve_fields(curve)[which]
    m, R = params.modulus, params.r
    rng = np.random.default_rng(19)
    pool = [int.from_bytes(rng.bytes(40), "little") % m for _ in range(300)]
    edges = [0, R, m - 1, 1, 2, pow(R, -1, m), max(pool, key=lambda x: fk.divsteps_to_zero(x, m))]
    a = elements(1000, params, 3)
    a[: len(edges)] = torch.from_numpy(fk.ints_to_limbs32(edges).copy())
    build.reset_launches()
    got = fk.mont_inv(a.to(card), params)
    assert build.LAUNCHES["inv_wide"] == 1 and build.LAUNCHES["pow_wide"] == 0
    assert torch.equal(got.cpu(), fk.mont_inv_divsteps_plain(a, params))
    assert torch.equal(got, fk.mont_pow(a.to(card), m - 2, params))
    r_inv = pow(R, -1, m)
    assert fk.limbs32_to_ints(got[:40].cpu().numpy()) == [
        pow(x * r_inv, -1, m) * R % m if x else 0 for x in fk.limbs32_to_ints(a[:40].numpy())]
    assert torch.equal(LimbContext(params, card).mont_inv(a.to(card)), got)


@pytest.mark.parametrize("kind", ["ecdsa_k1", "ecdsa_r1"])
def test_ecdsa_mul_kernel_equals_plain_version(card, kind):
    """One launch against its plain version, X, Y and Z: scalars 0, 1, n - 1,
    n (which the kernel takes as it comes), u1 G = u2 Q and u1 G = -u2 Q, a
    ragged batch."""
    from acvm_tpu_torch.blackbox.ec import secp256k1, secp256r1
    from acvm_tpu_torch.gpu import ecdsa

    curve = secp256k1 if kind == "ecdsa_k1" else secp256r1
    name = curve.params.name
    n = curve.params.n
    rng = np.random.default_rng(17)
    B = 70
    d = [int(rng.integers(1, 1 << 62)) for _ in range(B)]
    k1 = [int.from_bytes(rng.bytes(32), "little") % n for _ in range(B)]
    k2 = [int.from_bytes(rng.bytes(32), "little") % n for _ in range(B)]
    k1[:4], k2[:4] = [0, 1, n - 1, n], [5, 0, n - 1, 1]
    k1[4], k2[4], d[4] = 6, 3, 2  # u1 G = 6 G = 3 (2 G) = u2 Q
    k1[5], k2[5], d[5] = n - 6, 3, 2  # u1 G = -u2 Q: infinity
    pts = [curve.mul(di, curve.generator()) for di in d]
    u1, u2, Q = ecdsa.mul_operands(name, k1, k2, pts)
    table = ecdsa.gen_table(name, "cpu")
    build.reset_launches()
    got = ecdsa.ecdsa_mul(name, u1.to(card), u2.to(card), Q.to(card), table.to(card))
    assert build.LAUNCHES["ecdsa_mul"] == 1
    want = ecdsa.ecdsa_mul_plain(name, u1, u2, Q, table)
    assert torch.equal(got.cpu(), want)
    assert (got[2, 5] == 0).all() and not (got[2, 4] == 0).all()


@pytest.mark.parametrize("kind", ["ecdsa_k1", "ecdsa_r1"])
def test_ecdsa_mul_edge_lanes_equal_plain_version(card, kind):
    """The edge lanes of `utils.ecdsa_mul_edges` (u2 at the recoding's
    edges, u1 = 0, u1 G = +-u2 Q, the accumulator equal to +- a window's
    entry, an off-curve Q with Y = 0) in one launch against the plain
    version, X, Y and Z."""
    from acvm_tpu_torch.gpu import ecdsa
    from acvm_tpu_torch.utils import ecdsa_mul_edges

    name = {"ecdsa_k1": "secp256k1", "ecdsa_r1": "secp256r1"}[kind]
    lanes = ecdsa_mul_edges(kind)
    u1, u2, Q = ecdsa.mul_operands(name, *zip(*[lane[1:] for lane in lanes]))
    table = ecdsa.gen_table(name, "cpu")
    build.reset_launches()
    got = ecdsa.ecdsa_mul(name, u1.to(card), u2.to(card), Q.to(card), table.to(card))
    assert build.LAUNCHES["ecdsa_mul"] == 1
    assert torch.equal(got.cpu(), ecdsa.ecdsa_mul_plain(name, u1, u2, Q, table))


@pytest.mark.parametrize("kind", ["ecdsa_k1", "ecdsa_r1"])
def test_ecdsa_solver_on_card_equals_solver_on_cpu(card, kind):
    """The planted cases and a pool of valid signatures: the same panel, flags
    and first failures on the card (one ecdsa_mul launch) and on the CPU."""
    from acvm_tpu_torch.utils import ecdsa_inputs

    circuit = build_gadget_circuit(kind, 2)
    cols, valid, err = ecdsa_inputs(circuit, 20, kind, pool=4)
    plan = plan_circuit(circuit)
    build.reset_launches()
    gpu = BatchSolver(plan).solve(cols)
    assert build.LAUNCHES["ecdsa_mul"] == 1 and build.LAUNCHES["mul_wide"] > 0, build.LAUNCHES
    assert build.LAUNCHES["inv_wide"] == 2 and build.LAUNCHES["pow_wide"] == 0, build.LAUNCHES
    cpu = BatchSolver(plan, device="cpu").solve(cols)
    assert torch.equal(gpu.panel.cpu(), cpu.panel)
    assert np.array_equal(gpu.ok, cpu.ok) and np.array_equal(gpu.fail, cpu.fail)
    outs = np.array([gpu.witness_ints(int(op.call.output)) for op in circuit.opcodes], dtype=bool)
    assert np.array_equal(outs, valid & ~err) and np.array_equal(gpu.ok, ~err.any(0))


# -- the product surface: streaming, api, config, cli ----------------------------


def _memory_radix_circuit():
    """w3 = w1 * w1; block 0 = [w1, w3, w1]; w4 = block[w2]; ToLeRadix(w1, 10)
    into three digits (a host stage); w8 = w4 + w5."""
    from acvm_tpu_torch.acir import Circuit, Expression, Witness
    from acvm_tpu_torch.acir import opcodes as ops
    from acvm_tpu_torch.fields import FieldElement

    x = lambda i: Expression.from_witness(Witness(i))  # noqa: E731
    return Circuit(current_witness_index=8, private_parameters={Witness(1), Witness(2)}, opcodes=[
        ops.OpcodeArithmetic(Expression(mul_terms=[(FieldElement(1), Witness(1), Witness(1))]) - x(3)),
        ops.OpcodeMemoryInit(ops.BlockId(0), [Witness(1), Witness(3), Witness(1)]),
        ops.OpcodeMemoryOp(ops.BlockId(0), ops.MemOp.read_at_mem_index(x(2), Witness(4)), None),
        ops.OpcodeDirective(ops.DirToLeRadix(x(1), [Witness(5), Witness(6), Witness(7)], 10)),
        ops.OpcodeArithmetic(x(4) + x(5) - x(8)),
    ])


def test_streamed_solve_on_card_equals_one_pass(card):
    """Passes of 3 over 10 instances with a memory block, a host stage and two
    failing instances: the flags of one pass, on the card and on the CPU, and
    solve_chunks' panels and memory its columns."""
    plan = plan_circuit(_memory_radix_circuit())
    rng = np.random.default_rng(11)
    inputs = [{1: int(rng.integers(0, 1000)), 2: int(rng.integers(0, 3))} for _ in range(10)]
    inputs[4][2], inputs[7][1] = 3, 5000
    one = BatchSolver(plan).solve(inputs)
    cpu = BatchSolver(plan, device="cpu").solve(inputs)
    assert torch.equal(one.panel.cpu(), cpu.panel) and np.array_equal(one.fail, cpu.fail)
    solver = BatchSolver(plan, max_batch_per_pass=3)
    streamed = solver.solve(inputs)
    assert np.array_equal(streamed.ok, one.ok) and np.array_equal(streamed.fail, one.fail)
    for k, chunk in enumerate(solver.solve_chunks(inputs)):
        assert torch.equal(chunk.panel, one.panel[:, 3 * k : 3 * k + 3])
        assert torch.equal(chunk.memory_blocks()[0], one.memory_blocks()[0][:, 3 * k : 3 * k + 3])


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "non_uniform"])
def test_budgeted_passes_on_card_equal_one_pass(card, uniform):
    """A pass budget of a quarter of the batch's state streams the wide
    circuit through four passes (pinned uploads on a second stream): the
    flags of one pass, each chunk's panel its columns, every pass's panel
    freed before the next: the peak stays below two passes' state.  The
    non-uniform dicts (every third instance lacks an input) upload as
    scattered pairs, not a panel."""
    circuit = build_wide_arith_circuit(num_inputs=16, num_levels=3, gates_per_level=256, seed=9)
    plan = plan_circuit(circuit)
    inputs = random_inputs(circuit, 4096)
    if not uniform:
        for b in range(0, len(inputs), 3):
            del inputs[b][min(inputs[b])]
    one = BatchSolver(plan).solve(inputs)
    from acvm_tpu_torch.gpu.batch_solver import PASS_PEAK_OVER_ESTIMATE

    solver = BatchSolver(plan, pass_budget_bytes=int(one.solver.pass_bytes(1100) * PASS_PEAK_OVER_ESTIMATE))
    limit = solver.max_batch_per_pass()
    assert 4096 / 4 <= limit < 4096 / 3, limit
    pass_bytes = solver.panel_bytes(limit)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    streamed = solver.solve(inputs)
    assert torch.cuda.max_memory_allocated() - base < 2 * pass_bytes
    assert np.array_equal(streamed.ok, one.ok) and np.array_equal(streamed.fail, one.fail)
    for k, chunk in enumerate(solver.solve_chunks(inputs)):
        assert torch.equal(chunk.panel, one.panel[:, limit * k : limit * (k + 1)])


def test_api_and_cli_on_card(card, tmp_path, capsys):
    """execute_circuit_batched under the default EngineConfig (the card) and
    the CLI's solve (default --device cuda) on the addition fixture."""
    import json

    from acvm_tpu_torch import api, cli
    from acvm_tpu_torch.acir import Witness, WitnessMap
    from acvm_tpu_torch.config import EngineConfig
    from acvm_tpu_torch.fields import FieldElement

    from golden_vectors import ADDITION_CIRCUIT

    inputs = [{1: b, 2: 3 * b + 1} for b in range(300)]
    res = api.execute_circuit_batched(ADDITION_CIRCUIT, inputs, EngineConfig())
    assert res.panel.is_cuda and res.ok.all()
    assert res.witness_ints(3) == [4 * b + 1 for b in range(300)]
    want = api.execute_circuit(ADDITION_CIRCUIT, WitnessMap({Witness(1): FieldElement(7),
                                                           Witness(2): FieldElement(22)}))
    assert res.instance_ints(7)[3] == int(want.get(Witness(3)))
    path = tmp_path / "addition.acir.gz"
    path.write_bytes(ADDITION_CIRCUIT)
    cli.main(["solve", "--circuit", str(path), "--witness-json", '{"1": 1, "2": 2}', "--batch", "4096"])
    out = json.loads(capsys.readouterr().out)
    assert out["satisfied"] == 4096 and out["device"].startswith("cuda")


def test_compiled_circuit_on_card_equals_cpu(card):
    """The wide circuit compiled to width 3 (CSat): the same panel on the card
    and on the CPU, and the original witnesses those of the uncompiled one."""
    from acvm_tpu_torch.config import EngineConfig

    circuit = build_wide_arith_circuit(num_inputs=8, num_levels=3, gates_per_level=128, seed=4)
    compiled, _ = EngineConfig().compile(circuit)
    inputs = random_inputs(circuit, 300)
    plan = plan_circuit(compiled)
    build.reset_launches()
    gpu = BatchSolver(plan).solve(inputs)
    assert build.LAUNCHES["level"] > 0, build.LAUNCHES
    cpu = BatchSolver(plan, device="cpu").solve(inputs)
    assert torch.equal(gpu.panel.cpu(), cpu.panel) and gpu.ok.all()
    n = circuit.current_witness_index + 1
    plain = BatchSolver(plan_circuit(circuit)).solve(inputs)
    assert torch.equal(gpu.panel[:n], plain.panel[:n])


# -- the last modules: the tensor-core dot, the mesh, the host library --------


@pytest.mark.parametrize("T", range(1, 9))
def test_dot_mxu_kernel_equals_plain_version_and_v2(card, T):
    from acvm_tpu_torch.fields import mxu_ops
    from acvm_tpu_torch.fields.torch_ops import LimbContext

    P = BN254_FR.modulus
    for E, B in ((9, 300), (3, 1), (3, 520)):
        vals = elements(E * T * B, BN254_FR, 10 + T).reshape(E, T, B, 8).to(card)
        coeffs = elements(E * T, BN254_FR, 20 + T).reshape(E, T, 8).to(card)
        qc = elements(E, BN254_FR, 30 + T).to(card)
        vals[-1] = torch.from_numpy(fk.int_to_limbs32(P - 1).copy()).to(card)
        coeffs[0, -1] = 0  # a padding term
        before = build.LAUNCHES["dot_mxu"]
        got = mxu_ops.mont_dot_mxu(vals, coeffs, qc)
        assert build.LAUNCHES["dot_mxu"] == before + 1
        assert torch.equal(got, mxu_ops.mont_dot_mxu_plain(vals, coeffs, qc))
        ctx = LimbContext(BN254_FR, card)
        assert torch.equal(got, fk.mont_dot(vals, coeffs, None, None, None, ctx.from_mont(qc), None))


def test_mxu_solver_on_card_equals_v2(card):
    circuit = with_repeated_constraints(build_wide_arith_circuit(
        num_inputs=16, num_levels=2, gates_per_level=256, dyn_fraction=0.5, seed=5), 32)
    plan = plan_circuit(circuit)
    inputs = random_inputs(circuit, 1000)
    ref = BatchSolver(plan).solve(inputs)
    build.reset_launches()
    res = BatchSolver(plan, dot_kernel="mxu").solve(inputs)
    assert build.LAUNCHES["dot_mxu"] > 0
    assert res.ok.all() and torch.equal(res.panel, ref.panel)


def test_mesh_solve_on_card_equals_unsharded(card):
    from acvm_tpu_torch.parallel import make_mesh

    circuit = build_wide_arith_circuit(num_inputs=16, num_levels=3, gates_per_level=512,
                                       dyn_fraction=0.5, seed=6)
    plan = plan_circuit(circuit)
    for B in (1, 2, 1001):
        inputs = random_inputs(circuit, B)
        ref = BatchSolver(plan).solve(inputs)
        res = BatchSolver(plan, mesh=make_mesh([card] * 3)).solve(inputs)
        assert np.array_equal(res.ok, ref.ok) and np.array_equal(res.fail, ref.fail)
        assert torch.equal(res.panel, ref.panel)
        assert res.instance_ints(B - 1) == ref.instance_ints(B - 1)


def test_pedersen_msm_sharded_on_card(card):
    from acvm_tpu_torch.blackbox.grumpkin import derive_generator
    from acvm_tpu_torch.fields.torch_ops import LimbContext
    from acvm_tpu_torch.gpu import ec
    from acvm_tpu_torch.parallel import make_mesh

    ctx = LimbContext(BN254_FR, card)
    tables = torch.stack([ec.window_table(derive_generator(0, i), device=card) for i in range(5)])
    scalars = elements(5 * 64, BN254_FR, 40).reshape(5, 64, 8).to(card)
    want = ec.pt_to_affine(ctx, ec.msm_fixed_tables(ctx, tables, scalars))
    for k in (1, 2, 4):
        got = ec.pedersen_msm_sharded(ctx, tables, scalars, make_mesh([card] * k))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


MESH_JOB = """
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
from acvm_tpu_torch.parallel import distributed
distributed.initialize_from_env()
import torch.distributed as dist
from acvm_tpu_torch.gpu import BatchSolver, plan_circuit
from acvm_tpu_torch.utils import build_wide_arith_circuit, random_inputs
circuit = build_wide_arith_circuit(num_inputs=16, num_levels=3, gates_per_level=512,
                                   dyn_fraction=0.5, seed=6)
plan = plan_circuit(circuit)
inputs = random_inputs(circuit, 777)
res = BatchSolver(plan, mesh=distributed.global_mesh()).solve(inputs)
ref = BatchSolver(plan, device=distributed.local_device()).solve(inputs)
assert np.array_equal(res.ok, ref.ok) and np.array_equal(res.fail, ref.fail)
assert res.witness_ints(plan.num_witnesses - 1) == ref.witness_ints(plan.num_witnesses - 1)
assert res.instance_ints(776) == ref.instance_ints(776)
print(json.dumps({{"rank": dist.get_rank(), "backend": dist.get_backend()}}))
dist.destroy_process_group()
"""


def test_launch_local_on_card_over_gloo_and_nccl(card):
    import json
    from pathlib import Path

    from acvm_tpu_torch.parallel import launcher

    job = MESH_JOB.format(repo=str(Path(__file__).resolve().parents[1]))
    for n, backend in ((2, "gloo"), (1, "nccl")):
        if n > 1 and torch.cuda.device_count() >= n:
            backend = "nccl"
        results = launcher.launch_local(n, ["-c", job], platform="cuda", timeout=600)
        lines = [json.loads(r.stdout.strip().splitlines()[-1]) for r in results]
        assert [(line["rank"], line["backend"]) for line in lines] == \
            [(r, backend) for r in range(n)]


def test_native_library_builds_on_the_card_s_machine(card):
    from acvm_tpu_torch import native
    from acvm_tpu_torch.blackbox.ec import grumpkin

    G = grumpkin.generator()
    assert native.grumpkin_mul(G, 12345) == grumpkin.mul(12345, G)
