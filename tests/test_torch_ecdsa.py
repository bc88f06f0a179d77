"""ECDSA verification (secp256k1, secp256r1) in the port against the JAX
package, on the CPU.  Tolerance 0 everywhere: integers.

* The wide field (2^255 < p < 2^256: both curves' base fields and group
  orders): every `LimbContext` op against Python ints and the JAX wide
  `LimbContext`.  The JAX ops run eagerly (op by op, each primitive compiled
  once for all four fields) where XLA:CPU would compile each field's program
  anew; its batch inversion, whose scans compile per field, on two fields.
* The group law with `a_mont`: `gpu/ec.py`'s `pt_double` / `pt_add` against
  `acvm_tpu/tpu/ec.py`'s, un-jitted, over the JAX wide `LimbContext` with each
  field operation its own jitted program (`JitOps`), at infinity, P + P,
  P + (-P) and a generic pair: X, Y and Z.
* `ecdsa_mul`'s chain in its plain version: the signed 4-bit recoding of u2
  against Python ints at edge scalars, the lane's table of 1Q ... 8Q and
  the group law the plain chain runs (`ec.pt_double`, `ec.pt_add`) against
  the Python-int curve, and R on the edge lanes of `utils.ecdsa_mul_edges` against the
  Python-int curve.
* One solve a curve (a module fixture, the file's cost: about 7 s each, the
  plain `ecdsa_mul` chain one field op at a time) of
  `build_gadget_circuit("ecdsa_k1" | "ecdsa_r1", 2)` over the planted edge
  cases of `utils.ecdsa_planted` and a pool of valid signatures
  (`utils.ecdsa_inputs`), through `BatchSolver(device="cpu")`: each planted
  case against the JAX host verifier (`acvm_tpu.blackbox.ecdsa`), every
  instance's witnesses, `ok` and first-failure index against the JAX
  `pwg.ACVM`, and the R of `ecdsa_mul` (its plain version on the CPU) on
  every lane against the Python-int curve.
* The generator tables and the packed ECDSA groups against the JAX
  package's (`_gen_table_np` through `convert`, `_pack_level`).

The JAX device route (`tpu/ecdsa.py::ecdsa_verify_batched`, a `lax.scan` of
256 steps) takes about 100 s to compile on a CPU: its comparison is the one
`slow` test.
"""

import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvm_tpu import acir as jacir
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.blackbox import GrumpkinSolver as JGrumpkinSolver
from acvm_tpu.blackbox import ecdsa as jecdsa
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.fields import jnp_ops
from acvm_tpu.fields.params import FieldParams as JFieldParams
from acvm_tpu.pwg import ACVM, ACVMStatus
from acvm_tpu.tpu import BatchSolver as JBatchSolver, ec as jec, plan_circuit as jplan_circuit
from acvm_tpu.utils import bench_circuits as jbench

from acvm_tpu_torch import convert
from acvm_tpu_torch.acir import Circuit, Witness
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.blackbox.ec import secp256k1, secp256r1
from acvm_tpu_torch.fields import kernels as fk
from acvm_tpu_torch.fields.torch_ops import LimbContext
from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, ec, ecdsa, plan_circuit
from acvm_tpu_torch.utils import (
    build_gadget_circuit,
    columnar_instance,
    ecdsa_inputs,
    ecdsa_instance_bytes,
    ecdsa_mul_edges,
    ecdsa_planted,
)

KINDS = {"ecdsa_k1": ("secp256k1", secp256k1, jecdsa.ecdsa_secp256k1_verify),
         "ecdsa_r1": ("secp256r1", secp256r1, jecdsa.ecdsa_secp256r1_verify)}
FIELDS = [(curve, i) for curve in ("secp256k1", "secp256r1") for i in (0, 1)]  # (curve, p | n)
FIELD_IDS = [f"{c}_{'pn'[i]}" for c, i in FIELDS]
BATCH = len(ecdsa_planted("ecdsa_k1")) + 2  # the planted cases, the 256 + b byte, one more


def ints(t) -> list:
    return fk.limbs32_to_ints(np.asarray(t))


def limbs(values) -> torch.Tensor:
    return torch.from_numpy(fk.ints_to_limbs32(values).copy())


def to_jax(t) -> jnp.ndarray:
    return jnp.asarray(convert.limbs32_to_limbs16(np.asarray(t)))


def from_jax(a) -> np.ndarray:
    return convert.limbs16_to_limbs32(np.asarray(a))


def field_values(m: int, seed: int) -> list:
    rng = random.Random(seed)
    return [0, 1, m - 1, m - 2, 1 << 255, (1 << 255) - 1] + [rng.randrange(m) for _ in range(10)]


# ---------------------------------------------------------------------------
# The wide field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("curve,which", FIELDS, ids=FIELD_IDS)
def test_wide_field_ops_equal_ints_and_the_jax_package(curve, which):
    params = ecdsa.curve_fields(curve)[which]
    m, R = params.modulus, params.r
    r_inv = pow(R, -1, m)
    ctx = LimbContext(params, "cpu")
    jctx = jnp_ops.LimbContext(JFieldParams(name=params.name, modulus=m))
    assert ctx.wide and jctx.wide
    xs = field_values(m, 1)
    ys = xs[::-1]
    a, b = limbs(xs), limbs(ys)
    ja, jb = to_jax(a), to_jax(b)

    def same(got, want_ints, jax_out=None):
        assert ints(got) == want_ints
        if jax_out is not None:
            assert ints(from_jax(jax_out)) == want_ints

    same(ctx.add(a, b), [(x + y) % m for x, y in zip(xs, ys)], jctx.add(ja, jb))
    same(ctx.sub(a, b), [(x - y) % m for x, y in zip(xs, ys)], jctx.sub(ja, jb))
    same(ctx.neg(a), [-x % m for x in xs], jctx.neg(ja))
    same(ctx.mont_mul(a, b), [x * y * r_inv % m for x, y in zip(xs, ys)], jctx.mont_mul(ja, jb))
    same(ctx.to_mont(a), [x * R % m for x in xs], jctx.to_mont(ja))
    same(ctx.from_mont(a), [x * r_inv % m for x in xs], jctx.from_mont(ja))
    # b may be any 256-bit value (the product's precondition is on a only)
    big = [(1 << 256) - 1 - x for x in xs]
    same(ctx.mont_mul(a, limbs(big)), [x * y * r_inv % m for x, y in zip(xs, big)])
    inv = [pow(x * r_inv, -1, m) * R % m if x else 0 for x in xs]
    same(ctx.mont_inv(a), inv, jctx.mont_inv(ja))
    same(ctx.mont_inv_grouped(a), inv)
    same(ctx.mont_batch_inv(a.reshape(4, 4, 8), axis=0, max_scan=3).reshape(-1, 8), inv)
    assert ctx.eq(a, b).tolist() == [x == y for x, y in zip(xs, ys)] == np.asarray(jctx.eq(ja, jb)).tolist()
    assert ctx.is_zero(a).tolist() == [x == 0 for x in xs] == np.asarray(jctx.is_zero(ja)).tolist()
    for bits in (0, 1, 8, 31, 32, 100, 255, 256):
        assert ctx.num_bits_leq(a, bits).tolist() == [x < 1 << bits for x in xs] == \
            np.asarray(jctx.num_bits_leq(ja, bits)).tolist()
        same(ctx.mask_bits(a, bits), [x % (1 << bits) for x in xs], jctx.mask_bits(ja, bits))


@pytest.mark.parametrize("curve,which", [("secp256k1", 0), ("secp256r1", 1)], ids=["secp256k1_p", "secp256r1_n"])
def test_wide_batch_inversion_equals_the_jax_package(curve, which, monkeypatch):
    """The folded inversion of both packages, and the port's with its fold
    branch reached (FOLD_FROM_WIDE, the wide field's threshold, and
    FOLD_LANES patched down), on zeros at chunk edges."""
    params = ecdsa.curve_fields(curve)[which]
    ctx = LimbContext(params, "cpu")
    jctx = jnp_ops.LimbContext(JFieldParams(name=params.name, modulus=params.modulus))
    xs = field_values(params.modulus, 2)
    xs[7] = xs[8] = 0
    a = limbs(xs).reshape(4, 4, 8)
    want = ints(from_jax(jctx.mont_batch_inv(to_jax(a), axis=0)))
    assert ints(ctx.mont_batch_inv(a, axis=0)) == want
    monkeypatch.setattr(LimbContext, "FOLD_FROM_WIDE", 16)
    monkeypatch.setattr(LimbContext, "FOLD_LANES", 2)
    assert ctx.fold_rows(16) == 8  # the fold branch: 8 rows of 2
    assert ints(ctx.mont_inv_grouped(a.reshape(16, 8))) == want


def test_narrow_only_kernels_refuse_a_wide_field():
    fp, _ = ecdsa.curve_fields("secp256k1")
    x = torch.zeros((1, 1, 2, 8), dtype=torch.int32)
    c = torch.zeros((1, 1, 8), dtype=torch.int32)
    q = torch.zeros((1, 8), dtype=torch.int32)
    from acvm_tpu_torch.gpu import brillig_vm_device, ec_fused
    from acvm_tpu_torch.gpu.fused_level import fused_level_call
    with pytest.raises(NotImplementedError, match="narrow only"):
        fk.mont_dot(x, c, None, None, None, q, params=fp)
    with pytest.raises(NotImplementedError, match="narrow only"):
        fk.mont_dot_v1(x, c, q, params=fp)
    with pytest.raises(NotImplementedError, match="narrow only"):
        fused_level_call(torch.zeros((4, 2, 8), dtype=torch.int32), torch.zeros((0, 8), dtype=torch.int32), fp)
    with pytest.raises(NotImplementedError, match="narrow only"):
        ec_fused.pt_add_panels(torch.zeros((1, 3, 2, 8), dtype=torch.int32),
                               torch.zeros((1, 3, 2, 8), dtype=torch.int32), fp)
    with pytest.raises(NotImplementedError, match="narrow only"):
        ec_fused.scalar_mul_fused(LimbContext(fp, "cpu"), (q, q, q), q)
    with pytest.raises(NotImplementedError, match="narrow only"):
        brillig_vm_device._vm_words(fp)
    with pytest.raises(ValueError, match="always reduces"):
        fk.mont_mul(q, q, fp, reduce=False)


# ---------------------------------------------------------------------------
# The group law with a_mont
# ---------------------------------------------------------------------------


class JitOps:
    """The JAX wide LimbContext with each field operation its own jitted
    program: the reference's group law op by op, one compile an op."""

    def __init__(self, params):
        ctx = jnp_ops.LimbContext(JFieldParams(name=params.name, modulus=params.modulus))
        self.params, self.wide = ctx.params, ctx.wide
        self.mont_mul, self.add, self.sub = jax.jit(ctx.mont_mul), jax.jit(ctx.add), jax.jit(ctx.sub)
        self.is_zero = jax.jit(ctx.is_zero)


def jacobian(curve, pt, z: int, params) -> list:
    """An affine point (None: infinity) -> Montgomery Jacobian (X, Y, Z) ints."""
    p, R = params.modulus, params.r
    if pt is None:
        return [0, 0, 0]
    return [pt[0] * z * z % p * R % p, pt[1] * z * z * z % p * R % p, z * R % p]


@pytest.mark.parametrize("kind", list(KINDS))
def test_group_law_equals_the_jax_package(kind):
    """Lanes: infinity + Q, P + infinity, P + P (the doubling branch), P +
    (-P) (infinity), a generic pair; each at a random Z.  X, Y and Z against
    the JAX `pt_add` / `pt_double`, the affine sum against the Python-int
    curve."""
    name, curve, _ = KINDS[kind]
    fp, _ = ecdsa.curve_fields(name)
    cp = curve.params
    rng = random.Random(3)
    P = curve.mul(rng.randrange(1, cp.n), curve.generator())
    Q = curve.mul(rng.randrange(1, cp.n), curve.generator())
    pairs = [(None, Q), (P, None), (P, P), (P, curve.neg(P)), (P, Q)]
    ctx = LimbContext(fp, "cpu")
    jctx = JitOps(fp)
    a_mont = None
    ja_mont = None
    if cp.a % cp.p:
        a_mont = limbs([cp.a % cp.p * fp.r % cp.p])[0]
        ja_mont = to_jax(a_mont)
    lhs = [jacobian(curve, u, rng.randrange(1, cp.p), fp) for u, _ in pairs]
    rhs = [jacobian(curve, v, rng.randrange(1, cp.p), fp) for _, v in pairs]
    p1 = tuple(limbs([c[i] for c in lhs]) for i in range(3))
    p2 = tuple(limbs([c[i] for c in rhs]) for i in range(3))
    got_add = ec.pt_add(ctx, p1, p2, a_mont)
    got_dbl = ec.pt_double(ctx, p1, a_mont)
    want_add = jec.pt_add(jctx, tuple(map(to_jax, p1)), tuple(map(to_jax, p2)), ja_mont)
    want_dbl = jec.pt_double(jctx, tuple(map(to_jax, p1)), ja_mont)
    for g, w in zip(got_add + got_dbl, want_add + want_dbl):
        assert ints(g) == ints(from_jax(w))
    r_inv = pow(fp.r, -1, cp.p)
    X, Y, Z = (ints(c) for c in got_add)
    for lane, (u, v) in enumerate(pairs):
        want = curve.add(u, v)
        if want is None:
            assert Z[lane] == 0, lane
            continue
        zi = pow(Z[lane] * r_inv, -1, cp.p)
        assert (X[lane] * r_inv * zi * zi % cp.p, Y[lane] * r_inv * zi ** 3 % cp.p) == want, lane


@pytest.mark.parametrize("kind", list(KINDS))
def test_mixed_addition_equals_pt_add(kind):
    """`ecdsa.pt_madd` (the kernel's addition of a Q with Z = one) against
    `ec.pt_add` on the same operands, X, Y and Z: P at infinity, P == Q (the
    doubling branch), P == -Q, a generic pair, and an off-curve Q (an invalid
    key's lane), P at a random Z."""
    name, curve, _ = KINDS[kind]
    fp, _ = ecdsa.curve_fields(name)
    cp = curve.params
    rng = random.Random(5)
    P = curve.mul(rng.randrange(1, cp.n), curve.generator())
    Q = curve.mul(rng.randrange(1, cp.n), curve.generator())
    off = (Q[0], (Q[1] + 1) % cp.p)
    pairs = [(None, Q), (P, P), (P, curve.neg(P)), (P, Q), (P, off)]
    hf = fk.half_field(fp, torch.device("cpu"))
    a_mont = None
    if cp.a % cp.p:
        a_mont = fk.split_half(limbs([cp.a % cp.p * fp.r % cp.p])[0])
    lhs = [jacobian(curve, u, rng.randrange(1, cp.p), fp) for u, _ in pairs]
    rhs = [jacobian(curve, v, 1, fp) for _, v in pairs]
    rhs[-1] = [off[0] * fp.r % cp.p, off[1] * fp.r % cp.p, fp.r % cp.p]
    p1 = tuple(fk.split_half(limbs([c[i] for c in lhs])) for i in range(3))
    p2 = tuple(fk.split_half(limbs([c[i] for c in rhs])) for i in range(3))
    got = ecdsa.pt_madd(hf, p1, p2[:2], a_mont)
    want = ec.pt_add(hf, p1, p2, a_mont)
    for g, w in zip(got, want):
        assert ints(fk.join_half(g)) == ints(fk.join_half(w))
    assert ints(fk.join_half(got[2]))[2] == 0 and ints(fk.join_half(got[2]))[1] != 0


@pytest.mark.parametrize("kind", list(KINDS))
def test_kernel_formulas_equal_the_group_law(kind):
    """The doubling and complete addition that `ecdsa_mul_plain` runs for the
    kernel's `ec_dbl` and `ec_add` (`ec.pt_double`, infinity kept as it is,
    and `ec.pt_add`) against the Python-int curve, each operand at a random
    Z: infinity on either side, P + P, P + (-P), a generic pair and an
    off-curve Q (run, and its sum not infinity)."""
    name, curve, _ = KINDS[kind]
    fp, _ = ecdsa.curve_fields(name)
    cp = curve.params
    rng = random.Random(9)
    P = curve.mul(rng.randrange(1, cp.n), curve.generator())
    Q = curve.mul(rng.randrange(1, cp.n), curve.generator())
    off = (Q[0], (Q[1] + 1) % cp.p)
    pairs = [(None, Q), (P, None), (P, P), (P, curve.neg(P)), (P, Q), (P, off)]
    hf = fk.half_field(fp, torch.device("cpu"))
    a_mont = ecdsa._a_mont_half(name, "cpu")
    lhs = [jacobian(curve, u, rng.randrange(1, cp.p), fp) for u, _ in pairs]
    rhs = [jacobian(curve, v, rng.randrange(1, cp.p), fp) for _, v in pairs]
    z = rng.randrange(1, cp.p)
    rhs[-1] = [off[0] * z * z % cp.p * fp.r % cp.p, off[1] * z ** 3 % cp.p * fp.r % cp.p, z * fp.r % cp.p]
    rhs[1] = [fp.r % cp.p, fp.r % cp.p, 0]  # infinity as an addition leaves it: Z = 0, X and Y not
    p1 = tuple(fk.split_half(limbs([c[i] for c in lhs])) for i in range(3))
    p2 = tuple(fk.split_half(limbs([c[i] for c in rhs])) for i in range(3))
    r_inv = pow(fp.r, -1, cp.p)

    def affine(pt):
        X, Y, Z = (ints(fk.join_half(c)) for c in pt)
        out = []
        for x, y, zz in zip(X, Y, Z):
            if zz == 0:
                out.append(None)
                continue
            zi = pow(zz * r_inv, -1, cp.p)
            out.append((x * r_inv * zi * zi % cp.p, y * r_inv * zi ** 3 % cp.p))
        return out

    sums = affine(ec.pt_add(hf, p1, p2, a_mont))
    assert sums[:5] == [curve.add(u, v) for u, v in pairs[:5]]
    assert sums[5] is not None
    doubled = ecdsa._dbl(hf, p2, a_mont)
    assert affine(doubled)[2:5] == [curve.add(v, v) for _, v in pairs[2:5]]
    assert affine(doubled)[1] is None
    assert [ints(fk.join_half(c))[1] for c in doubled] == [ints(fk.join_half(c))[1] for c in p2]


def recode(u: int) -> list:
    """The signed 4-bit windows of u by their carries: s_i in [-8, 8), then
    the carry out of the top window."""
    digits, carry = [], 0
    for i in range(64):
        v = (u >> (4 * i) & 15) + carry
        carry = int(v >= 8)
        digits.append(v - 16 * carry)
    return digits + [carry]


SCALARS = {"0": 0, "1": 1, "7": 7, "8": 8, "15": 15, "16": 16, "k1_n-1": secp256k1.params.n - 1,
           "r1_n-1": secp256r1.params.n - 1, "2^255": 1 << 255, "every_nibble_15": (1 << 256) - 1,
           "carry_bottom_to_top": (1 << 255) - 8}


@pytest.mark.parametrize("label", list(SCALARS))
def test_signed_windows_equal_ints(label):
    """`ecdsa.signed_windows` (the kernel's recoding: the nibbles of u +
    0x888...8 less 8, the carry on top) against the carry recoding in Python
    ints: sum s_i 16^i = u, every digit in range."""
    u = SCALARS[label]
    got = ecdsa.signed_windows(limbs([u, u ^ 0x5A5A]))[0].tolist()
    assert got == recode(u)
    assert sum(d * 16 ** i for i, d in enumerate(got)) == u
    assert all(-8 <= d < 8 for d in got[:64]) and got[64] in (0, 1)


@pytest.mark.parametrize("kind", list(KINDS))
def test_lane_table_equals_the_curve(kind):
    """The table a lane builds from its Q, entry e = (e + 1) Q, against the
    Python-int curve; an off-curve Q with Y = 0 (an invalid key's lane, run
    all the same) gives Q and infinity in turn, and does not raise."""
    name, curve, _ = KINDS[kind]
    fp, _ = ecdsa.curve_fields(name)
    cp = curve.params
    rng = random.Random(11)
    points = [curve.mul(rng.randrange(1, cp.n), curve.generator()) for _ in range(3)]
    points.append(next(e for _, _, _, e in ecdsa_mul_edges(kind) if not curve.is_on_curve(e)))
    _, _, Q = ecdsa.mul_operands(name, [0] * 4, [0] * 4, points)
    table = ecdsa.lane_table_plain(name, Q)
    assert table.shape == (8, 3, 4, 8)
    r_inv = pow(fp.r, -1, cp.p)
    X, Y, Z = ([ints(table[e, c]) for e in range(8)] for c in range(3))
    for lane, pt in enumerate(points[:3]):
        for e in range(8):
            zi = pow(Z[e][lane] * r_inv, -1, cp.p)
            got = (X[e][lane] * r_inv * zi * zi % cp.p, Y[e][lane] * r_inv * zi ** 3 % cp.p)
            assert got == curve.mul(e + 1, pt), (lane, e)
    assert [Z[e][3] == 0 for e in range(8)] == [e % 2 == 1 for e in range(8)]
    assert all([X[e][3], Y[e][3], Z[e][3]] == [X[0][3], Y[0][3], Z[0][3]] for e in range(0, 8, 2))


@pytest.mark.parametrize("kind", list(KINDS))
def test_ecdsa_mul_plain_edges_equal_the_curve(kind):
    """R = u1 G + u2 Q of `ecdsa_mul_plain` on the edge lanes (u2 = 0, 1, 7,
    8, 15, 16, n - 1, 2^255, 2^256 - 1; u1 = 0; u1 G = +-u2 Q; the
    accumulator equal to +- the last window's entry) against the Python-int
    curve; the off-curve lane runs and is not checked."""
    name, curve, _ = KINDS[kind]
    fp, _ = ecdsa.curve_fields(name)
    cp = curve.params
    lanes = ecdsa_mul_edges(kind)
    assert len(lanes) <= 16
    u1, u2, Q = ecdsa.mul_operands(name, *zip(*[lane[1:] for lane in lanes]))
    R = ecdsa.ecdsa_mul_plain(name, u1, u2, Q, ecdsa.gen_table(name, "cpu"))
    r_inv = pow(fp.r, -1, cp.p)
    X, Y, Z = (ints(c) for c in R)
    infinite = []
    for i, (label, k1, k2, q) in enumerate(lanes):
        if not curve.is_on_curve(q):
            continue
        want = curve.add(curve.mul(k1, curve.generator()), curve.mul(k2, q))
        if want is None:
            infinite.append(label)
            assert Z[i] == 0, label
            continue
        zi = pow(Z[i] * r_inv, -1, cp.p)
        assert (X[i] * r_inv * zi * zi % cp.p, Y[i] * r_inv * zi ** 3 % cp.p) == want, label
    assert infinite == ["u1G_eq_minus_u2Q"]


# ---------------------------------------------------------------------------
# Solves over the planted instances
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(KINDS))
def solved(request):
    """One CPU solve of the kind's gadget circuit over the planted cases and
    valid signatures, with every `ecdsa_mul` call's operands and result."""
    kind = request.param
    circuit = build_gadget_circuit(kind, 2)
    cols, valid, err = ecdsa_inputs(circuit, BATCH, kind, pool=3)
    calls = []
    real = ecdsa.ecdsa_mul

    def spy(curve_name, u1, u2, Q, table):
        R = real(curve_name, u1, u2, Q, table)
        calls.append((curve_name, u1.clone(), u2.clone(), Q.clone(), R.clone()))
        return R

    ecdsa.ecdsa_mul = spy
    try:
        res = BatchSolver(plan_circuit(circuit), device="cpu").solve(cols)
    finally:
        ecdsa.ecdsa_mul = real
    return types.SimpleNamespace(kind=kind, circuit=circuit, cols=cols, valid=valid, err=err,
                                 res=res, calls=calls)


def host_verdict(verify, values):
    parts = ecdsa_instance_bytes(values)
    try:
        return verify(parts["msg"], parts["pub_x"], parts["pub_y"], parts["sig"]), False
    except jecdsa.EcdsaError:
        return False, True


def test_planted_instances_equal_the_host_verifier(solved):
    """Each planted case's valid bit and error flag against the JAX host
    verifier and against what its construction says."""
    _, _, verify = KINDS[solved.kind]
    planted = ecdsa_planted(solved.kind)
    k = len(planted)
    outs = [solved.res.witness_ints(int(op.call.output)) for op in solved.circuit.opcodes]
    verdicts = [host_verdict(verify, values) for _, values, _, _ in planted]
    for (label, _, valid, err), verdict in zip(planted, verdicts):
        assert verdict == (valid and not err, err), label
    for b in range(k):
        (valid0, err0), (valid1, err1) = verdicts[b], verdicts[(b + 1) % k]
        assert [outs[0][b], outs[1][b]] == [int(valid0), int(valid1)], b
        assert bool(solved.res.ok[b]) == (not err0 and not err1), b
        assert int(solved.res.fail[b]) == (0 if err0 else 1 if err1 else int(FAIL_NONE)), b
    # the 256 + b signature byte: only its low byte is read, and it verifies
    b = k
    assert solved.cols[int(solved.circuit.opcodes[0].call.signature[63].witness)][b] >= 256
    assert outs[0][b] == outs[1][b] == 1 and solved.res.ok[b]
    assert np.array_equal(np.asarray(outs, dtype=bool), solved.valid & ~solved.err)


def test_ecdsa_solve_equals_the_jax_sequential_engine(solved):
    """Every instance: the JAX pwg.ACVM's witnesses where it solves, its
    failing opcode where it fails."""
    jcircuit = jbench.build_gadget_circuit(solved.kind, 2)
    for b in range(BATCH):
        inst = columnar_instance(solved.cols, b)
        wm = jacir.WitnessMap({jacir.Witness(w): JFieldElement(v) for w, v in inst.items()})
        acvm = ACVM(JGrumpkinSolver(), jcircuit.opcodes, wm)
        status = acvm.solve()
        if status == ACVMStatus.SOLVED:
            assert solved.res.ok[b] and solved.res.fail[b] == FAIL_NONE, b
            got = solved.res.instance_ints(b)
            want = list(acvm.finalize())
            assert [got[int(w)] for w, _ in want] == [int(v) for _, v in want], b
        else:
            assert status == ACVMStatus.FAILURE and not solved.res.ok[b], b
            location = getattr(acvm.error, "opcode_location", None)
            index = acvm.instruction_pointer if location is None else location.acir_index
            assert int(solved.res.fail[b]) == index, b


def test_ecdsa_mul_plain_equals_the_curve(solved):
    """R = u1 G + u2 Q of every lane the solve ran (planted edges among them:
    u1 = 0, R at infinity, u1 G = u2 Q) against the Python-int curve."""
    name, curve, _ = KINDS[solved.kind]
    fp, _ = ecdsa.curve_fields(name)
    cp = curve.params
    r_inv = pow(fp.r, -1, cp.p)
    assert len(solved.calls) == 1  # both gadgets in one group
    curve_name, u1, u2, Q, R = solved.calls[0]
    assert curve_name == name and R.shape == (3, 2 * BATCH, 8)
    qx, qy, qz = (ints(c) for c in Q)
    X, Y, Z = (ints(c) for c in R)
    seen = {"u1_zero": 0, "infinity": 0}
    for lane, (k1, k2) in enumerate(zip(ints(u1), ints(u2))):
        assert qz[lane] == fp.r % cp.p
        q = (qx[lane] * r_inv % cp.p, qy[lane] * r_inv % cp.p)
        want = curve.add(curve.mul(k1, curve.generator()),
                         curve.mul(k2, q) if curve.is_on_curve(q) else None)
        if not curve.is_on_curve(q):
            continue  # an off-curve key: R is not a point of the group
        seen["u1_zero"] += k1 == 0
        if want is None:
            seen["infinity"] += 1
            assert Z[lane] == 0, lane
            continue
        zi = pow(Z[lane] * r_inv, -1, cp.p)
        assert (X[lane] * r_inv * zi * zi % cp.p, Y[lane] * r_inv * zi ** 3 % cp.p) == want, lane
    assert seen["u1_zero"] >= 2 and seen["infinity"] >= 2, seen


# ---------------------------------------------------------------------------
# Tables and packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("curve", ["secp256k1", "secp256r1"])
def test_generator_tables_equal_the_jax_package_s(curve):
    """The generator's window table, the JAX one carried over by
    `convert.window_table_from_jax` (wide values: every limb of 16 bits)."""
    from acvm_tpu.tpu import ecdsa as jecdsa_dev

    jtable = jecdsa_dev._gen_table_np(curve)
    np.testing.assert_array_equal(ecdsa._gen_table_np(curve), convert.window_table_from_jax(jtable))
    np.testing.assert_array_equal(convert.window_table_to_jax(ecdsa._gen_table_np(curve)), jtable)
    assert ints(ecdsa._gen_table_np(curve)[0, 1, 2:]) == [ecdsa.curve_fields(curve)[0].r]



def mixed_circuit(lib):
    """Three ECDSA gadgets in one level, k1, r1, k1, over fresh byte witnesses."""
    o, W = lib.opcodes, lib.Witness
    opcodes, next_w = [], 1
    for cls in (o.BBEcdsaSecp256k1, o.BBEcdsaSecp256r1, o.BBEcdsaSecp256k1):
        parts = []
        for n in (32, 32, 64, 32):
            parts.append([o.FunctionInput(W(next_w + j), 8) for j in range(n)])
            next_w += n
        opcodes.append(o.OpcodeBlackBoxFuncCall(cls(*parts, W(next_w))))
        next_w += 1
    return lib.Circuit(current_witness_index=next_w - 1, opcodes=opcodes,
                       private_parameters={W(w) for w in range(1, next_w)})


def test_ecdsa_packs_equal_the_jax_package_s():
    port_lib = types.SimpleNamespace(opcodes=ops, Witness=Witness, Circuit=Circuit)
    jax_lib = types.SimpleNamespace(opcodes=jops, Witness=jacir.Witness, Circuit=jacir.Circuit)
    ports = [g for seg in BatchSolver(plan_circuit(mixed_circuit(port_lib)), device="cpu").segments
             for lv in seg.levels for g in lv.get("ecdsa", [])]
    jaxs = [g for seg in JBatchSolver(jplan_circuit(mixed_circuit(jax_lib))).segments
            for lv in seg.levels for g in lv.get("ecdsa", [])]
    assert [g["curve"] for g in ports] == [g["curve"] for g in jaxs] == ["secp256k1", "secp256r1"]
    for port, jpk in zip(ports, jaxs):
        for key in ("op_idx", "pub_x", "pub_y", "sig", "msg", "out_idx"):
            np.testing.assert_array_equal(port[key].numpy(), np.asarray(jpk[key]), err_msg=key)


# ---------------------------------------------------------------------------
# The JAX device route (slow: ~100 s of XLA compile a curve)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("kind", list(KINDS))
def test_ecdsa_verify_equals_the_jax_device_route(kind):
    """`ecdsa_verify_batched` of both packages on the planted cases: valid
    and err bits."""
    from acvm_tpu.tpu import ecdsa as jecdsa_dev

    name, _, _ = KINDS[kind]
    planted = ecdsa_planted(kind)
    rows = {key: np.stack([np.frombuffer(ecdsa_instance_bytes(v)[key], dtype=np.uint8)
                           for _, v, _, _ in planted]) for key in ("pub_x", "pub_y", "sig", "msg")}
    valid, err = ecdsa.ecdsa_verify_batched(
        name, *(torch.from_numpy(rows[k].astype(np.int64)) for k in ("pub_x", "pub_y", "sig", "msg")))
    jvalid, jerr = jecdsa_dev.ecdsa_verify_batched(
        name, *(jnp.asarray(rows[k].astype(np.uint32)) for k in ("pub_x", "pub_y", "sig", "msg")))
    assert valid.tolist() == np.asarray(jvalid).tolist()
    assert err.tolist() == np.asarray(jerr).tolist()
    assert valid.tolist() == [ok and not bad for _, _, ok, bad in planted]
