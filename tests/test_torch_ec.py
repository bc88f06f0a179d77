"""The port's Grumpkin gadgets against the JAX package, the sequential engine
and the host curve code, on the CPU.  Tolerance 0 everywhere: integers.

Seeded numpy inputs go through `acvm_tpu.tpu.ec` and `acvm_tpu_torch.gpu.ec`;
`acvm_tpu_torch.convert` carries point panels and window tables across.  On CPU
tensors the port's complete addition is `pt_add_pairs_plain` (the CUDA kernel
is held against that same function on the card, `tests/test_torch_gpu.py`).

What the JAX side costs decides the shape of this file.  XLA:CPU takes tens of
seconds to compile one program that inlines a complete addition, so:

* `ec.pt_add` runs over the JAX `LimbContext` with each field operation its own
  small jitted program (`JitOps`): the reference's function, op by op;
* the tree and the ladder are that `pt_add` applied in the pairing of
  `ec._tree_reduce_points` and the steps of `ec_pallas.scalar_mul_fused`
  (whose own `fori_loop` / `scan` would each compile the addition again);
* the solver-level comparisons, each of which compiles a whole JAX solve, are
  in `tests/test_torch_gadget_solver.py`.
"""

import hashlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvm_tpu.blackbox import grumpkin as jgk
from acvm_tpu.fields import jnp_ops
from acvm_tpu.fields.limbs import ints_to_limbs
from acvm_tpu.fields.params import BN254_FR as JBN254
from acvm_tpu.tpu import ec as jec, ec_pallas, gadgets as jgadgets

from acvm_tpu_torch import convert
from acvm_tpu_torch.blackbox import grumpkin as gk
from acvm_tpu_torch.blackbox.ec import grumpkin
from acvm_tpu_torch.fields import kernels as fk
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.fields.torch_ops import LimbContext
from acvm_tpu_torch.gpu import ec, ec_fused, gadgets, intops
from acvm_tpu_torch.utils.ec_points import (
    CASES, exceptional_pairs, exceptional_panel, window_entry_panel,
)

P, R = BN254_FR.modulus, BN254_FR.r
R_INV = pow(R, -1, P)
N_ORDER = grumpkin.params.n
G = grumpkin.generator()
LANES = len(CASES)  # every JAX call of this file has this many lanes: one compile an op
CTX = LimbContext(BN254_FR, device="cpu")
WINDOWS = 4  # truncated tables: scalars < 2^16


class JitOps:
    """The JAX LimbContext with each field operation its own jitted program."""

    def __init__(self):
        ctx = jnp_ops.LimbContext(JBN254)
        self.params, self.wide = ctx.params, ctx.wide
        self.mont_mul, self.add, self.sub = jax.jit(ctx.mont_mul), jax.jit(ctx.add), jax.jit(ctx.sub)
        self.is_zero = jax.jit(ctx.is_zero)


@pytest.fixture(scope="module")
def jax_add():
    """(3, LANES, 8) int32 P, Q -> P + Q by the JAX package's `ec.pt_add`."""
    jctx = JitOps()

    def add(Pn: np.ndarray, Qn: np.ndarray) -> np.ndarray:
        p = tuple(jnp.asarray(convert.limbs32_to_limbs16(c)) for c in Pn)
        q = tuple(jnp.asarray(convert.limbs32_to_limbs16(c)) for c in Qn)
        return np.stack([convert.limbs16_to_limbs32(np.asarray(c)) for c in jec.pt_add(jctx, p, q)])

    return add


def jax_tree(jax_add, panel: np.ndarray) -> np.ndarray:
    """(N, 3, LANES, 8) -> (3, LANES, 8) in the pairing of
    `ec._tree_reduce_points`: even + odd, an odd tail meets infinity."""
    pts = list(panel)
    while len(pts) > 1:
        if len(pts) % 2:
            pts.append(np.zeros_like(pts[0]))
        pts = [jax_add(a, b) for a, b in zip(pts[0::2], pts[1::2])]
    return pts[0]


def affine(point) -> list:
    """A Montgomery Jacobian point batch, (3, B, 8) array or triple of (B, 8)
    tensors -> per lane the affine (x, y) in Python ints, None at infinity."""
    X, Y, Z = (fk.limbs32_to_ints(np.asarray(c)) for c in point)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z * R_INV % P, -1, P)
        out.append((x * R_INV * zi * zi % P, y * R_INV * zi * zi * zi % P))
    return out


def host_sum(points):
    acc = None
    for pt in points:
        acc = grumpkin.add(acc, pt)
    return acc


def to_limbs(ints) -> torch.Tensor:
    return torch.from_numpy(fk.ints_to_limbs32(ints).copy())


# ---------------------------------------------------------------------------
# The complete addition
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def added(jax_add):
    panel = exceptional_panel(LANES)  # lane b holds case b
    got = ec_fused.pt_add_pairs_plain(torch.from_numpy(panel))
    assert got.shape == (1, 3, LANES, 8) and got.dtype == torch.int32
    return panel, got[0].numpy(), jax_add(panel[0], panel[1])


@pytest.mark.parametrize("case", CASES)
def test_pt_add_pairs_plain_matches_jax_pt_add(added, case):
    """X, Y and Z equal to `ec.pt_add`'s, not just the affine point; and the
    affine point equal to the host curve code's sum."""
    panel, got, want = added
    b = CASES.index(case)
    assert np.array_equal(got[:, b], want[:, b])
    p_aff, q_aff = affine(panel[0])[b], affine(panel[1])[b]
    assert affine(got)[b] == grumpkin.add(p_aff, q_aff)
    if case in ("negative", "negative_other_z", "both_infinity"):
        assert affine(got)[b] is None
    if case == "p_infinity":  # the other operand comes back limb for limb
        assert np.array_equal(got[:, b], panel[1][:, b])
    if case in ("q_infinity", "both_infinity"):
        assert np.array_equal(got[:, b], panel[0][:, b])


def test_exceptional_pairs_are_what_they_claim():
    for name, Pn, Qn in exceptional_pairs():
        p_aff, q_aff = affine(Pn[:, None])[0], affine(Qn[:, None])[0]
        if name.startswith("equal"):
            assert p_aff == q_aff and p_aff is not None
        if name.startswith("negative"):
            assert q_aff == grumpkin.neg(p_aff)
        if name.endswith("other_z"):
            assert not np.array_equal(Pn[2], Qn[2])


def test_pt_add_wrapper_on_cpu_tensors(added):
    panel, got, _ = added
    Pt, Qt = torch.from_numpy(panel[:1].copy()), torch.from_numpy(panel[1:].copy())
    assert np.array_equal(ec_fused.pt_add_panels(Pt, Qt)[0].numpy(), got)
    assert np.array_equal(ec_fused.pt_add_pairs(torch.from_numpy(panel))[0].numpy(), got)
    assert ec_fused.pt_add_panels(Pt, Qt, out=Pt) is Pt  # over an operand
    assert np.array_equal(Pt[0].numpy(), got)
    with pytest.raises(ValueError, match="odd"):
        ec_fused.pt_add_pairs(torch.from_numpy(panel[:1]))
    with pytest.raises(TypeError, match="point panel"):
        ec_fused.pt_add_panels(Pt[:, :2], Qt[:, :2])
    with pytest.raises(ValueError, match="differ"):
        ec_fused.pt_add_panels(Pt, Qt[:, :, :4])


def test_op_by_op_addition_of_general_curves_agrees(added):
    """`ec.pt_add` / `ec.pt_double` with `a_mont` (the route of a != 0 curves;
    a = 0 here) give the same group elements through dbl-2007-bl."""
    panel, got, _ = added
    p, q = (tuple(torch.from_numpy(panel[i, c].copy()) for c in range(3)) for i in (0, 1))
    a_zero = torch.zeros(8, dtype=torch.int32)
    assert affine(ec.pt_add(CTX, p, q, a_mont=a_zero)) == affine(got)
    plain = ec.pt_add(CTX, p, q)  # a = 0, over LimbContext ops
    assert all(np.array_equal(c.numpy(), g) for c, g in zip(plain, got))
    assert affine(ec.pt_double(CTX, p, a_mont=a_zero)) == affine(ec.pt_double(CTX, p))
    inf = ec.pt_infinity(CTX, (LANES,))
    assert ec.pt_is_inf(inf).all() and not ec.pt_is_inf(p)[0]


# ---------------------------------------------------------------------------
# The tree, tables, fixed-base and multi-scalar multiplication
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def table():
    return ec._window_table_np(G, WINDOWS)


def test_window_table_matches_jax_table(table):
    jtable = jec._window_table_np(G, WINDOWS)
    assert jtable.shape == (WINDOWS, 16, 3, 16)
    assert np.array_equal(convert.window_table_from_jax(jtable), table)
    assert np.array_equal(convert.window_table_to_jax(table), jtable)
    assert affine(table[2, 5][:, None])[0] == grumpkin.mul(5 << 8, G)
    assert not table[:, 0].any()  # digit 0 is infinity
    assert ec.window_table(G, WINDOWS, device="cpu").shape == (WINDOWS, 16, 3, 8)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_tree_matches_jax_tree(jax_add, table, n):
    panel = window_entry_panel(table, n, LANES, seed=n)
    panel[0, :, 3] = 0  # one more point at infinity
    got = ec_fused.tree_reduce_fused(CTX, torch.from_numpy(panel))
    want = jax_tree(jax_add, panel)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    want_aff = [host_sum(affine(panel[:, :, b].transpose(1, 0, 2))) for b in range(LANES)]
    assert affine(got) == want_aff
    if n == 5:  # the op-by-op tree of a != 0 curves pairs the same way
        general = ec._tree_reduce_points(CTX, torch.from_numpy(panel),
                                         a_mont=torch.zeros(8, dtype=torch.int32))
        assert affine(general) == want_aff


def test_point_panel_conversion_roundtrips():
    panel = exceptional_panel(LANES)
    X, Y, Z = convert.points_to_jax(panel)
    assert X.shape == (LANES, 2, 16) and X.dtype == np.uint32
    assert np.array_equal(convert.points_from_jax(X, Y, Z), panel)
    assert np.array_equal(convert.points_from_jax(X[:, 0], Y[:, 0], Z[:, 0]), panel[:1])


@pytest.fixture(scope="module")
def scalars16():
    rng = np.random.default_rng(3)
    vals = [int(v) for v in rng.integers(0, 1 << 16, size=LANES)]
    vals[:3] = [0, 1, 0xFFFF]
    return vals


def test_fixed_base_mul_matches_jax_and_host(jax_add, table, scalars16):
    s = to_limbs(scalars16)
    js = jnp.asarray(ints_to_limbs(scalars16))
    # digits and the gather, against the JAX functions
    jdigits = np.asarray(jec._window_digits(js))
    assert np.array_equal(ec._window_digits(s).numpy(), jdigits)
    jentries = np.asarray(jec._gather_window_entries(
        jnp.asarray(jec._window_table_np(G, WINDOWS)), jnp.asarray(jdigits[:, :WINDOWS])))
    entries = ec._gather_window_entries(
        torch.from_numpy(table.copy()), ec._window_digits(s)[:, :WINDOWS].T)
    want_panel = convert.points_from_jax(*(jentries[..., c, :] for c in range(3)))
    assert np.array_equal(entries.numpy(), want_panel)
    # the product: Jacobian coordinates of the reference's tree, affine of the host
    got = ec.fixed_base_mul(CTX, torch.from_numpy(table.copy()), s)
    want = jax_tree(jax_add, want_panel)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    assert affine(got) == [grumpkin.mul(v, G) if v else None for v in scalars16]


def test_msm_and_to_affine_match_jax_and_host(jax_add, scalars16):
    gens = [gk.derive_generator(0, i) for i in range(2)]
    assert gens == [jgk.derive_generator(0, i) for i in range(2)]
    tables = np.stack([ec._window_table_np(g, WINDOWS) for g in gens])
    s1, s2 = scalars16, scalars16[::-1]
    got = ec.msm_fixed_tables(CTX, torch.from_numpy(tables.copy()),
                              torch.stack([to_limbs(s1), to_limbs(s2)]))
    # generator-major entries, as `ec.msm_fixed_tables` of the JAX package orders them
    digits = ec._window_digits(torch.stack([to_limbs(s1), to_limbs(s2)]))[..., :WINDOWS]
    panel = np.stack([tables[g, w, digits[g, :, w].numpy()].transpose(1, 0, 2)
                      for g in range(2) for w in range(WINDOWS)])
    want = jax_tree(jax_add, panel)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    host = [grumpkin.add(grumpkin.mul(a, gens[0]), grumpkin.mul(b, gens[1]))
            for a, b in zip(s1, s2)]
    assert affine(got) == host
    # pt_to_affine: standard form out, infinity -> (0, 0); against the JAX function
    ax, ay = ec.pt_to_affine(CTX, got)
    assert list(zip(fk.limbs32_to_ints(ax.numpy()), fk.limbs32_to_ints(ay.numpy()))) == [
        (0, 0) if h is None else h for h in host]
    jctx = jnp_ops.LimbContext(JBN254)
    jx, jy = jax.jit(lambda p: jec.pt_to_affine(jctx, p))(
        tuple(jnp.asarray(convert.limbs32_to_limbs16(c)) for c in want))
    assert np.array_equal(convert.limbs16_to_limbs32(np.asarray(jx)), ax.numpy())
    assert np.array_equal(convert.limbs16_to_limbs32(np.asarray(jy)), ay.numpy())


def jax_ladder(jax_add, base: np.ndarray, scalars) -> np.ndarray:
    """(3, LANES, 8) base, LANES ints -> (3, LANES, 8): the steps of the
    reference's `scalar_mul_fused` (acc + acc, + base, select), MSB-first over
    all 256 bits, each addition the JAX package's `ec.pt_add`."""
    acc = np.zeros_like(base)
    for i in range(255, -1, -1):
        dbl = jax_add(acc, acc)
        add = jax_add(dbl, base)
        bit = np.array([(v >> i) & 1 for v in scalars], dtype=bool)[None, :, None]
        acc = np.where(bit, add, dbl)
    return acc


# The affine ladder's lanes: one base in lanes 0-4 (scalars 0, 1, n - 1 and two
# below n), and the Schnorr path's own shape in lanes 5-8: a public key a lane,
# affine (Z = R, as `gpu/ec.py` builds it), scalars uniform below n.
AFFINE_LANES = {"one_base": slice(0, 5), "schnorr": slice(5, LANES)}


@pytest.fixture(scope="module")
def affine_ladder(jax_add):
    """One ladder over the lanes of AFFINE_LANES through the port (its plain
    version), the JAX steps and the host curve code."""
    rng = random.Random(6)
    scalars = [0, 1, N_ORDER - 1] + [rng.randrange(N_ORDER) for _ in range(LANES - 3)]
    keys = [grumpkin.mul(987654321, G)] * 5 + [grumpkin.mul(rng.randrange(1, N_ORDER), G)
                                               for _ in range(LANES - 5)]
    base = np.stack([np.stack([fk.int_to_limbs32(v * R % P) for v in coord])
                     for coord in ([q[0] for q in keys], [q[1] for q in keys], [1] * LANES)])
    point = tuple(torch.from_numpy(c.copy()) for c in base)
    got = ec.scalar_mul(CTX, point, to_limbs(scalars))
    want = jax_ladder(jax_add, base, scalars)
    host = [grumpkin.mul(v, q) if v else None for v, q in zip(scalars, keys)]
    return point, scalars, np.stack([c.numpy() for c in got]), want, host


@pytest.mark.parametrize("keys", list(AFFINE_LANES))
def test_scalar_mul_matches_jax_ladder_and_host(affine_ladder, keys):
    """The 256-step ladder on full-width scalars (0, 1, the order minus one
    among them): the steps of the reference's `scalar_mul_fused` (acc + acc,
    + base, select) give the same X, Y and Z, and the host the same point,
    on one affine base and on a key a lane.  Tolerance 0."""
    assert ec_pallas.scalar_mul_fused.__doc__  # the function these steps mirror
    point, scalars, got, want, host = affine_ladder
    lanes = AFFINE_LANES[keys]
    assert np.array_equal(got[:, lanes], want[:, lanes])
    assert affine(got)[lanes] == host[lanes]
    if keys == "one_base":  # the op-by-op ladder of a != 0 curves (a = 0 here): the same points
        general = ec.scalar_mul(CTX, tuple(c[2:5] for c in point), to_limbs(scalars[2:5]),
                                a_mont=torch.zeros(8, dtype=torch.int32))
        assert affine(general) == host[2:5]


# One lane each: (scalar, which point of `exceptional_pairs` is the base).  The
# ladder takes the scalar's 256 bits as they come, so n, n + 1 and 2^256 - 1 run
# past the group order: n * P meets P = -Q in its last addition and ends at
# infinity, (n + 1) * P meets P = Q there, at another Z than the base's.
EDGE_LANES = {
    "zero": (0, "generic_z"),
    "one": (1, "generic_z"),
    "two": (2, "generic"),
    "order_minus_one": (N_ORDER - 1, "generic_z"),
    "order": (N_ORDER, "generic_z"),
    "order_plus_one": (N_ORDER + 1, "generic_z"),
    "all_ones": ((1 << 256) - 1, "equal_other_z"),
    "random_scalar": (random.Random(7).randrange(1 << 256), "generic_z"),
    "base_at_infinity": (random.Random(8).randrange(1 << 256), "p_infinity"),
}
assert len(EDGE_LANES) == LANES


@pytest.fixture(scope="module")
def edge_ladder(jax_add):
    """One ladder over the lanes of EDGE_LANES through the port (its plain
    version: CPU tensors), the JAX steps and the host curve code."""
    pairs = {name: Pn for name, Pn, _ in exceptional_pairs()}
    scalars = [k for k, _ in EDGE_LANES.values()]
    base = np.stack([pairs[which] for _, which in EDGE_LANES.values()], axis=1)  # (3, LANES, 8)
    point = tuple(torch.from_numpy(c.copy()) for c in base)
    got = ec_fused.scalar_mul_fused(CTX, point, to_limbs(scalars))
    want = jax_ladder(jax_add, base, scalars)
    host = [grumpkin.mul(k % N_ORDER, b) if b is not None and k % N_ORDER else None
            for k, b in zip(scalars, affine(base))]
    return np.stack([c.numpy() for c in got]), want, host


@pytest.mark.parametrize("lane", list(EDGE_LANES))
def test_scalar_mul_edge_lane_matches_jax_ladder_and_host(edge_ladder, lane):
    """Edge scalars and bases, a lane each: X, Y and Z equal to the JAX
    ladder's steps limb for limb, the affine point equal to the host curve
    code's.  Tolerance 0."""
    got, want, host = edge_ladder
    b = list(EDGE_LANES).index(lane)
    assert np.array_equal(got[:, b], want[:, b])
    assert affine(got)[b] == host[b]
    if lane in ("zero", "order", "base_at_infinity"):
        assert host[b] is None
    if lane == "base_at_infinity":  # nothing was ever added: the accumulator's zeros
        assert not got[:, b].any()


@pytest.mark.parametrize("B", [1, 3, 8, 33, 2050])
def test_ladder_geometry_covers_every_instance_once(B):
    """Four threads an instance, eight a one-warp block: every instance is
    one team of one block, the last block's teams past B are masked."""
    blocks, threads, masked = ec_fused.ladder_geometry(B)
    assert threads == ec_fused.LADDER_TEAMS * ec_fused.LADDER_TEAM_THREADS == 32
    lanes = np.arange(blocks * threads)
    instance = (lanes // threads) * ec_fused.LADDER_TEAMS + (lanes % threads) // ec_fused.LADDER_TEAM_THREADS
    live = instance < B
    assert np.array_equal(np.bincount(instance[live], minlength=B), np.full(B, 4))
    assert masked == (~live).sum() // 4 < ec_fused.LADDER_TEAMS


def test_scalar_mul_fused_refuses_other_scalars():
    point = tuple(torch.zeros((2, 8), dtype=torch.int32) for _ in range(3))
    with pytest.raises(TypeError, match="scalars"):
        ec_fused.scalar_mul_fused(CTX, point, torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(TypeError, match="scalars"):
        ec_fused.scalar_mul_fused(CTX, point, torch.zeros((2, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Bytes, the order reduction, BLAKE2s, integer ops
# ---------------------------------------------------------------------------


def test_bytes_and_mod_order_match_jax():
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, size=(2, 32))
    raw[1] = 0xFF  # 2^256 - 1: three conditional subtractions of the order's multiples
    limbs = ec.bytes_be_to_limbs(torch.from_numpy(raw))
    jlimbs = jec.bytes_be_to_limbs(jnp.asarray(raw, dtype=jnp.uint32))
    assert np.array_equal(convert.limbs32_to_limbs16(limbs.numpy()), np.asarray(jlimbs))
    ints = [int.from_bytes(bytes(row.tolist()), "big") for row in raw]
    assert fk.limbs32_to_ints(limbs.numpy()) == ints
    assert np.array_equal(ec.limbs_to_bytes_be(limbs).numpy(), raw)
    assert np.array_equal(np.asarray(jec.limbs_to_bytes_be(jlimbs)), raw)
    reduced = ec.mod_order(limbs, N_ORDER)
    assert np.array_equal(convert.limbs32_to_limbs16(reduced.numpy()),
                          np.asarray(jec.mod_order(jlimbs, N_ORDER)))
    assert fk.limbs32_to_ints(reduced.numpy()) == [v % N_ORDER for v in ints]
    edge = to_limbs([N_ORDER - 1, N_ORDER, 2 * N_ORDER + 5])
    assert fk.limbs32_to_ints(ec.mod_order(edge, N_ORDER).numpy()) == [N_ORDER - 1, 0, 5]


@pytest.mark.parametrize("length", [0, 10, 64, 70, 130])
def test_blake2s_matches_hashlib(length):
    rng = np.random.default_rng(length)
    msg = rng.integers(0, 256, size=(2, length))
    got = gadgets.blake2s_digest(torch.from_numpy(msg))
    assert got.shape == (2, 32)
    for row, digest in zip(msg, got.numpy()):
        assert bytes(digest.tolist()) == hashlib.blake2s(bytes(row.tolist())).digest()


def test_blake2s_matches_jax():
    msg = np.random.default_rng(70).integers(0, 256, size=(2, 70))
    want = np.asarray(jgadgets.blake2s_digest(jnp.asarray(msg, dtype=jnp.uint32)))
    assert np.array_equal(gadgets.blake2s_digest(torch.from_numpy(msg)).numpy(), want)


def test_intops_match_python_ints():
    rng = random.Random(4)
    M = 1 << 256
    a = [rng.randrange(M) for _ in range(6)] + [0, M - 1, 5, 1 << 255]
    b = [rng.randrange(M) for _ in range(6)] + [M - 1, 1, 5, 3]
    ta, tb = to_limbs(a), to_limbs(b)
    ints = lambda t: fk.limbs32_to_ints(t.numpy())  # noqa: E731
    assert ints(intops.int_add(ta, tb)) == [(x + y) % M for x, y in zip(a, b)]
    assert ints(intops.int_sub(ta, tb)) == [(x - y) % M for x, y in zip(a, b)]
    assert ints(intops.int_mul(ta, tb)) == [(x * y) % M for x, y in zip(a, b)]
    assert intops.int_geq(ta, tb).tolist() == [x >= y for x, y in zip(a, b)]
    assert intops.int_lt(ta, tb).tolist() == [x < y for x, y in zip(a, b)]
    assert intops.is_zero(ta).tolist() == [x == 0 for x in a]
    assert ints(intops.mask_to_bits(ta, 77)) == [x % (1 << 77) for x in a]
    for shift in (0, 1, 16, 37, 255, 300):
        assert ints(intops.shl_static(ta, shift)) == [(x << shift) % M for x in a]
        assert ints(intops.shr_static(ta, shift)) == [x >> shift for x in a]
    shifts = [0, 1, 15, 16, 17, 100, 255, 256, 300, 31]
    ts = torch.tensor(shifts)
    assert ints(intops.shl_dynamic(ta, ts)) == [(x << s) % M for x, s in zip(a, shifts)]
    assert ints(intops.shr_dynamic(ta, ts)) == [x >> s for x, s in zip(a, shifts)]
    small = [rng.randrange(1 << 40) for _ in range(9)] + [0]
    q, r = intops.long_divmod(to_limbs([x % (1 << 64) for x in a]), to_limbs(small), num_bits=64)
    assert ints(q) == [(x % (1 << 64)) // d if d else 0 for x, d in zip(a, small)]
    assert ints(r) == [(x % (1 << 64)) % d if d else 0 for x, d in zip(a, small)]


def test_inverse_helpers_match_ints(monkeypatch):
    vals = [0, 1, P - 1] + [random.Random(8).randrange(P) for _ in range(5)]
    t = to_limbs([v * R % P for v in vals])
    want = [pow(v, -1, P) * R % P if v else 0 for v in vals]
    assert fk.limbs32_to_ints(CTX.mont_inv_grouped(t).numpy()) == want
    # where the chunks alone fill the card the values fold into groups: same bits
    monkeypatch.setattr(LimbContext, "FOLD_LANES", 1)
    grouped = CTX.mont_inv_grouped(t, group=4)
    assert fk.limbs32_to_ints(grouped.numpy()) == want
    quotient = CTX.mont_div(t[3:], t[4:5])
    assert fk.limbs32_to_ints(quotient.numpy()) == [
        v * pow(vals[4], -1, P) * R % P for v in vals[3:]]
