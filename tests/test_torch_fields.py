"""The port's field layer against the JAX package and Python ints, on the CPU.

Seeded numpy inputs go through `acvm_tpu.fields.jnp_ops.LimbContext` (its jnp
path) and `acvm_tpu_torch.fields.torch_ops.LimbContext` (the kernels' plain
versions: the tensors are CPU tensors); `acvm_tpu_torch.convert` carries the
limb arrays across.  Tolerance 0 everywhere: these are integers.

The JAX side is jitted as ONE program per field (plus one for batch inversion),
and the expression dot runs un-jitted, so the file compiles a handful of programs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvm_tpu.fields import jnp_ops
from acvm_tpu.fields.limbs import ints_to_limbs
from acvm_tpu.fields.params import BLS12_381_FR, BN254_FR
from acvm_tpu.tpu.batch_solver import eval_exprs as jax_eval_exprs

from acvm_tpu_torch import convert
from acvm_tpu_torch.fields import kernels as fk
from acvm_tpu_torch.fields import params as tparams
from acvm_tpu_torch.fields.torch_ops import LimbContext
from acvm_tpu_torch.gpu.batch_solver import eval_exprs

FIELDS = {"bn254": (BN254_FR, tparams.BN254_FR), "bls12_381": (BLS12_381_FR, tparams.BLS12_381_FR)}
R = 1 << 256
N = 16


def rand_ints(seed: int, n: int, p: int):
    """n seeded values < p, the edge values 0, 1, p-1 first."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def to_torch(ints):
    return torch.from_numpy(fk.ints_to_limbs32(ints).copy())


def from_torch(t):
    return fk.limbs32_to_ints(t.numpy())


def from_jax(a):
    return fk.limbs32_to_ints(convert.limbs16_to_limbs32(np.asarray(a)))


@pytest.fixture(scope="module", params=sorted(FIELDS))
def field(request):
    """Both packages' results of every elementwise op on the same inputs."""
    jparams, params = FIELDS[request.param]
    p = params.modulus
    a, b = rand_ints(1, N, p), rand_ints(2, N, p)
    b[:3] = [p - 1, p - 1, p - 1]
    jctx = jnp_ops.LimbContext(jparams)

    @jax.jit
    def jax_ops(x, y):
        return dict(
            add=jctx.add(x, y), sub=jctx.sub(x, y), neg=jctx.neg(x),
            mont_mul=jctx.mont_mul(x, y), mont_sq=jctx.mont_sq(x),
            to_mont=jctx.to_mont(x), from_mont=jctx.from_mont(x),
            mont_inv=jctx.mont_inv(x),
        )

    want = {k: from_jax(v) for k, v in jax_ops(
        jnp.asarray(ints_to_limbs(a)), jnp.asarray(ints_to_limbs(b))).items()}
    ctx = LimbContext(params, device="cpu")
    ta, tb = to_torch(a), to_torch(b)
    got = dict(
        add=ctx.add(ta, tb), sub=ctx.sub(ta, tb), neg=ctx.neg(ta),
        mont_mul=ctx.mont_mul(ta, tb), mont_sq=ctx.mont_sq(ta),
        to_mont=ctx.to_mont(ta), from_mont=ctx.from_mont(ta),
        mont_inv=ctx.mont_inv(ta),
    )
    r_inv = pow(R, -1, p)
    ints = dict(
        add=[(x + y) % p for x, y in zip(a, b)],
        sub=[(x - y) % p for x, y in zip(a, b)],
        neg=[-x % p for x in a],
        mont_mul=[x * y * r_inv % p for x, y in zip(a, b)],
        mont_sq=[x * x * r_inv % p for x in a],
        to_mont=[x * R % p for x in a],
        from_mont=[x * r_inv % p for x in a],
        mont_inv=[pow(x, -1, p) * R * R % p if x else 0 for x in a],
    )
    return dict(params=params, ctx=ctx, a=a, b=b, ta=ta, tb=tb,
                got={k: from_torch(v) for k, v in got.items()}, jax=want, ints=ints)


@pytest.mark.parametrize(
    "op", ["add", "sub", "neg", "mont_mul", "mont_sq", "to_mont", "from_mont", "mont_inv"]
)
def test_limb_op_matches_jax_and_ints(field, op):
    assert field["got"][op] == field["jax"][op]
    assert field["got"][op] == field["ints"][op]


def test_inverse_of_zero_is_zero(field):
    assert field["a"][0] == 0 and field["got"]["mont_inv"][0] == 0


def test_predicates(field):
    ctx, ta, tb = field["ctx"], field["ta"], field["tb"]
    assert ctx.is_zero(ta).tolist() == [x == 0 for x in field["a"]]
    assert ctx.eq(ta, tb).tolist() == [x == y for x, y in zip(field["a"], field["b"])]
    assert ctx.eq(ta, ta.clone()).all()


def test_unreduced_product_is_below_2p(field):
    p = field["params"].modulus
    got = from_torch(fk.mont_mul(field["ta"], field["tb"], field["params"], reduce=False))
    assert all(g < 2 * p and g % p == w for g, w in zip(got, field["ints"]["mont_mul"]))


def test_mul_broadcasts_a_single_element(field):
    ctx = field["ctx"]
    got = from_torch(ctx.mont_mul(field["ta"].reshape(4, 4, 8), ctx.r2_limbs))
    assert got == field["ints"]["to_mont"]


@pytest.mark.parametrize(
    "exponent", [0, 1, 2, 16, 0xF0, 0xDEADBEEF12345, (1 << 256) - 1, "p-2"])
def test_pow_matches_ints(field, exponent):
    p = field["params"].modulus
    if exponent == "p-2":
        exponent = p - 2
    r_inv = pow(R, -1, p)
    got = from_torch(fk.mont_pow(field["ta"], exponent, field["params"]))
    # Montgomery form in, Montgomery form out; zero bases map to zero.
    want = [pow(x * r_inv, exponent, p) * R % p if x else 0 for x in field["a"]]
    assert got == want


@pytest.mark.parametrize(
    "exponent", [0, 1, 2, 15, 16, "bn254 p-2", "bls12_381 p-2", (1 << 256) - 1])
def test_pow_schedule_reproduces_exponent(exponent):
    """The host's sliding-window schedule, replayed on exponents instead of
    powers, gives its exponent back; windows are odd and at most 4 bits."""
    if isinstance(exponent, str):
        exponent = FIELDS[exponent.split()[0]][1].modulus - 2
    first, steps, tail = fk.pow_schedule(exponent)
    if exponent == 0:
        assert (first, steps, tail) == (-1, [], 0) and fk.pow_chain_products(0) == 0
        return
    e = 2 * first + 1
    for squarings, entry in steps:
        assert squarings >= 1 and 0 <= entry < 8
        e = (e << squarings) + 2 * entry + 1
    assert e << tail == exponent
    assert len(steps) < fk.POW_MAX_WINDOWS
    words = fk.pow_schedule_words(exponent)
    assert list(words[:3]) == [first, len(steps), tail]
    assert [(int(w) >> 16, int(w) & 0xFFFF) for w in words[3 : 3 + len(steps)]] == steps
    if exponent == tparams.BN254_FR.modulus - 2:
        # 10 table products, 252 squarings, 49 multiplies (fixed windows: 335)
        assert fk.pow_chain_products(exponent) == 311


@functools.lru_cache(maxsize=None)
def jax_batch_inv_axis0():
    """The JAX batch inversion along axis 0 over BN254, jitted once: every
    (3, 4) case below shares its one compile."""
    jctx = jnp_ops.LimbContext(BN254_FR)
    return jax.jit(lambda x: jctx.mont_batch_inv(x, axis=0))


def test_batch_inv_matches_jax_and_ints():
    """Zeros in the scanned axis invert to zero and leave their neighbours'
    inverses right; the JAX scan and the port's running products agree."""
    p = BN254_FR.modulus
    G, B = 3, 4  # a short axis keeps the JAX scan's compile small
    vals = rand_ints(3, G * B, p)
    vals[5] = vals[6] = vals[10] = 0  # with the leading 0: one column all but zero
    want = from_jax(jax_batch_inv_axis0()(jnp.asarray(ints_to_limbs(vals)).reshape(G, B, 16)))
    ctx = LimbContext(tparams.BN254_FR, device="cpu")
    got = from_torch(ctx.mont_batch_inv(to_torch(vals).reshape(G, B, 8), axis=0))
    assert got == want
    assert got == [pow(x, -1, p) * R * R % p if x else 0 for x in vals]
    # Chunks of 2: a zero opens chunk 0 of column 0 and closes it in column 2,
    # whose ragged chunk 1 (one row) is all zero; same bits as one chunk.
    chunked = ctx.mont_batch_inv(to_torch(vals).reshape(G, B, 8), axis=0, max_scan=2)
    assert from_torch(chunked) == want


@pytest.mark.parametrize(
    "zeros", [(1, 5, 7), (2, 6, 3, 7, 11), (8, 9, 10, 11), tuple(range(8))],
    ids=["chunk_edges", "all_zero_chunk", "ragged_chunk", "all_zero_tile"])
def test_batch_inv_zero_patterns_match_jax(zeros):
    """(3, 4) along axis 0 in chunks of 2 (rows 0-1, then the ragged row 2):
    zeros at the first and last row of a chunk (column 1 all but row 2, and
    row 1 of column 3), a chunk of all zeros beside a column of them, a ragged
    chunk of all zeros, and chunk 0 of every column zero: the whole first
    tile of the kernel's plan (4 columns, a ragged tile of 32 lanes).  The port
    at chunks of 2, 1 and 3, the JAX scan (one chunk) and Python ints agree."""
    p = BN254_FR.modulus
    G, B = 3, 4
    vals = rand_ints(5, G * B, p)  # value 0 is zero already
    for k in zeros:
        vals[k] = 0
    want = from_jax(jax_batch_inv_axis0()(jnp.asarray(ints_to_limbs(vals)).reshape(G, B, 16)))
    assert want == [pow(x, -1, p) * R * R % p if x else 0 for x in vals]
    ctx = LimbContext(tparams.BN254_FR, device="cpu")
    for max_scan in (2, 1, 3):
        got = ctx.mont_batch_inv(to_torch(vals).reshape(G, B, 8), axis=0, max_scan=max_scan)
        assert from_torch(got) == want, max_scan


@pytest.mark.parametrize(
    "name,axis,max_scan,zeros",
    [("bn254", 0, 256, ()), ("bls12_381", 1, 256, ()), ("bn254", 0, 3, ()),
     ("bls12_381", -2, 4, ()),
     # (7, 3) in chunks of 3: zeros at the first and last row of a chunk
     # (column 1), chunk 1 of column 2 all zero, and the ragged last chunk
     ("bn254", 0, 3, (1 * 3 + 1, 3 * 3 + 1, 2 * 3 + 1, 3 * 3 + 2, 4 * 3 + 2, 5 * 3 + 2)),
     ("bls12_381", 0, 3, (6 * 3 + 0, 6 * 3 + 1, 3 * 3 + 0, 5 * 3 + 0)),
     # (3, 7) along axis 1 in chunks of 4: a ragged chunk of 3, all zero in row 2
     ("bn254", 1, 4, (2 * 7 + 4, 2 * 7 + 5, 2 * 7 + 6, 1 * 7 + 3, 1 * 7 + 4))],
)
def test_batch_inv_chunks_and_axes(name, axis, max_scan, zeros):
    params = FIELDS[name][1]
    p = params.modulus
    shape = {0: (7, 3), 1: (3, 7), -2: (3, 7)}[axis]
    vals = rand_ints(4, 21, p)
    for k in zeros:
        vals[k] = 0
    ctx = LimbContext(params, device="cpu")
    got = from_torch(ctx.mont_batch_inv(
        to_torch(vals).reshape(*shape, 8), axis=axis, max_scan=max_scan))
    assert got == [pow(x, -1, p) * R * R % p if x else 0 for x in vals]


def test_wide_modulus_is_refused():
    """A wide modulus (2p >= 2^256) runs in the wide mode of LimbContext (the
    ECDSA fields, tests/test_torch_ecdsa.py); the narrow-only kernels, and a
    product left unreduced, refuse it."""
    secp = tparams.FieldParams(
        "secp256k1", 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F)
    assert LimbContext(secp, device="cpu").wide
    assert fk.limbs32_to_ints(fk.field_words(secp)[:8]) == [secp.modulus]
    with pytest.raises(NotImplementedError, match="narrow only"):
        fk.require_narrow(secp, "level")
    z = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="narrow only"):
        fk.mont_dot(z[None, None], z[None], None, None, None, z, params=secp)
    with pytest.raises(ValueError, match="always reduces"):
        fk.mont_mul(z, z, secp, reduce=False)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LimbContext(tparams.BN254_FR)


# ---------------------------------------------------------------------------
# Expression dot: the plain version against the JAX eval_exprs (op-by-op path)
# ---------------------------------------------------------------------------

E, B, NW = 5, 8, 12
TMAX = 3
DOT_SHAPES = [(0, 0), (0, 1), (1, 0), (1, 1), (3, 0), (0, 3), (3, 1), (1, 3), (3, 3)]


def limbs16(obj_array):
    flat = ints_to_limbs(obj_array.reshape(-1))
    return flat.reshape(obj_array.shape + (16,))


@pytest.fixture(scope="module")
def dot_case():
    """One witness panel and, for every (t1, t2) of DOT_SHAPES, E expressions
    with t1 linear and t2 product terms.  The JAX side evaluates ALL of them in
    one `eval_exprs` call (and one more with `scale`): the groups are stacked
    along the gate axis and packed to TMAX terms with zero coefficients, which
    is how the solver packs ragged gates.  It runs un-jitted with the unrolled
    multiply: two calls are cheaper than one compile.  The port evaluates each
    group at its own width."""
    import os

    p = BN254_FR.modulus
    rng = np.random.default_rng(11)
    G = len(DOT_SHAPES) * E
    W = np.array(rand_ints(12, B * NW, p), dtype=object).reshape(B, NW)
    W[:, 0] = 0
    pack = dict(
        lin_idx=rng.integers(1, NW, size=(G, TMAX)).astype(np.int32),
        mul_idx=rng.integers(1, NW, size=(G, TMAX, 2)).astype(np.int32),
        lin_c=np.array(rand_ints(13, G * TMAX, p), dtype=object).reshape(G, TMAX),
        mul_c=np.array(rand_ints(14, G * TMAX, p), dtype=object).reshape(G, TMAX),
        qc=np.array(rand_ints(15, G, p), dtype=object),
        scale=np.array(rand_ints(16, G, p), dtype=object),
    )
    for k, (t1, t2) in enumerate(DOT_SHAPES):
        pack["lin_c"][k * E : (k + 1) * E, t1:] = 0
        pack["mul_c"][k * E : (k + 1) * E, t2:] = 0
    jctx = jnp_ops.LimbContext(BN254_FR)
    jpack = dict(
        lin_idx=jnp.asarray(pack["lin_idx"]), lin_coeff=jnp.asarray(limbs16(pack["lin_c"])),
        mul_idx=jnp.asarray(pack["mul_idx"]), mul_coeff=jnp.asarray(limbs16(pack["mul_c"])),
        qc=jnp.asarray(limbs16(pack["qc"])),
    )
    Wj = jnp.asarray(limbs16(W))
    old = os.environ.get("ACVM_TPU_COMPACT_MUL")
    os.environ["ACVM_TPU_COMPACT_MUL"] = "0"  # same bits, no loop to compile per call
    try:
        want = {
            False: np.asarray(jax_eval_exprs(jctx, Wj, jpack)),  # (B, G, 16)
            True: np.asarray(jax_eval_exprs(
                jctx, Wj, jpack, jnp.asarray(limbs16(pack["scale"])))),
        }
    finally:
        if old is None:
            del os.environ["ACVM_TPU_COMPACT_MUL"]
        else:
            os.environ["ACVM_TPU_COMPACT_MUL"] = old
    return W, pack, want


def port_eval_exprs(dot_case, t1, t2, with_scale, dot_kernel="v2"):
    """The port's `eval_exprs` on the group of DOT_SHAPES with t1 linear and t2
    product terms, packed at its own width."""
    W, pack, _ = dot_case
    k = DOT_SHAPES.index((t1, t2))
    g = slice(k * E, (k + 1) * E)
    ctx = LimbContext(tparams.BN254_FR, device="cpu")
    tpack = convert.pack_from_jax(dict(
        lin_idx=pack["lin_idx"][g, :t1], lin_coeff=limbs16(pack["lin_c"][g, :t1]),
        mul_idx=pack["mul_idx"][g, :t2], mul_coeff=limbs16(pack["mul_c"][g, :t2]),
        qc=limbs16(pack["qc"][g]),
    ))
    tpack = {key: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.int64 if key.endswith("_idx") else torch.int32) for key, v in tpack.items()}
    Wt = torch.from_numpy(convert.panel_from_jax(limbs16(W)))
    scale = to_torch(pack["scale"][g]) if with_scale else None
    return eval_exprs(ctx, Wt, tpack, scale, dot_kernel)


@pytest.mark.parametrize("with_scale", [False, True], ids=["noscale", "scale"])
@pytest.mark.parametrize("t1,t2", DOT_SHAPES)
def test_dot_matches_jax_eval_exprs_and_ints(dot_case, t1, t2, with_scale):
    W, pack, jax_want = dot_case
    p = BN254_FR.modulus
    r_inv = pow(R, -1, p)
    k = DOT_SHAPES.index((t1, t2))
    g = slice(k * E, (k + 1) * E)
    want = jax_want[with_scale][:, g]  # (B, E, 16)

    got = port_eval_exprs(dot_case, t1, t2, with_scale)  # (E, B, 8)
    assert got.shape == (E, B, 8)
    assert np.array_equal(
        convert.limbs32_to_limbs16(got.numpy()).transpose(1, 0, 2), want)

    # Python ints: coefficients are Montgomery-scaled (c*R, c*R^2), operands
    # standard form, every product a Montgomery product.
    for e in range(E):
        ge = k * E + e
        for b in range(B):
            acc = int(pack["qc"][ge])
            for t in range(t1):
                acc += int(pack["lin_c"][ge, t]) * int(W[b, pack["lin_idx"][ge, t]]) * r_inv
            for t in range(t2):
                i1, i2 = pack["mul_idx"][ge, t]
                acc += int(pack["mul_c"][ge, t]) * int(W[b, i1]) * int(W[b, i2]) * r_inv * r_inv
            if with_scale:
                acc = acc * int(pack["scale"][ge]) * r_inv
            assert fk.limbs32_to_ints(got[e, b].numpy())[0] == acc % p


# ---------------------------------------------------------------------------
# First generation: the v1 multiply and the v1 dot (products multiplied first)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_scale", [False, True], ids=["noscale", "scale"])
@pytest.mark.parametrize("t1,t2", DOT_SHAPES)
def test_dot_v1_route_matches_jax_eval_exprs(dot_case, t1, t2, with_scale):
    """`eval_exprs(dot_kernel="v1")` (`mont_mul_v1` of the quadratic operands,
    then `mont_dot_v1` over the joined panel) against the JAX `eval_exprs` (its
    jnp fold on a CPU) and against the default route."""
    k = DOT_SHAPES.index((t1, t2))
    want = dot_case[2][with_scale][:, k * E : (k + 1) * E]  # (B, E, 16)
    got = port_eval_exprs(dot_case, t1, t2, with_scale, dot_kernel="v1")
    assert np.array_equal(convert.limbs32_to_limbs16(got.numpy()).transpose(1, 0, 2), want)
    assert torch.equal(got, port_eval_exprs(dot_case, t1, t2, with_scale))


def dot_v1_ints(vals, coeff, qc, scale, p):
    """out[e][b] = [scale[e] *R] (qc[e] + sum_t coeff[e][t] *R vals[e][t][b])
    in Python ints; `*R` is the Montgomery product."""
    r_inv = pow(R, -1, p)
    out = []
    for e in range(len(qc)):
        for b in range(len(vals[e][0])):
            acc = qc[e]
            for t in range(len(coeff[e])):
                acc = (acc + coeff[e][t] * vals[e][t][b] * r_inv) % p
            out.append(acc * scale[e] * r_inv % p if scale is not None else acc)
    return out


@pytest.mark.parametrize("terms,with_scale", [(1, True), (3, False), (19, True), (32, False)])
def test_dot_v1_matches_ints(terms, with_scale):
    """Random operands; then every operand and coefficient p - 1, where a sum
    kept in one lazy chain would overflow from 18 terms on: each term joins
    with one modular add, so 19 and 32 are exact."""
    p = tparams.BN254_FR.modulus
    n_e, n_b = 3, 4
    for fill in (None, p - 1):
        def ints(seed, n):
            return [fill] * n if fill is not None else rand_ints(seed, n, p)
        vals = np.array(ints(21, n_e * terms * n_b), dtype=object).reshape(n_e, terms, n_b)
        coeff = np.array(ints(22, n_e * terms), dtype=object).reshape(n_e, terms)
        if fill is None and terms > 1:
            coeff[1, 0] = 0  # a padding term
        qc, scale = ints(23, n_e), (ints(24, n_e) if with_scale else None)
        got = fk.mont_dot_v1(
            to_torch(vals.reshape(-1)).reshape(n_e, terms, n_b, 8),
            to_torch(coeff.reshape(-1)).reshape(n_e, terms, 8), to_torch(qc),
            None if scale is None else to_torch(scale), tparams.BN254_FR)
        assert got.shape == (n_e, n_b, 8)
        assert from_torch(got) == dot_v1_ints(vals.tolist(), coeff.tolist(), qc, scale, p)


def test_dot_v1_refuses_bad_shapes():
    one = torch.zeros((2, 1, 3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="T >= 1"):
        fk.mont_dot_v1(one[:, :0], one[:, :0, 0], one[:, 0, 0])
    with pytest.raises(ValueError, match="coefficient shapes"):
        fk.mont_dot_v1(one, one[:, :, 0], one[:1, 0, 0])
    with pytest.raises(TypeError, match="int32 limbs"):
        fk.mont_dot_v1(one.to(torch.int64), one[:, :, 0], one[:, 0, 0])


@pytest.mark.parametrize("field", ["bn254"], indirect=True)
def test_mul_v1_matches_jax_mont_mul(field):
    """`mont_mul_v1` knows BN254 only (as its reference does); it broadcasts
    and flattens any two shapes, as `mont_mul_pallas_flex`."""
    ta, tb = field["ta"], field["tb"]
    assert from_torch(fk.mont_mul_v1(ta, tb)) == field["jax"]["mont_mul"]
    assert from_torch(fk.mont_mul_v1_plain(ta, tb)) == field["ints"]["mont_mul"]
    got = fk.mont_mul_v1(ta.reshape(4, 4, 8), field["ctx"].r2_limbs)
    assert got.shape == (4, 4, 8) and from_torch(got) == field["ints"]["to_mont"]
    with pytest.raises(TypeError, match="int32 limbs"):
        fk.mont_mul_v1(ta[:, :7], tb[:, :7])


def test_convert_roundtrips():
    rng = np.random.default_rng(5)
    a16 = rng.integers(0, 1 << 16, size=(3, 5, 16)).astype(np.uint32)
    a32 = convert.limbs16_to_limbs32(a16)
    assert a32.dtype == np.int32 and a32.shape == (3, 5, 8)
    assert np.array_equal(convert.limbs32_to_limbs16(a32), a16)
    # both JAX panel layouts <-> the port's panel
    Wb = rng.integers(0, 1 << 16, size=(128, 4, 16)).astype(np.uint32)  # (B, NW, 16)
    panel = convert.panel_from_jax(Wb)
    assert panel.shape == (4, 128, 8)
    assert np.array_equal(convert.panel_to_jax(panel, "batch"), Wb)
    rows = convert.panel_to_jax(panel, "rows")
    assert rows.shape == (4, 16, 1, 128)
    assert np.array_equal(convert.panel_from_jax(rows), panel)
    assert convert.panel_from_jax(Wb, num_witnesses=3).shape == (3, 128, 8)
    assert convert.panel_to_jax(panel, "batch", num_witnesses=5).shape == (128, 5, 16)
    pack = dict(lin_idx=np.zeros((2, 1), np.int32), lin_coeff=a16[:2, :1],
                mul_idx=np.zeros((2, 0, 2), np.int32), mul_coeff=a16[:2, :0], qc=a16[:2, 0])
    back = convert.pack_to_jax(convert.pack_from_jax(pack))
    assert all(np.array_equal(back[k], pack[k]) for k in pack)


PLAN_SHAPES = [(2048, 2048, 128), (2048, 2048, 64), (2048, 2048, 32), (2048, 2048, 256), (2, 16384, 2),
               (32, 32768, 32), (75, 300, 16), (75, 300, 7), (300, 100, 32), (1, 1, 5), (1, 4096, 1),
               (5, 33, 70), (1000, 3, 1000)]


def plan_coverage(G, L, plan):
    """How often the kernel's index arithmetic (csrc/batch_inv.cu) reaches
    each (row, column): block b takes chunk b // tiles of the column tile
    b % tiles; its lane l the column tile * lanes + l, if below L, over rows
    chunk * g to chunk * g + n - 1."""
    hits = np.zeros((G, L), dtype=np.int64)
    tiles = -(-L // plan.lanes)
    for block in range(plan.blocks):
        c, tile = divmod(block, tiles)
        cols = np.arange(tile * plan.lanes, (tile + 1) * plan.lanes)
        cols = cols[cols < L]
        rows = np.arange(c * plan.g, min(G, (c + 1) * plan.g))
        hits[np.ix_(rows, cols)] += 1
    return hits


# The multiprocessors of an H100 SXM and of an H100 PCIe.
PLAN_SMS = pytest.mark.parametrize("sms", [132, 114], ids=["sxm", "pcie"])


@PLAN_SMS
@pytest.mark.parametrize("G,L,max_scan", PLAN_SHAPES)
def test_batch_inv_plan_covers_every_value_once(G, L, max_scan, sms):
    """Every (row, column) of the panel falls in exactly one chunk of one
    block, whatever the plan's chunk and tile."""
    plan = fk.batch_inv_plan(G, L, max_scan, sms)
    assert plan.g == min(G, max_scan) and plan.blocks == -(-G // plan.g) * -(-L // plan.lanes)
    assert (plan_coverage(G, L, plan) == 1).all()


@PLAN_SMS
@pytest.mark.parametrize("G,L,max_scan", PLAN_SHAPES)
def test_batch_inv_plan_lanes_fill_the_card(G, L, max_scan, sms):
    """Lanes are a power of two from 32 to 256, the fewest that leave at most
    two blocks (two chains) an SM where the columns allow it."""
    plan = fk.batch_inv_plan(G, L, max_scan, sms)
    assert plan.lanes in (32, 64, 128, 256)
    chunks = -(-G // plan.g)
    if plan.lanes < fk.BATCH_INV_MAX_LANES and plan.lanes < L:
        assert plan.blocks <= 2 * sms
    if plan.lanes > 32:
        assert chunks * -(-L // (plan.lanes // 2)) > 2 * sms
    # the dyn level at its chunk: 32 chunks of 256 lanes, 256 chains
    assert fk.batch_inv_plan(2048, 2048, 64, 132) == (64, 256, 256)


def test_batch_inv_plan_refuses_empty_panels():
    for args in ((0, 5, 4, 132), (5, 0, 4, 132), (5, 5, 0, 132), (5, 5, 4, 0)):
        with pytest.raises(ValueError, match="positive"):
            fk.batch_inv_plan(*args)
