"""The port's fused level against `fused_level_jnp` and Python ints, on the CPU.

The same seeded panel and descriptor go through the JAX package's vectorized
twin of its level kernel (B = 128, S = 1) and through the port's level call
(its plain version: the panel is a CPU tensor); `acvm_tpu_torch.convert`
carries panel and descriptor across.  Tolerance 0: integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acvm_tpu.fields.limbs import ints_to_limbs
from acvm_tpu.fields.params import BN254_FR
from acvm_tpu.tpu import fused_level as jfl

from acvm_tpu_torch import convert
from acvm_tpu_torch.fields import kernels as fk
from acvm_tpu_torch.fields import params as tparams
from acvm_tpu_torch.gpu import fused_level as tfl

P = BN254_FR.modulus
R = 1 << 256
R_INV = pow(R, -1, P)
B = 128
NW = 48


def rand_ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def jax_desc(lin_idx, mul_idx, out_idx, lin_c, mul_c, qc):
    """The JAX package's (DW, E) descriptor from index arrays and int
    coefficients (lists of lists)."""
    E = len(out_idx)
    t1 = lin_idx.shape[1]
    t2 = mul_idx.shape[1]
    num = dict(
        lin_idx=lin_idx, mul_idx=mul_idx,
        lin_coeff=ints_to_limbs([c for row in lin_c for c in row]).reshape(E, t1, 16),
        mul_coeff=ints_to_limbs([c for row in mul_c for c in row]).reshape(E, t2, 16),
        qc=ints_to_limbs(qc),
    )
    return jfl.pack_level_desc(dict(num=num, u_idx=np.asarray(out_idx, np.int32)), scratch_row=NW - 1)


def run_both(W_ints, desc, t1, t2, jit=True):
    """-> (port rows, JAX rows) of the whole panel after the level, as ints
    [witness][instance]."""
    W16 = ints_to_limbs([v for row in W_ints for v in row]).reshape(NW, B, 16)
    W_rows = jnp.asarray(np.ascontiguousarray(W16.transpose(0, 2, 1)).reshape(NW, 16, 1, B))
    fn = lambda W, d: jfl.fused_level_jnp(W, d, BN254_FR, t1, t2)
    if jit:
        fn = jax.jit(fn)
    want = convert.panel_from_jax(np.asarray(fn(W_rows, jnp.asarray(desc))))
    panel = torch.from_numpy(convert.panel_from_jax(np.asarray(W_rows)))
    tdesc = torch.from_numpy(convert.level_desc_from_jax(desc, t1, t2))
    assert tdesc.shape == (desc.shape[1], tfl.desc_width(t1, t2))
    got = tfl.fused_level_call(panel, tdesc, tparams.BN254_FR, t1, t2)
    assert got is panel  # in place
    return got.numpy(), want


def gate_value(W_ints, b, lin, mul, qc):
    acc = qc
    for c, i in lin:
        acc += c * W_ints[i][b] * R_INV
    for c, i, j in mul:
        acc += c * W_ints[i][b] * W_ints[j][b] * R_INV * R_INV
    return acc % P


WIDE_T1 = [15, 18, 19, 32]
N_RANDOM = 6


@pytest.fixture(scope="module")
def level():
    """One level of eleven gates, packed to the widest (32 linear terms, one
    product) as the solver packs ragged gates:

    * gates 0-5: two random linear terms and one random product, some with a
      zero (padding) coefficient;
    * gates 6-9: 15, 18, 19 and 32 linear terms with every coefficient and
      every operand p - 1.  The JAX package's TPU kernels pick a lazy
      one-chain sum whose bound fails from 18 terms on; its jnp twin is right,
      and so must the port be.
    * gate 10: two linear terms and one product with every coefficient and
      every operand p - 1: the largest values the common shape can meet.  The
      port's CUDA level kernel adds the three products of such a gate
      unreduced and reduces once (it runs only on a card; this pins the value
      it is held to there).

    The jnp twin runs ONCE, un-jitted and with the unrolled multiply (the
    32-term program takes most of a minute to compile on a CPU)."""
    t1, t2 = max(WIDE_T1), 1
    E = N_RANDOM + len(WIDE_T1) + 1
    rng = np.random.default_rng(21)
    W_ints = [rand_ints(100 + w, B) for w in range(NW)]
    W_ints[0] = [0] * B
    for w in range(1, 21):
        W_ints[w] = [P - 1] * B
    lin_idx = np.zeros((E, t1), np.int32)
    mul_idx = np.zeros((E, t2, 2), np.int32)
    lin_c = [[0] * t1 for _ in range(E)]
    mul_c = [[0] * t2 for _ in range(E)]
    lin_idx[:N_RANDOM, :2] = rng.integers(0, 30, size=(N_RANDOM, 2))
    mul_idx[:N_RANDOM] = rng.integers(0, 30, size=(N_RANDOM, t2, 2))
    for e in range(N_RANDOM):
        lin_c[e][:2] = rand_ints(200 + e, 2)
        mul_c[e] = rand_ints(300 + e, t2)
    lin_c[1][1] = 0  # padding terms inside the random gates too
    mul_c[2][0] = 0
    for g, n in enumerate(WIDE_T1):
        lin_idx[N_RANDOM + g, :n] = 1 + (np.arange(n) % 20)
        lin_c[N_RANDOM + g][:n] = [P - 1] * n
    lin_idx[E - 1, :2] = [1, 2]
    lin_c[E - 1][:2] = [P - 1, P - 1]
    mul_idx[E - 1, 0] = [3, 4]
    mul_c[E - 1][0] = P - 1
    qc = rand_ints(400, N_RANDOM) + [P - 1] * (len(WIDE_T1) + 1)
    out_idx = list(range(30, 30 + E))
    desc = jax_desc(lin_idx, mul_idx, out_idx, lin_c, mul_c, qc)
    return dict(W=W_ints, desc=desc, lin_idx=lin_idx, mul_idx=mul_idx,
                out_idx=out_idx, lin_c=lin_c, mul_c=mul_c, qc=qc, t1=t1, t2=t2)


@pytest.fixture(scope="module")
def solved(level):
    import os

    old = os.environ.get("ACVM_TPU_COMPACT_MUL")
    os.environ["ACVM_TPU_COMPACT_MUL"] = "0"  # same bits, no loop to compile per call
    try:
        got, want = run_both(level["W"], level["desc"], level["t1"], level["t2"], jit=False)
    finally:
        if old is None:
            del os.environ["ACVM_TPU_COMPACT_MUL"]
        else:
            os.environ["ACVM_TPU_COMPACT_MUL"] = old
    return got, want


def test_level_matches_jnp_twin(solved):
    got, want = solved
    assert np.array_equal(got, want)


@pytest.mark.parametrize("gate", range(N_RANDOM))
def test_level_gate_matches_ints(level, solved, gate):
    c = level
    row = fk.limbs32_to_ints(solved[0][c["out_idx"][gate]])
    for b in (0, 1, 77, B - 1):
        lin = [(c["lin_c"][gate][t], int(c["lin_idx"][gate, t])) for t in range(2)]
        mul = [(c["mul_c"][gate][t], int(c["mul_idx"][gate, t, 0]), int(c["mul_idx"][gate, t, 1]))
               for t in range(c["t2"])]
        assert row[b] == gate_value(c["W"], b, lin, mul, c["qc"][gate])


@pytest.mark.parametrize("gate,n_terms", list(enumerate(WIDE_T1)))
def test_wide_gate_matches_jnp_twin_and_ints(level, solved, gate, n_terms):
    """Tolerance 0, against the jnp twin and against Python ints."""
    got, want = solved
    row = level["out_idx"][N_RANDOM + gate]
    assert np.array_equal(got[row], want[row])
    # qc + n * (p-1)*(p-1)*R^-1  with qc = p - 1
    value = ((P - 1) + n_terms * (P - 1) * (P - 1) * R_INV) % P
    assert fk.limbs32_to_ints(got[row]) == [value] * B


def test_three_term_gate_at_p_minus_1_matches_jnp_twin_and_ints(level, solved):
    """Two linear terms and a product, all at p - 1.  Tolerance 0."""
    got, want = solved
    row = level["out_idx"][-1]
    assert np.array_equal(got[row], want[row])
    value = gate_value(level["W"], 0, [(P - 1, 1), (P - 1, 2)], [(P - 1, 3, 4)], P - 1)
    assert fk.limbs32_to_ints(got[row]) == [value] * B


def test_level_leaves_other_rows_alone(level, solved):
    before = fk.ints_to_limbs32([v for row in level["W"] for v in row]).reshape(NW, B, 8)
    untouched = [w for w in range(NW) if w not in level["out_idx"]]
    assert np.array_equal(solved[0][untouched], before[untouched])


def test_truncated_pack_and_gate_chunks_agree(level, solved):
    """The random gates packed at their own width (t1 = 2) by the port's
    `pack_level_desc`, run through the plain version in gate chunks, give the
    rows the padded level gave."""
    c = level
    n = N_RANDOM
    panel = torch.from_numpy(
        fk.ints_to_limbs32([v for row in c["W"] for v in row]).reshape(NW, B, 8).copy())
    num = dict(
        lin_idx=c["lin_idx"][:n, :2], mul_idx=c["mul_idx"][:n],
        lin_coeff=fk.ints_to_limbs32([x for row in c["lin_c"][:n] for x in row[:2]]).reshape(n, 2, 8),
        mul_coeff=fk.ints_to_limbs32([x for row in c["mul_c"][:n] for x in row]).reshape(n, 1, 8),
        qc=fk.ints_to_limbs32(c["qc"][:n]),
    )
    desc = torch.from_numpy(
        tfl.pack_level_desc(dict(num=num, u_idx=np.asarray(c["out_idx"][:n], np.int32))))
    tfl.fused_level_plain(panel, desc, tparams.BN254_FR, 2, 1, gate_chunk=4)
    rows = c["out_idx"][:n]
    assert np.array_equal(panel.numpy()[rows], solved[0][rows])


def test_constant_only_level():
    E = 3
    W_ints = [rand_ints(500 + w, B) for w in range(NW)]
    qc = [0, P - 1, rand_ints(501, 1)[0]]
    desc = jax_desc(np.zeros((E, 0), np.int32), np.zeros((E, 0, 2), np.int32),
                    [5, 6, 7], [[]] * E, [[]] * E, qc)
    got, want = run_both(W_ints, desc, 0, 0)
    assert np.array_equal(got, want)
    for e in range(E):
        assert fk.limbs32_to_ints(got[5 + e]) == [qc[e]] * B


def test_desc_roundtrip_and_checks():
    rng = np.random.default_rng(3)
    t1, t2, E = 2, 1, 4
    d8 = rng.integers(0, 1 << 31, size=(E, tfl.desc_width(t1, t2))).astype(np.int32)
    d16 = convert.level_desc_to_jax(d8, t1, t2)
    assert d16.shape == (jfl.desc_width(t1, t2), E)
    assert np.array_equal(convert.level_desc_from_jax(d16, t1, t2), d8)
    panel = torch.zeros((4, 2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        tfl.fused_level_call(panel, torch.zeros((1, 3), dtype=torch.int32), tparams.BN254_FR, t1, t2)
    with pytest.raises(TypeError):
        tfl.fused_level_call(panel.to(torch.int64), torch.from_numpy(d8), tparams.BN254_FR, t1, t2)
