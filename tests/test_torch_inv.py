"""The wide inversion by constant-time divsteps (``csrc/inv.cuh``), its plain
version against Python ints.

``fields/kernels.py::mont_inv_divsteps_plain`` runs the kernel's 20 batches of
30 divsteps and its updates of (f, g) and (d, e) in int64 tensor ops.  Held to
``pow(x R^-1, -1, M) R mod M`` (0 for 0) on the four wide moduli (the base
fields and group orders of secp256k1 and secp256r1) and BN254's r, over the
edge lanes 0, R (one), M - 1, 1, 2, R^-1, the longest divstep run found among
seeded draws, and 64 seeded random values.  The JAX package's wide
``LimbContext.mont_inv`` is held to the port's CPU route in
``tests/test_torch_ecdsa.py``; the C of the kernel runs on the CPU in
``tests/test_torch_inv_c.py`` and on the card in ``tests/test_torch_gpu.py``.
"""

from __future__ import annotations

import random

import pytest
import torch

from acvm_tpu_torch.fields import kernels as fk
from acvm_tpu_torch.fields.params import BN254_FR
from acvm_tpu_torch.fields.torch_ops import LimbContext
from acvm_tpu_torch.gpu import ecdsa

FIELDS = [f for curve in ("secp256k1", "secp256r1") for f in ecdsa.curve_fields(curve)] + [BN254_FR]
IDS = [f.name for f in FIELDS]


def inv_cases(params, seed=1, draws=300):
    """The edge lanes, the longest divstep run among ``draws`` seeded values,
    and 64 seeded random values, all canonical."""
    m, R = params.modulus, params.r
    rng = random.Random(seed)
    pool = [rng.randrange(m) for _ in range(draws)]
    longest = max(pool, key=lambda x: fk.divsteps_to_zero(x, m))
    return [0, R, m - 1, 1, 2, pow(R, -1, m), longest] + [rng.randrange(m) for _ in range(64)]


def inverses(xs, params):
    """a^-1 R for each a R, 0 for 0, in Python ints."""
    m, R = params.modulus, params.r
    r_inv = pow(R, -1, m)
    return [pow(x * r_inv, -1, m) * R % m if x else 0 for x in xs]


def as_limbs(xs):
    return torch.from_numpy(fk.ints_to_limbs32(xs).copy())


@pytest.mark.parametrize("params", FIELDS, ids=IDS)
def test_divsteps_plain_equals_ints(params):
    xs = inv_cases(params)
    got = fk.mont_inv_divsteps_plain(as_limbs(xs), params)
    assert fk.limbs32_to_ints(got.numpy()) == inverses(xs, params)
    # any leading shape
    assert torch.equal(fk.mont_inv_divsteps_plain(as_limbs(xs[:6]).reshape(2, 3, 8), params),
                       got[:6].reshape(2, 3, 8))


@pytest.mark.parametrize("params", FIELDS, ids=IDS)
def test_runs_stay_inside_the_kernels_600_divsteps(params):
    """Every case's run to g = 0 is at most 590 divsteps (the bound the
    header cites for inputs below 2^256); the kernel runs 600."""
    m = params.modulus
    runs = [fk.divsteps_to_zero(x, m) for x in inv_cases(params)]
    assert runs[0] == 0 and max(runs) <= 590 < fk.INV_BATCHES * 30


@pytest.mark.parametrize("params", FIELDS, ids=IDS)
def test_mont_inv_routes_on_the_cpu(params):
    """A wide field's CPU route is the divstep plain version, a narrow
    field's the Fermat chain's; both equal the ints, and LimbContext's
    mont_inv is the wrapper's."""
    xs = inv_cases(params, seed=2, draws=10)[:16]  # the narrow route's plain chain is slow
    a = as_limbs(xs)
    want = inverses(xs, params)
    assert fk.limbs32_to_ints(fk.mont_inv(a, params).numpy()) == want
    if fk.is_wide(params):
        assert torch.equal(fk.mont_inv(a, params), fk.mont_inv_divsteps_plain(a, params))
    else:
        assert torch.equal(fk.mont_inv(a, params), fk.mont_pow_plain(a, params.modulus - 2, params))
    assert fk.limbs32_to_ints(LimbContext(params, "cpu").mont_inv(a).numpy()) == want


def test_inv_constants_are_the_fields_words():
    for params in FIELDS:
        words = [int(w) for w in fk.inv_constants(params)]
        m = params.modulus
        assert sum(w << (30 * i) for i, w in enumerate(words[:9])) == m
        assert sum(w << (30 * i) for i, w in enumerate(words[9:18])) == params.r2
        assert all(0 <= w < 1 << 30 for w in words) and words[18] * m % (1 << 30) == 1
