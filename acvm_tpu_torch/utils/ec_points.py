"""Grumpkin point panels for tests and smoke runs, from a seed.

A complete-addition routine has to be held on the pairs where the generic
formula breaks down; :func:`exceptional_pairs` builds them with Python ints.
:func:`window_entry_panel` makes a bulk panel the way the solver does: random
window digits gathered from a generator's table (digit 0 is infinity).
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

from ..blackbox.ec import grumpkin
from ..fields.kernels import LIMBS, int_to_limbs32
from ..fields.params import BN254_FR

CASES = (
    "generic", "generic_z", "equal", "equal_other_z", "negative", "negative_other_z",
    "p_infinity", "q_infinity", "both_infinity",
)


def mont_jacobian(point, z: int, junk: Tuple[int, int] = (0, 0)) -> np.ndarray:
    """Affine ``point`` (None = infinity) as the (3, 8) int32 Montgomery-form
    Jacobian triple with Z = ``z``: (x z^2, y z^3, z).  Infinity is Z = 0 with
    ``junk`` as X and Y (its coordinates carry no meaning, and a complete
    addition must not read one)."""
    p, r = BN254_FR.modulus, BN254_FR.r
    if point is None:
        x, y, z = junk[0], junk[1], 0
    else:
        x, y = point[0] * z * z % p, point[1] * z * z * z % p
    return np.stack([int_to_limbs32(v * r % p) for v in (x, y, z)])


def exceptional_pairs(seed: int = 5) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """One (case name, P, Q) per entry of :data:`CASES`, each point a (3, 8)
    array: generic pairs (Z = 1 and random Z), P = Q and P = -Q (the same Z
    and two different Z), either or both at infinity (with junk in X, Y)."""
    rng = random.Random(seed)
    p = BN254_FR.modulus

    def z():
        return rng.randrange(1, p)

    a = grumpkin.mul_g(rng.randrange(1, grumpkin.params.n))
    b = grumpkin.mul_g(rng.randrange(1, grumpkin.params.n))
    junk = (rng.randrange(p), rng.randrange(p))
    za = z()
    pairs = {
        "generic": (mont_jacobian(a, 1), mont_jacobian(b, 1)),
        "generic_z": (mont_jacobian(a, z()), mont_jacobian(b, z())),
        "equal": (mont_jacobian(a, za), mont_jacobian(a, za)),
        "equal_other_z": (mont_jacobian(a, z()), mont_jacobian(a, z())),
        "negative": (mont_jacobian(a, za), mont_jacobian(grumpkin.neg(a), za)),
        "negative_other_z": (mont_jacobian(a, z()), mont_jacobian(grumpkin.neg(a), z())),
        "p_infinity": (mont_jacobian(None, 0, junk), mont_jacobian(b, z())),
        "q_infinity": (mont_jacobian(a, z()), mont_jacobian(None, 0, junk)),
        "both_infinity": (mont_jacobian(None, 0, junk), mont_jacobian(None, 0)),
    }
    return [(name, *pairs[name]) for name in CASES]


def exceptional_panel(batch: int, seed: int = 5) -> np.ndarray:
    """A (2, 3, batch, 8) int32 panel whose lane b holds the pair of case
    ``CASES[b % len(CASES)]``: point 0 is P, point 1 is Q."""
    pairs = exceptional_pairs(seed)
    panel = np.zeros((2, 3, batch, LIMBS), dtype=np.int32)
    for b in range(batch):
        _, P, Q = pairs[b % len(pairs)]
        panel[0, :, b], panel[1, :, b] = P, Q
    return panel


def window_entry_panel(table: np.ndarray, points: int, batch: int, seed: int = 11) -> np.ndarray:
    """(points, 3, batch, 8) int32: point n of lane b is the entry of window
    ``n % W`` for a random 4-bit digit, as the first round of an MSM tree sees
    them (one entry in 16 is infinity)."""
    rng = np.random.default_rng(seed)
    windows = table.shape[0]
    digits = rng.integers(0, table.shape[1], size=(points, batch))
    entries = table[np.arange(points)[:, None] % windows, digits]  # (points, batch, 3, 8)
    return np.ascontiguousarray(entries.transpose(0, 2, 1, 3))
