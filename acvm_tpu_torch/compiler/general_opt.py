"""GeneralOptimizer: drop zero-coefficient terms, merge duplicate mul terms.

Reference: acvm/src/compiler/optimizers/general.rs.
"""

from __future__ import annotations

from ..acir.expression import Expression
from ..fields.field import FieldElement


def optimize(expr: Expression) -> Expression:
    # Remove zero coefficients.
    mul_terms = [(c, l, r) for c, l, r in expr.mul_terms if not c.is_zero()]
    linear = [(c, w) for c, w in expr.linear_combinations if not c.is_zero()]

    # Merge mul terms over canonically-ordered witness pairs, preserving first
    # occurrence order (the reference uses an IndexMap).
    merged: dict = {}
    for c, w_l, w_r in mul_terms:
        pair = (w_l, w_r) if w_l <= w_r else (w_r, w_l)
        if pair in merged:
            merged[pair] = merged[pair] + c
        else:
            merged[pair] = c
    new_mul_terms = [(c, pair[0], pair[1]) for pair, c in merged.items()]

    return Expression(new_mul_terms, linear, expr.q_c)
