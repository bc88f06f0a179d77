"""Arithmetic gate solver (reference: acvm/src/pwg/arithmetic.rs).

Partial-evaluates a degree-<=2 expression against the known witnesses, then
either checks satisfaction or solves for the single remaining unknown.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..acir.expression import Expression
from ..acir.witness import Witness, WitnessMap
from ..fields.field import FieldElement
from .errors import (
    ExpressionHasTooManyUnknowns,
    MissingAssignment,
    OpcodeResolutionError,
    UnsatisfiedConstrain,
)

# MulTerm outcome tags
_SOLVED = 0
_ONE_UNKNOWN = 1
_TOO_MANY = 2


def _solve_mul_term_helper(term, witness_map: WitnessMap):
    q_m, w_l, w_r = term
    l_val = witness_map.get(w_l)
    r_val = witness_map.get(w_r)
    if l_val is None and r_val is None:
        return (_TOO_MANY, None, None)
    if l_val is not None and r_val is not None:
        return (_SOLVED, q_m * l_val * r_val, None)
    if l_val is None:
        return (_ONE_UNKNOWN, q_m * r_val, w_l)
    return (_ONE_UNKNOWN, q_m * l_val, w_r)


def _solve_fan_in_term_helper(term, witness_map: WitnessMap):
    q_l, w_l = term
    value = witness_map.get(w_l)
    return None if value is None else q_l * value


class ArithmeticSolver:
    @staticmethod
    def evaluate(expr: Expression, witness_map: WitnessMap) -> Expression:
        """Partial evaluation against known witnesses (arithmetic.rs:212-239)."""
        result = Expression()
        for term in expr.mul_terms:
            tag, value, unknown = _solve_mul_term_helper(term, witness_map)
            if tag == _ONE_UNKNOWN:
                if not value.is_zero():
                    result.linear_combinations.append((value, unknown))
            elif tag == _TOO_MANY:
                if not term[0].is_zero():
                    result.mul_terms.append(term)
            else:
                result.q_c = result.q_c + value
        for term in expr.linear_combinations:
            value = _solve_fan_in_term_helper(term, witness_map)
            if value is not None:
                result.q_c = result.q_c + value
            elif not term[0].is_zero():
                result.linear_combinations.append(term)
        result.q_c = result.q_c + expr.q_c
        return result

    @staticmethod
    def _solve_fan_in_term(expr: Expression, witness_map: WitnessMap):
        """Returns ('satisfied', sum) | ('solvable', sum, (coeff, w)) |
        ('unsolvable',)."""
        unknown = None
        num_unknowns = 0
        total = FieldElement.zero()
        for term in expr.linear_combinations:
            value = _solve_fan_in_term_helper(term, witness_map)
            if value is not None:
                total = total + value
            else:
                unknown = term
                num_unknowns += 1
            if num_unknowns > 1:
                return ("unsolvable",)
        if num_unknowns == 0:
            return ("satisfied", total)
        return ("solvable", total, unknown)

    @staticmethod
    def solve(witness_map: WitnessMap, opcode: Expression) -> None:
        from .acvm import insert_value

        expr = ArithmeticSolver.evaluate(opcode, witness_map)

        if len(expr.mul_terms) == 0:
            mul = (_SOLVED, FieldElement.zero(), None)
        elif len(expr.mul_terms) == 1:
            mul = _solve_mul_term_helper(expr.mul_terms[0], witness_map)
        else:
            raise AssertionError(
                "Mul term in the arithmetic opcode must contain either zero or one term"
            )
        fan_in = ArithmeticSolver._solve_fan_in_term(expr, witness_map)

        mul_tag = mul[0]
        if mul_tag == _TOO_MANY or fan_in[0] == "unsolvable":
            raise ExpressionHasTooManyUnknowns(expr)

        if mul_tag == _ONE_UNKNOWN and fan_in[0] == "solvable":
            q, w1 = mul[1], mul[2]
            partial_sum, (b, w2) = fan_in[1], fan_in[2]
            if w1 == w2:
                total_sum = partial_sum + expr.q_c
                if (q + b).is_zero():
                    if not total_sum.is_zero():
                        raise UnsatisfiedConstrain()
                    return
                assignment = -(total_sum / (q + b))
                insert_value(w1, assignment, witness_map)
                return
            raise ExpressionHasTooManyUnknowns(expr)

        if mul_tag == _ONE_UNKNOWN and fan_in[0] == "satisfied":
            partial_prod, unknown_var = mul[1], mul[2]
            total_sum = fan_in[1] + expr.q_c
            if partial_prod.is_zero():
                if not total_sum.is_zero():
                    raise UnsatisfiedConstrain()
                return
            insert_value(unknown_var, -(total_sum / partial_prod), witness_map)
            return

        if mul_tag == _SOLVED and fan_in[0] == "satisfied":
            if not (mul[1] + fan_in[1] + expr.q_c).is_zero():
                raise UnsatisfiedConstrain()
            return

        # Solved mul term, one unknown in the fan-in.
        total_prod = mul[1]
        partial_sum, (coeff, unknown_var) = fan_in[1], fan_in[2]
        total_sum = total_prod + partial_sum + expr.q_c
        if coeff.is_zero():
            if not total_sum.is_zero():
                raise UnsatisfiedConstrain()
            return
        insert_value(unknown_var, -(total_sum / coeff), witness_map)
