"""CSatTransformer: reduce expressions to a PLONK-CSAT width by extracting
intermediate variables, tracking which witnesses remain solvable in order.

Reference: acvm/src/compiler/transformers/csat.rs — the full-opcode scan pulls
(mul term + matching linear terms) subsets into cached intermediate variables;
the partial scan squashes leftover mul terms and folds wide fan-ins into
width-1 chains.  The intermediate-variable cache is keyed by the normalized
expression (scaled so its first coefficient is one) with the scale returned on
cache hits.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ..acir.expression import Expression
from ..acir.witness import Witness
from ..fields.field import FieldElement


class CSatTransformer:
    def __init__(self, width: int):
        assert width > 2
        self.width = width
        self.solvable_witness: Set[Witness] = set()

    # -- solvability tracking ------------------------------------------------
    def mark_solvable(self, witness: Witness) -> None:
        self.solvable_witness.add(witness)

    def _try_solve(self, opcode: Expression) -> None:
        unresolved = []
        for _, w1, w2 in opcode.mul_terms:
            if w1 not in self.solvable_witness:
                unresolved.append(w1)
                if w2 not in self.solvable_witness:
                    return
            if w2 not in self.solvable_witness:
                unresolved.append(w2)
                if w1 not in self.solvable_witness:
                    return
        for _, w in opcode.linear_combinations:
            if w not in self.solvable_witness:
                unresolved.append(w)
        if len(unresolved) == 1:
            self.mark_solvable(unresolved[0])

    # -- cache ---------------------------------------------------------------
    @staticmethod
    def normalize(expr: Expression) -> Tuple[FieldElement, Expression]:
        expr = expr.clone()
        expr.sort()
        if expr.linear_combinations:
            a = expr.linear_combinations[0][0]
        else:
            a = expr.mul_terms[0][0]
        return a, expr.scale(a.inverse())

    @staticmethod
    def get_or_create_intermediate_vars(
        intermediate_variables: Dict,
        expr: Expression,
        num_witness: List[int],
    ) -> Tuple[FieldElement, Witness]:
        k, normalized = CSatTransformer.normalize(expr)
        key = normalized.key()
        if key in intermediate_variables:
            _, (l, iv) = intermediate_variables[key]
            return k / l, iv
        inter_var = Witness(num_witness[0])
        num_witness[0] += 1
        intermediate_variables[key] = (normalized, (k, inter_var))
        return FieldElement.one(), inter_var

    # -- main transform ------------------------------------------------------
    def transform(
        self,
        opcode: Expression,
        intermediate_variables: Dict,
        num_witness: List[int],
    ) -> Expression:
        opcode = self._full_opcode_scan(opcode, intermediate_variables, num_witness)
        opcode = self._partial_opcode_scan(opcode, intermediate_variables, num_witness)
        opcode.sort()
        self._try_solve(opcode)
        return opcode

    def _full_opcode_scan(
        self, opcode: Expression, intermediate_variables: Dict, num_witness: List[int]
    ) -> Expression:
        if len(opcode.mul_terms) <= 1:
            return opcode

        new_opcode = Expression()
        remaining_mul_terms = []
        for pair in opcode.mul_terms:
            coeff, wl, wr = pair
            if wl not in self.solvable_witness or wr not in self.solvable_witness:
                remaining_mul_terms.append(pair)
                continue

            index_wl = next(
                (
                    i
                    for i, (_, w) in enumerate(opcode.linear_combinations)
                    if w == wl
                ),
                None,
            )
            index_wr = next(
                (
                    i
                    for i, (_, w) in enumerate(opcode.linear_combinations)
                    if w == wr
                ),
                None,
            )

            if index_wl is None or index_wr is None:
                new_opcode.mul_terms.append(pair)
                continue

            x, y = index_wl, index_wr
            left_wire_term = opcode.linear_combinations[x]
            right_wire_term = opcode.linear_combinations[y]

            intermediate_opcode = Expression()
            intermediate_opcode.mul_terms.append(pair)
            intermediate_opcode.linear_combinations.append(left_wire_term)
            intermediate_opcode.linear_combinations.append(right_wire_term)
            if x > y:
                opcode.linear_combinations.pop(x)
                opcode.linear_combinations.pop(y)
            elif x < y:
                opcode.linear_combinations.pop(y)
                opcode.linear_combinations.pop(x)
            else:
                opcode.linear_combinations.pop(x)
                intermediate_opcode.linear_combinations.pop()

            # Fill the remaining width with solvable linear terms.  NOTE: this
            # reproduces the reference loop exactly (csat.rs:199-218),
            # including its quirk that terms popped into the local buffer are
            # dropped if the loop exits because the width filled up rather
            # than because the opcode ran out of terms.
            remaining_space = self.width - 2 - 1
            remaining_linear_terms = []
            while remaining_space > 0:
                if opcode.linear_combinations:
                    wire_term = opcode.linear_combinations.pop()
                    if wire_term[1] in self.solvable_witness:
                        intermediate_opcode.linear_combinations.append(wire_term)
                        remaining_space -= 1
                    else:
                        remaining_linear_terms.append(wire_term)
                else:
                    opcode.linear_combinations = remaining_linear_terms
                    break

            inter_var = self.get_or_create_intermediate_vars(
                intermediate_variables, intermediate_opcode, num_witness
            )
            self.mark_solvable(inter_var[1])
            new_opcode.linear_combinations.append(inter_var)

        opcode.mul_terms = remaining_mul_terms
        new_opcode.mul_terms.extend(opcode.mul_terms)
        new_opcode.linear_combinations.extend(opcode.linear_combinations)
        new_opcode.q_c = opcode.q_c
        new_opcode.sort()
        return new_opcode

    def _partial_opcode_scan(
        self, opcode: Expression, intermediate_variables: Dict, num_witness: List[int]
    ) -> Expression:
        if opcode.fits_in_one_identity(self.width):
            return opcode

        remaining_mul_terms = []
        for mul_term in list(opcode.mul_terms):
            coeff, wl, wr = mul_term
            if wl in self.solvable_witness and wr in self.solvable_witness:
                intermediate_opcode = Expression()
                intermediate_opcode.mul_terms.append(mul_term)
                inter_var = self.get_or_create_intermediate_vars(
                    intermediate_variables, intermediate_opcode, num_witness
                )
                opcode.linear_combinations.append(inter_var)
                self.mark_solvable(inter_var[1])
            else:
                remaining_mul_terms.append(mul_term)
        opcode.mul_terms = remaining_mul_terms

        if len(opcode.linear_combinations) <= self.width:
            return opcode

        added = []
        while len(opcode.linear_combinations) > self.width:
            intermediate_opcode = Expression()
            remaining_linear_terms = []
            for term in opcode.linear_combinations:
                if (
                    term[1] in self.solvable_witness
                    and len(intermediate_opcode.linear_combinations)
                    < self.width - 1
                ):
                    intermediate_opcode.linear_combinations.append(term)
                else:
                    remaining_linear_terms.append(term)
            opcode.linear_combinations = remaining_linear_terms
            not_full = (
                len(intermediate_opcode.linear_combinations) < self.width - 1
            )
            if len(intermediate_opcode.linear_combinations) > 1:
                inter_var = self.get_or_create_intermediate_vars(
                    intermediate_variables, intermediate_opcode, num_witness
                )
                self.mark_solvable(inter_var[1])
                added.append(inter_var)
            if not_full and len(opcode.linear_combinations) > self.width:
                raise AssertionError("Could not reduce the expression")

        opcode.linear_combinations.extend(added)
        return self._partial_opcode_scan(
            opcode, intermediate_variables, num_witness
        )
