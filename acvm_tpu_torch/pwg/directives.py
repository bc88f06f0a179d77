"""Directive solvers: Quotient, ToLeRadix, PermutationSort.

Reference: acvm/src/pwg/directives/mod.rs.
"""

from __future__ import annotations

from ..acir.opcodes import DirPermutationSort, DirQuotient, DirToLeRadix, Directive
from ..acir.witness import WitnessMap
from ..fields.field import FieldElement
from .errors import UnsatisfiedConstrain


def solve_directives(witness_map: WitnessMap, directive: Directive) -> None:
    from .acvm import get_value, insert_value

    if isinstance(directive, DirQuotient):
        q = directive.quotient
        val_a = int(get_value(q.a, witness_map))
        val_b = int(get_value(q.b, witness_map))

        if q.predicate is not None:
            pred_value = get_value(q.predicate, witness_map)
        else:
            pred_value = FieldElement.one()

        if pred_value.is_zero() or val_b == 0:
            int_r, int_q = 0, 0
        else:
            int_r, int_q = val_a % val_b, val_a // val_b

        insert_value(q.q, FieldElement(int_q), witness_map)
        insert_value(q.r, FieldElement(int_r), witness_map)
        return

    if isinstance(directive, DirToLeRadix):
        value_a = int(get_value(directive.a, witness_map))
        radix = directive.radix

        # Decompose into little-endian radix digits.
        digits = []
        v = value_a
        while v:
            digits.append(v % radix)
            v //= radix

        if len(directive.b) < len(digits):
            raise UnsatisfiedConstrain()

        for i, witness in enumerate(directive.b):
            digit = digits[i] if i < len(digits) else 0
            insert_value(witness, FieldElement(digit), witness_map)
        return

    if isinstance(directive, DirPermutationSort):
        from .sorting import route

        val_a = []
        base = []
        for i, element in enumerate(directive.inputs):
            assert len(element) == directive.tuple_size
            element_val = [get_value(e, witness_map) for e in element]
            field_i = FieldElement(i)
            element_val.append(field_i)
            base.append(field_i)
            val_a.append(element_val)

        val_a.sort(
            key=lambda row: tuple(int(row[i]) for i in directive.sort_by)
        )
        b = [row[-1] for row in val_a]
        control = route(base, b)
        for w, bit in zip(directive.bits, control):
            insert_value(
                w, FieldElement.one() if bit else FieldElement.zero(), witness_map
            )
        return

    raise TypeError(directive)
