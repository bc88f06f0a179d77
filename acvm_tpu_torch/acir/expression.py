"""Degree-<=2 multivariate polynomial over witnesses.

Mirrors ``acir/src/native_types/expression/{mod,operators,ordering}.rs``:
``mul_terms`` is a sum of q_M * w_L * w_R products, ``linear_combinations`` a sum
of q * w terms, plus a constant ``q_c``.  The merge-based ``add_mul``, canonical
``sort``, width check ``fits_in_one_identity`` and max-witness ordering are all
required by the compiler passes and solvers and are reproduced exactly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..fields.field import FieldElement
from .witness import Witness

MulTerm = Tuple[FieldElement, Witness, Witness]
LinTerm = Tuple[FieldElement, Witness]


class Expression:
    __slots__ = ("mul_terms", "linear_combinations", "q_c")

    def __init__(
        self,
        mul_terms: Optional[List[MulTerm]] = None,
        linear_combinations: Optional[List[LinTerm]] = None,
        q_c: Optional[FieldElement] = None,
    ):
        self.mul_terms: List[MulTerm] = list(mul_terms or [])
        self.linear_combinations: List[LinTerm] = list(linear_combinations or [])
        self.q_c: FieldElement = q_c if q_c is not None else FieldElement.zero()

    # ---- constructors -------------------------------------------------------
    @classmethod
    def zero(cls) -> "Expression":
        return cls()

    @classmethod
    def one(cls) -> "Expression":
        return cls(q_c=FieldElement.one())

    @classmethod
    def from_field(cls, q_c: FieldElement) -> "Expression":
        return cls(q_c=q_c)

    @classmethod
    def from_witness(cls, w: Witness) -> "Expression":
        return cls(linear_combinations=[(FieldElement.one(), w)])

    # ---- predicates ---------------------------------------------------------
    def num_mul_terms(self) -> int:
        return len(self.mul_terms)

    def is_const(self) -> bool:
        return not self.mul_terms and not self.linear_combinations

    def is_linear(self) -> bool:
        return not self.mul_terms

    def is_degree_one_univariate(self) -> bool:
        return self.is_linear() and len(self.linear_combinations) == 1

    def is_zero(self) -> bool:
        return self == Expression.zero()

    def to_const(self) -> Optional[FieldElement]:
        return self.q_c if self.is_const() else None

    def to_witness(self) -> Optional[Witness]:
        if self.is_degree_one_univariate():
            coeff, var = self.linear_combinations[0]
            if coeff.is_one() and self.q_c.is_zero():
                return var
        return None

    # ---- canonicalization ---------------------------------------------------
    def sort(self) -> None:
        self.mul_terms.sort(key=lambda t: (t[1], t[2]))
        self.linear_combinations.sort(key=lambda t: t[1])

    def key(self):
        """Canonical hashable key (used where the reference hashes Expressions,
        e.g. the CSat intermediate-variable cache)."""
        return (
            tuple((c.value, int(l), int(r)) for c, l, r in self.mul_terms),
            tuple((c.value, int(w)) for c, w in self.linear_combinations),
            self.q_c.value,
        )

    def fits_in_one_identity(self, width: int) -> bool:
        """acir/src/native_types/expression/mod.rs:182-234."""
        if len(self.mul_terms) > 1:
            return False
        if len(self.linear_combinations) > width:
            return False
        if not self.mul_terms:
            return True
        if len(self.linear_combinations) <= width - 2:
            return True
        mul_term = self.mul_terms[0]
        assert not mul_term[0].is_zero()
        found_x = found_y = False
        for _, witness in self.linear_combinations:
            if witness == mul_term[1]:
                found_x = True
            if witness == mul_term[2]:
                found_y = True
            if found_x and found_y:
                break
        return found_x and found_y

    # ---- arithmetic ---------------------------------------------------------
    def add_mul(self, k: FieldElement, b: "Expression") -> "Expression":
        """Returns ``self + k*b`` with sorted-merge of terms
        (expression/mod.rs:237-342)."""
        if k.is_zero():
            return self.clone()
        if self.is_const():
            return b.scale(k).add_field(self.q_c)
        if b.is_const():
            return self.add_field(k * b.q_c)

        result = Expression(q_c=self.q_c + k * b.q_c)

        i1 = i2 = 0
        a_lin, b_lin = self.linear_combinations, b.linear_combinations
        while i1 < len(a_lin) and i2 < len(b_lin):
            a_c, a_w = a_lin[i1]
            b_c, b_w = b_lin[i2]
            if a_w > b_w:
                coeff, witness = k * b_c, b_w
                i2 += 1
            elif a_w < b_w:
                coeff, witness = a_c, a_w
                i1 += 1
            else:
                coeff, witness = a_c + k * b_c, a_w
                i1 += 1
                i2 += 1
            if not coeff.is_zero():
                result.linear_combinations.append((coeff, witness))
        while i1 < len(a_lin):
            result.linear_combinations.append(a_lin[i1])
            i1 += 1
        while i2 < len(b_lin):
            b_c, b_w = b_lin[i2]
            coeff = b_c * k
            if not coeff.is_zero():
                result.linear_combinations.append((coeff, b_w))
            i2 += 1

        i1 = i2 = 0
        a_mul, b_mul = self.mul_terms, b.mul_terms
        while i1 < len(a_mul) and i2 < len(b_mul):
            a_c, a_wl, a_wr = a_mul[i1]
            b_c, b_wl, b_wr = b_mul[i2]
            if (a_wl, a_wr) > (b_wl, b_wr):
                coeff, wl, wr = k * b_c, b_wl, b_wr
                i2 += 1
            elif (a_wl, a_wr) < (b_wl, b_wr):
                coeff, wl, wr = a_c, a_wl, a_wr
                i1 += 1
            else:
                coeff, wl, wr = a_c + k * b_c, a_wl, a_wr
                i1 += 1
                i2 += 1
            if not coeff.is_zero():
                result.mul_terms.append((coeff, wl, wr))
        while i1 < len(a_mul):
            result.mul_terms.append(a_mul[i1])
            i1 += 1
        while i2 < len(b_mul):
            b_c, b_wl, b_wr = b_mul[i2]
            coeff = b_c * k
            if not coeff.is_zero():
                result.mul_terms.append((coeff, b_wl, b_wr))
            i2 += 1

        return result

    def clone(self) -> "Expression":
        return Expression(
            list(self.mul_terms), list(self.linear_combinations), self.q_c
        )

    def __neg__(self) -> "Expression":
        return Expression(
            [(-c, l, r) for c, l, r in self.mul_terms],
            [(-c, w) for c, w in self.linear_combinations],
            -self.q_c,
        )

    def scale(self, k: FieldElement) -> "Expression":
        """`self * k` for a field scalar (operators.rs:66-81)."""
        return Expression(
            [(c * k, l, r) for c, l, r in self.mul_terms],
            [(c * k, w) for c, w in self.linear_combinations],
            self.q_c * k,
        )

    def add_field(self, k: FieldElement) -> "Expression":
        return Expression(list(self.mul_terms), list(self.linear_combinations), self.q_c + k)

    def __add__(self, other):
        if isinstance(other, FieldElement):
            return self.add_field(other)
        if isinstance(other, Witness):
            return self.add_mul(FieldElement.one(), Expression.from_witness(other))
        if isinstance(other, Expression):
            return self.add_mul(FieldElement.one(), other)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, FieldElement):
            return self.add_field(-other)
        if isinstance(other, Witness):
            return self.add_mul(-FieldElement.one(), Expression.from_witness(other))
        if isinstance(other, Expression):
            return self.add_mul(-FieldElement.one(), other)
        return NotImplemented

    def mul(self, rhs: "Expression") -> Optional["Expression"]:
        """Expression * Expression; None if the product would exceed degree 2
        (operators.rs:139-216)."""
        if self.is_const():
            return rhs.scale(self.q_c)
        if rhs.is_const():
            return self.scale(rhs.q_c)
        if not (self.is_linear() and rhs.is_linear()):
            return None

        output = Expression.from_field(self.q_c * rhs.q_c)

        for coeff, wit in self.linear_combinations:
            single = _single_mul(wit, rhs)
            output = output.add_mul(coeff, single)

        i1 = i2 = 0
        a_lin, b_lin = self.linear_combinations, rhs.linear_combinations
        while i1 < len(a_lin) and i2 < len(b_lin):
            a_c, a_w = a_lin[i1]
            b_c, b_w = b_lin[i2]
            a_c = rhs.q_c * a_c
            b_c = self.q_c * b_c
            if a_w > b_w:
                coeff, witness = b_c, b_w
                i2 += 1
            elif a_w < b_w:
                coeff, witness = a_c, a_w
                i1 += 1
            else:
                coeff, witness = a_c + b_c, a_w
                i1 += 1
                i2 += 1
            if not coeff.is_zero():
                output.linear_combinations.append((coeff, witness))
        while i1 < len(a_lin):
            a_c, a_w = a_lin[i1]
            coeff = rhs.q_c * a_c
            if not coeff.is_zero():
                output.linear_combinations.append((coeff, a_w))
            i1 += 1
        while i2 < len(b_lin):
            b_c, b_w = b_lin[i2]
            coeff = self.q_c * b_c
            if not coeff.is_zero():
                output.linear_combinations.append((coeff, b_w))
            i2 += 1

        return output

    # ---- ordering by max witness index (ordering.rs) ------------------------
    def _witness_multiset(self):
        ws = []
        for _, l, r in self.mul_terms:
            ws.append(int(l))
            ws.append(int(r))
        for _, w in self.linear_combinations:
            ws.append(int(w))
        return sorted(ws, reverse=True)

    def cmp(self, other: "Expression") -> int:
        """Compare by descending multiset of witness indices, assuming both
        expressions are sorted (matches ordering.rs semantics)."""
        a, b = self._witness_multiset(), other._witness_multiset()
        for x, y in zip(a, b):
            if x != y:
                return -1 if x < y else 1
        if len(a) != len(b):
            return -1 if len(a) < len(b) else 1
        return 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Expression) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        parts = [f"({c!r})*w{int(l)}*w{int(r)}" for c, l, r in self.mul_terms]
        parts += [f"({c!r})*w{int(w)}" for c, w in self.linear_combinations]
        parts.append(repr(self.q_c))
        return "Expr[" + " + ".join(parts) + "]"


def _single_mul(w: Witness, b: Expression) -> Expression:
    """``w * b.linear_combinations`` with canonically ordered witness pairs."""
    mul_terms = []
    for coeff, wit in b.linear_combinations:
        wl, wr = (w, wit) if w < wit else (wit, w)
        mul_terms.append((coeff, wl, wr))
    return Expression(mul_terms=mul_terms)
