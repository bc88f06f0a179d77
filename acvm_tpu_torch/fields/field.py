"""Host-side scalar field element, bit-exact with the reference semantics.

Mirrors the behavioural contract of ``acir_field/src/generic_ark.rs`` (the arkworks
wrapper in noir-lang/acvm): construction from signed/unsigned ints with modular
reduction, big-endian byte serialization, hex round-trip, ``num_bits``,
``fetch_nearest_bytes`` (which truncates in *little-endian* order —
``generic_ark.rs:305-317``), and byte-masked AND/XOR (``generic_ark.rs:328-355``).

This scalar type drives the sequential conformance path and all host-side planning;
the batched device path carries the same values as 16x16-bit limb tensors
(`acvm_tpu_torch.fields.limbs`).
"""

from __future__ import annotations

from .params import FieldParams, BN254_FR, get_field


class FieldElement:
    """An element of a prime field, stored canonically in ``[0, p)``.

    Instances are immutable.  The field defaults to BN254 Fr, matching the
    reference's default cargo feature; pass ``params`` for other fields.
    """

    __slots__ = ("value", "params")

    def __init__(self, value: int, params: FieldParams = BN254_FR):
        object.__setattr__(self, "params", params)
        object.__setattr__(self, "value", value % params.modulus)

    def __setattr__(self, *_):
        raise AttributeError("FieldElement is immutable")

    # ---- constructors -------------------------------------------------------
    @classmethod
    def zero(cls, params: FieldParams = BN254_FR) -> "FieldElement":
        return cls(0, params)

    @classmethod
    def one(cls, params: FieldParams = BN254_FR) -> "FieldElement":
        return cls(1, params)

    @classmethod
    def from_int(cls, value: int, params: FieldParams = BN254_FR) -> "FieldElement":
        return cls(value, params)

    @classmethod
    def from_be_bytes_reduce(
        cls, data: bytes, params: FieldParams = BN254_FR
    ) -> "FieldElement":
        return cls(int.from_bytes(data, "big"), params)

    @classmethod
    def from_hex(cls, hex_str: str, params: FieldParams = BN254_FR):
        s = hex_str[2:] if hex_str.startswith("0x") else hex_str
        try:
            data = bytes.fromhex(s)
        except ValueError:
            return None
        return cls.from_be_bytes_reduce(data, params)

    @classmethod
    def try_from_str(cls, s: str, params: FieldParams = BN254_FR):
        if "x" in s:
            return cls.from_hex(s, params)
        try:
            return cls(int(s), params)
        except ValueError:
            return None

    # ---- predicates ---------------------------------------------------------
    def is_zero(self) -> bool:
        return self.value == 0

    def is_one(self) -> bool:
        return self.value == 1

    # ---- info ---------------------------------------------------------------
    def max_num_bits(self) -> int:
        return self.params.bit_size

    def max_num_bytes(self) -> int:
        return self.params.byte_size

    def num_bits(self) -> int:
        return self.value.bit_length()

    def fits_in_u128(self) -> bool:
        return self.num_bits() <= 128

    def to_u128(self) -> int:
        # Reference takes the low 16 bytes of the BE encoding (generic_ark.rs:227-230).
        return self.value & ((1 << 128) - 1)

    def try_into_u128(self):
        return self.to_u128() if self.fits_in_u128() else None

    def try_to_u64(self):
        return (self.value & ((1 << 64) - 1)) if self.num_bits() <= 64 else None

    # ---- conversions --------------------------------------------------------
    def to_be_bytes(self) -> bytes:
        return self.value.to_bytes(self.params.byte_size, "big")

    def to_le_bytes(self) -> bytes:
        return self.value.to_bytes(self.params.byte_size, "little")

    def to_hex(self) -> str:
        return self.to_be_bytes().hex()

    def bits(self) -> list[bool]:
        """MSB-first bit vector over the full byte width (generic_ark.rs:285-293)."""
        out = []
        for byte in self.to_be_bytes():
            for shift in range(7, -1, -1):
                out.append(bool((byte >> shift) & 1))
        return out

    def fetch_nearest_bytes(self, num_bits: int) -> bytes:
        """The reference's quirky truncation: round ``num_bits`` up to whole bytes,
        then take that many *least-significant* bytes in little-endian order
        (generic_ark.rs:305-317)."""
        num_bytes = (num_bits + 7) // 8
        return self.to_le_bytes()[:num_bytes]

    # ---- arithmetic ---------------------------------------------------------
    def _wrap(self, v: int) -> "FieldElement":
        return FieldElement(v, self.params)

    def _join(self, other: "FieldElement") -> FieldParams:
        """Params for a binary op.  The reference fixes the field at compile
        time, so genuinely mixed-field arithmetic cannot exist; here default
        constructions (``Expression()``'s q_c, solver accumulators) start as
        BN254 zeros, so a zero-valued operand adopts the other side's field.
        Non-zero cross-field operands are a real bug — fail loudly."""
        if self.params.modulus == other.params.modulus:
            return self.params
        if self.value == 0:
            return other.params
        if other.value == 0:
            return self.params
        raise ValueError(
            f"mixed-field arithmetic: {self.params.name} vs {other.params.name}"
        )

    def __add__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(self.value + other.value, self._join(other))

    def __sub__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(self.value - other.value, self._join(other))

    def __mul__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(self.value * other.value, self._join(other))

    def __neg__(self) -> "FieldElement":
        return self._wrap(-self.value)

    def __truediv__(self, other: "FieldElement") -> "FieldElement":
        return self * other.inverse()

    def inverse(self) -> "FieldElement":
        """Multiplicative inverse; zero maps to zero (generic_ark.rs:242-245)."""
        if self.value == 0:
            return self._wrap(0)
        return self._wrap(pow(self.value, -1, self.params.modulus))

    def try_inverse(self):
        return None if self.value == 0 else self.inverse()

    def pow(self, exponent: "FieldElement") -> "FieldElement":
        return self._wrap(pow(self.value, exponent.value, self.params.modulus))

    # ---- bitwise (byte-masked, as the reference does) -----------------------
    def _mask(self, num_bits: int) -> int:
        return self.value & ((1 << num_bits) - 1)

    def and_(self, rhs: "FieldElement", num_bits: int) -> "FieldElement":
        return self._wrap(self._mask(num_bits) & rhs._mask(num_bits))

    def xor(self, rhs: "FieldElement", num_bits: int) -> "FieldElement":
        return self._wrap(self._mask(num_bits) ^ rhs._mask(num_bits))

    # ---- dunder glue --------------------------------------------------------
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, FieldElement)
            and self.value == other.value
            and self.params.modulus == other.params.modulus
        )

    def __hash__(self) -> int:
        return hash((self.value, self.params.modulus))

    def __int__(self) -> int:
        return self.value

    def __repr__(self) -> str:
        # Match the reference's "prefer the shorter of n / -n" display heuristic
        # loosely; exactness is not required for repr.
        neg = self.params.modulus - self.value
        if self.value != 0 and len(str(neg)) < len(str(self.value)):
            return f"-{neg}"
        return str(self.value)


def field_from_name(name: str):
    return get_field(name)
