"""Prime-field parameters for the ACVM engine.

The reference engine (noir-lang/acvm) selects its field at compile time via cargo
features (``acir_field/src/lib.rs:4-23``): BN254's scalar field Fr by default, with
BLS12-381's Fr as the alternative.  We carry the same two parameter sets, plus the
derived Montgomery constants (radix R = 2^256).  The 16-bit limb helpers are the
host-side interchange format; the device tensors of this package hold 8 x 32-bit
limbs (see ``torch_ops``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache


# BN254 (alt_bn128) scalar field modulus — the value pinned by the reference's
# serialization test vectors (acir_field/src/generic_ark.rs:424-438).
BN254_FR_MODULUS = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001

# BLS12-381 scalar field modulus (acir_field feature "bls12_381").
BLS12_381_FR_MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Grumpkin's scalar field = BN254's *base* field Fq.  The reference pins these bytes
# inline when validating fixed-base scalars
# (barretenberg_blackbox_solver/src/wasm/scalar_mul.rs:42-46).
GRUMPKIN_SCALAR_MODULUS = (
    0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
)

# Host-side interchange limb layout: 254-bit elements as 16 x 16-bit limbs held in
# uint32.  (Device tensors pack two of these into one 32-bit limb.)
LIMB_BITS = 16
NUM_LIMBS = 16  # 16 * 16 = 256 bits >= 254


@dataclass(frozen=True)
class FieldParams:
    """All host- and device-side constants for one prime field."""

    name: str
    modulus: int

    # ----- derived (host) -----
    @property
    def bit_size(self) -> int:
        return self.modulus.bit_length()

    @property
    def byte_size(self) -> int:
        return (self.bit_size + 7) // 8

    # ----- derived (Montgomery, radix 2^(LIMB_BITS*NUM_LIMBS)) -----
    @property
    def mont_bits(self) -> int:
        return LIMB_BITS * NUM_LIMBS

    @property
    def r(self) -> int:
        """Montgomery radix R = 2^256 mod p."""
        return (1 << self.mont_bits) % self.modulus

    @property
    def r2(self) -> int:
        """R^2 mod p, used to convert into Montgomery form."""
        return (self.r * self.r) % self.modulus

    @property
    def n0_inv(self) -> int:
        """-p^-1 mod 2^LIMB_BITS (per-limb Montgomery constant)."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    def limbs(self, value: int) -> list[int]:
        """Decompose ``value`` into NUM_LIMBS little-endian LIMB_BITS-bit limbs."""
        mask = (1 << LIMB_BITS) - 1
        return [(value >> (LIMB_BITS * i)) & mask for i in range(NUM_LIMBS)]

    def from_limbs(self, limbs) -> int:
        acc = 0
        for i, limb in enumerate(limbs):
            acc |= int(limb) << (LIMB_BITS * i)
        return acc


BN254_FR = FieldParams(name="bn254", modulus=BN254_FR_MODULUS)
BLS12_381_FR = FieldParams(name="bls12_381", modulus=BLS12_381_FR_MODULUS)

_FIELDS = {"bn254": BN254_FR, "bls12_381": BLS12_381_FR}


@lru_cache(maxsize=None)
def get_field(name: str) -> FieldParams:
    try:
        return _FIELDS[name]
    except KeyError:
        raise ValueError(f"unknown field {name!r}; expected one of {sorted(_FIELDS)}")
