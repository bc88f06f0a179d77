from .field import FieldElement
from .params import (
    BN254_FR,
    BLS12_381_FR,
    FieldParams,
    GRUMPKIN_SCALAR_MODULUS,
    LIMB_BITS,
    NUM_LIMBS,
    get_field,
)

__all__ = [
    "FieldElement",
    "FieldParams",
    "BN254_FR",
    "BLS12_381_FR",
    "GRUMPKIN_SCALAR_MODULUS",
    "LIMB_BITS",
    "NUM_LIMBS",
    "get_field",
]
