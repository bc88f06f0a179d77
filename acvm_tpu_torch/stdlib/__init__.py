"""ACIR fallback circuit builders (reference crate: stdlib).

Circuit *generators*: every function takes input expressions plus the current
witness counter and returns (updated_witness_count, opcodes) implementing the
gadget in arithmetic gates + Brillig hints.  Host code, no device: the
compiler emits them for a black box the proving backend does not support
(:mod:`acvm_tpu_torch.compiler.fallback`): AND, XOR and Range from
``logic_fallbacks.py``, and the hashes SHA-256, BLAKE2s, Keccak-256 and
hash-to-field over the machine integers of ``uint.py``.
"""

from .blake2s import blake2s
from .hash_to_field import hash_to_field
from .helpers import VariableStore
from .keccak256 import keccak256
from .logic_fallbacks import and_fallback, range_fallback, xor_fallback
from .sha256 import sha256
from .uint import (
    UIntGadget,
    uint8,
    uint32,
    uint32_from_witnesses,
    uint64,
    uint64_from_witnesses,
)

# Aliases matching the reference's public names.
and_ = and_fallback
xor = xor_fallback
range_ = range_fallback

__all__ = [
    "VariableStore",
    "UIntGadget",
    "uint8",
    "uint32",
    "uint64",
    "uint32_from_witnesses",
    "uint64_from_witnesses",
    "and_fallback",
    "xor_fallback",
    "range_fallback",
    "sha256",
    "blake2s",
    "keccak256",
    "hash_to_field",
]
