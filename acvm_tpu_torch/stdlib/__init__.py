"""ACIR fallback circuit builders (reference crate: stdlib).

Circuit *generators*: every function takes input expressions plus the current
witness counter and returns (updated_witness_count, opcodes) implementing the
gadget in arithmetic gates + Brillig hints.  Host code, no device: the machine
integers of ``uint.py`` and the SHA-256 fallback of ``sha256.py``, which the
compiler emits for a ``SHA256`` black box the proving backend does not support.
"""

from .helpers import VariableStore
from .sha256 import sha256
from .uint import UIntGadget, uint32_from_witnesses

__all__ = ["VariableStore", "UIntGadget", "uint32_from_witnesses", "sha256"]
