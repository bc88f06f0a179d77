"""Host-side black-box functions: curves, hashes and the Grumpkin gadgets.

Pure Python ints; the bit-exactness oracle of the batched device gadgets
(``acvm_tpu_torch.gpu.ec``, ``acvm_tpu_torch.gpu.gadgets``).  The solver
classes that bind these to the sequential engine (``GrumpkinSolver``) and the
ECDSA verifiers are not part of this package yet.
"""

from . import ec, grumpkin, hashes

__all__ = ["ec", "grumpkin", "hashes"]
