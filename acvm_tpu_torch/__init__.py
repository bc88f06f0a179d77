"""acvm_tpu_torch — the PyTorch/CUDA port of the acvm_tpu witness engine.

A second package beside ``acvm_tpu`` (the JAX reference): the same ACIR
batched witness solver, with plain tensor code in PyTorch and every device
kernel written by hand in CUDA C++ for NVIDIA Hopper (``csrc/``).  It imports
``torch`` and ``numpy`` only.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where each kernel's plain PyTorch version runs.

It solves arithmetic gates, the integer and directive opcodes, the Grumpkin
gadgets, the hash gadgets, Brillig blocks (straight-line, and on the device
Brillig VM) and memory blocks:
``plan_circuit(circuit)`` -> ``BatchSolver(plan)`` -> ``solver.solve(inputs)``
(``acvm_tpu_torch.gpu``).
"""

__version__ = "0.1.0"

from .fields import FieldElement
from .acir import Circuit, Expression, Witness, WitnessMap

__all__ = ["FieldElement", "Circuit", "Expression", "Witness", "WitnessMap"]
