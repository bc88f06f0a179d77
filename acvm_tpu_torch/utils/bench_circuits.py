"""Synthetic ACIR circuits for benchmarking and smoke tests.

The headline workload solves a 2^16-gate BN254 arithmetic circuit over large
instance batches.  The generator below emits a
wide layered circuit: ``num_levels`` dependency levels of ``gates_per_level``
arithmetic gates, each solving one fresh witness from two random
already-known witnesses (with a slice of witness*witness mul terms to exercise
the quadratic path).
"""

from __future__ import annotations

import random
from typing import Dict, List

from ..acir import Circuit, Expression, Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from ..fields.params import BN254_FR


def build_wide_arith_circuit(
    num_inputs: int = 128,
    num_levels: int = 8,
    gates_per_level: int = 8192,
    mul_fraction: float = 0.25,
    dyn_fraction: float = 0.0,
    seed: int = 1234,
) -> Circuit:
    rng = random.Random(seed)
    p = BN254_FR.modulus
    opcodes: List[ops.Opcode] = []

    inputs = [Witness(i + 1) for i in range(num_inputs)]
    known = list(inputs)
    next_witness = num_inputs + 1

    for _ in range(num_levels):
        level_known = list(known)
        new_witnesses = []
        for g in range(gates_per_level):
            x = level_known[rng.randrange(len(level_known))]
            y = level_known[rng.randrange(len(level_known))]
            out = Witness(next_witness)
            next_witness += 1
            c1 = FieldElement(rng.randrange(1, p))
            c0 = FieldElement(rng.randrange(p))
            if rng.random() < dyn_fraction:
                # qm*x*out + c1*x + c0 = 0: the solved witness carries a
                # NON-CONSTANT coefficient (den = qm*x), forcing the batched
                # modular-inversion path (arithmetic.rs:27-127 division by a
                # runtime value; `run_arith_solve_dyn` + `mont_batch_inv`).
                qm = FieldElement(rng.randrange(1, p))
                expr = Expression(
                    mul_terms=[(qm, min(x, out), max(x, out))],
                    linear_combinations=[(c1, x)],
                    q_c=c0,
                )
                opcodes.append(ops.OpcodeArithmetic(expr))
                new_witnesses.append(out)
                continue
            if rng.random() < mul_fraction:
                # qm*x*y + c1*x + c0 - out = 0
                qm = FieldElement(rng.randrange(1, p))
                expr = Expression(
                    mul_terms=[(qm, min(x, y), max(x, y))],
                    linear_combinations=[(c1, x), (-FieldElement.one(), out)],
                    q_c=c0,
                )
            else:
                c2 = FieldElement(rng.randrange(1, p))
                expr = Expression(
                    linear_combinations=[
                        (c1, x),
                        (c2, y),
                        (-FieldElement.one(), out),
                    ],
                    q_c=c0,
                )
            opcodes.append(ops.OpcodeArithmetic(expr))
            new_witnesses.append(out)
        known.extend(new_witnesses)

    return Circuit(
        current_witness_index=next_witness - 1,
        opcodes=opcodes,
        private_parameters=set(inputs),
    )


def random_inputs(
    circuit: Circuit, batch: int, seed: int = 99
) -> List[Dict[int, int]]:
    rng = random.Random(seed)
    p = BN254_FR.modulus
    witnesses = sorted(int(w) for w in circuit.circuit_arguments())
    return [
        {w: rng.randrange(p) for w in witnesses} for _ in range(batch)
    ]
