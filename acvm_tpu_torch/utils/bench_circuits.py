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


def with_repeated_constraints(circuit, count: int):
    """``circuit`` with its first ``count`` opcodes that carry a
    witness*witness term stated once more at the end.  When a repeat is reached
    every witness of it is known, so it plans as an assert-zero check whose
    expression has a quadratic term over known witnesses — the operand
    pre-multiply of the expression evaluation, which the solve gates of
    :func:`build_wide_arith_circuit` alone never need.  Every repeat holds on
    any input.  Works on either package's ``Circuit``."""
    quadratic = [op for op in circuit.opcodes if op.expr.mul_terms][:count]
    if len(quadratic) < count:
        raise ValueError(f"circuit has only {len(quadratic)} quadratic opcodes")
    return type(circuit)(
        current_witness_index=circuit.current_witness_index,
        opcodes=list(circuit.opcodes) + quadratic,
        private_parameters=set(circuit.private_parameters),
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


def build_gadget_circuit(
    kind: str, num_gadgets: int = 8, msg_len: int = 64
) -> Circuit:
    """A circuit of ``num_gadgets`` independent black-box gadget calls, for
    gadget-throughput measurements.

    kinds: "pedersen" (2 field inputs -> commitment point x, y), "fixed_base"
    (2 u128-limb inputs -> point x, y) and "schnorr" (pub x/y + 64 sig bytes +
    ``msg_len`` message bytes -> bool).  The hash and ECDSA kinds of the JAX
    package's generator wait for their gadgets.
    """
    opcodes: List[ops.Opcode] = []
    next_witness = 1
    input_witnesses: List[Witness] = []

    def fresh() -> Witness:
        nonlocal next_witness
        w = Witness(next_witness)
        next_witness += 1
        return w

    def fresh_n(n: int) -> List[Witness]:
        return [fresh() for _ in range(n)]

    for _ in range(num_gadgets):
        if kind == "pedersen":
            ins = [fresh(), fresh()]
            input_witnesses.extend(ins)
            outs = (fresh(), fresh())
            call = ops.BBPedersen(
                inputs=[ops.FunctionInput(w, 254) for w in ins],
                domain_separator=0,
                outputs=outs,
            )
        elif kind == "fixed_base":
            low, high = fresh(), fresh()
            input_witnesses.extend([low, high])
            call = ops.BBFixedBaseScalarMul(
                low=ops.FunctionInput(low, 128),
                high=ops.FunctionInput(high, 128),
                outputs=(fresh(), fresh()),
            )
        elif kind == "schnorr":
            pub_x, pub_y = fresh(), fresh()
            sig = fresh_n(64)
            msg = fresh_n(msg_len)
            input_witnesses.extend([pub_x, pub_y] + sig + msg)
            call = ops.BBSchnorrVerify(
                public_key_x=ops.FunctionInput(pub_x, 254),
                public_key_y=ops.FunctionInput(pub_y, 254),
                signature=[ops.FunctionInput(w, 8) for w in sig],
                message=[ops.FunctionInput(w, 8) for w in msg],
                output=fresh(),
            )
        else:
            raise NotImplementedError(
                f"build_gadget_circuit: kind {kind!r} is not ported (pedersen, "
                "fixed_base and schnorr are)"
            )
        opcodes.append(ops.OpcodeBlackBoxFuncCall(call))

    return Circuit(
        current_witness_index=next_witness - 1,
        opcodes=opcodes,
        private_parameters=set(input_witnesses),
    )


def gadget_inputs(
    circuit: Circuit, batch: int, kind: str, seed: int = 7
) -> List[Dict[int, int]]:
    """Random per-instance inputs for :func:`build_gadget_circuit` (byte
    values, or field values for pedersen)."""
    rng = random.Random(seed)
    p = BN254_FR.modulus
    hi = p if kind == "pedersen" else 256
    witnesses = sorted(int(w) for w in circuit.circuit_arguments())
    return [{w: rng.randrange(hi) for w in witnesses} for _ in range(batch)]


def gadget_inputs_columnar(circuit: Circuit, batch: int, kind: str, seed: int = 7):
    """Columnar ``{witness: (B,) array}`` form of :func:`gadget_inputs` — the
    bulk ingest path of ``BatchSolver.initial_state``.  Bytes come back as
    uint8 arrays, pedersen field scalars as object arrays, fixed-base limbs as
    uint64 arrays, and every schnorr instance carries the same valid
    signature."""
    import numpy as np

    rng = np.random.default_rng(seed)
    witnesses = sorted(int(w) for w in circuit.circuit_arguments())
    if kind == "pedersen":
        p = BN254_FR.modulus
        pyrng = random.Random(seed)
        return {
            w: np.array(
                [pyrng.randrange(p) for _ in range(batch)], dtype=object
            )
            for w in witnesses
        }
    if kind == "fixed_base":
        # low/high u128 limbs; combined scalar stays far below the grumpkin
        # group order (values < 2^64).
        cols = {}
        for opcode in circuit.opcodes:
            call = opcode.call
            cols[int(call.low.witness)] = rng.integers(
                1, 1 << 63, size=batch, dtype=np.uint64
            )
            cols[int(call.high.witness)] = np.zeros(batch, dtype=np.uint64)
        return cols
    if kind == "schnorr":
        from ..blackbox import grumpkin as gk

        pyrng = random.Random(seed)
        sk = pyrng.randrange(1, gk.grumpkin.params.n)
        pub_x, pub_y = gk.schnorr_public_key(sk)
        cols = {}
        for opcode in circuit.opcodes:
            call = opcode.call
            msg = bytes(
                pyrng.randrange(256) for _ in range(len(call.message))
            )
            sig = gk.schnorr_sign(sk, msg)
            cols[int(call.public_key_x.witness)] = np.array(
                [int(pub_x)] * batch, dtype=object
            )
            cols[int(call.public_key_y.witness)] = np.array(
                [int(pub_y)] * batch, dtype=object
            )
            for j, fi in enumerate(call.signature):
                cols[int(fi.witness)] = np.full(batch, sig[j], dtype=np.uint8)
            for j, fi in enumerate(call.message):
                cols[int(fi.witness)] = np.full(batch, msg[j], dtype=np.uint8)
        return cols
    raise NotImplementedError(
        f"gadget_inputs_columnar: kind {kind!r} is not ported (pedersen, "
        "fixed_base and schnorr are)"
    )


def columnar_instance(columnar, index: int) -> Dict[int, int]:
    """Extract one instance from columnar inputs as a {witness: int} dict."""
    return {w: int(a[index]) for w, a in columnar.items()}
