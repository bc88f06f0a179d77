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
from types import SimpleNamespace
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


# The classes the builders below take by default; another package whose ACIR
# classes have the same names passes its own namespace as ``lib``.
PORT_CLASSES = SimpleNamespace(Circuit=Circuit, Expression=Expression, Witness=Witness,
                               FieldElement=FieldElement, opcodes=ops)


def build_u32_circuit(
    num_inputs: int = 128,
    num_rounds: int = 8,
    units_per_round: int = 1024,
    seed: int = 1234,
    lib=None,
):
    """The shape of compiled Noir ``u32`` code: rounds of units, each a
    multiply-add, its wrap to 32 bits by a Quotient directive, the range checks
    Noir emits, bitwise AND and XOR, and a byte decomposition.

    The first ``num_inputs`` opcodes range-check the inputs to 32 bits.  Each
    unit reads x and y, drawn by the seeded RNG from the previous round's
    outputs z (round 0 reads the inputs), and emits 12 opcodes:

    * ``s = x*y + y + k`` (k a seeded u32 constant);
    * ``Quotient(s, 2^32)`` writing q and r, and the check ``s - 2^32 q - r = 0``;
    * ``Range(r, 32)``, ``Range(q, 33)``;
    * ``a = AND(r, x, 32)``, ``z = XOR(a, y, 32)``;
    * ``ToLeRadix(z, 256)`` into 4 byte witnesses and ``Range(byte, 8)`` on each.

    ``lib`` holds the classes to build with (attributes ``Circuit``,
    ``Expression``, ``Witness``, ``FieldElement`` and ``opcodes``); by default
    this package's, so that a test can build the same circuit from another
    package whose classes have the same names.  The defaults give 98,432
    opcodes over 73,856 witnesses.
    """
    lib = lib or PORT_CLASSES
    o, fe, W = lib.opcodes, lib.FieldElement, lib.Witness
    rng = random.Random(seed)
    opcodes = []
    next_witness = num_inputs + 1

    def fresh():
        nonlocal next_witness
        next_witness += 1
        return W(next_witness - 1)

    def range_check(w, bits):
        return o.OpcodeBlackBoxFuncCall(o.BBRange(o.FunctionInput(w, bits)))

    def lin(*terms, q_c=0):
        return lib.Expression(linear_combinations=[(fe(c), w) for c, w in terms], q_c=fe(q_c))

    inputs = [W(i + 1) for i in range(num_inputs)]
    opcodes.extend(range_check(w, 32) for w in inputs)
    sources = inputs
    for _ in range(num_rounds):
        outputs = []
        for _ in range(units_per_round):
            x = sources[rng.randrange(len(sources))]
            y = sources[rng.randrange(len(sources))]
            k = rng.randrange(1 << 32)
            s, q, r, a, z = fresh(), fresh(), fresh(), fresh(), fresh()
            digits = [fresh() for _ in range(4)]
            opcodes.append(o.OpcodeArithmetic(lib.Expression(
                mul_terms=[(fe(1), min(x, y), max(x, y))],
                linear_combinations=[(fe(1), y), (-fe(1), s)],
                q_c=fe(k),
            )))
            opcodes.append(o.OpcodeDirective(o.DirQuotient(o.QuotientDirective(
                a=lin((1, s)), b=lin(q_c=1 << 32), q=q, r=r, predicate=None))))
            opcodes.append(o.OpcodeArithmetic(lin((1, s), (-(1 << 32), q), (-1, r))))
            opcodes.append(range_check(r, 32))
            opcodes.append(range_check(q, 33))
            opcodes.append(o.OpcodeBlackBoxFuncCall(
                o.BBAnd(o.FunctionInput(r, 32), o.FunctionInput(x, 32), a)))
            opcodes.append(o.OpcodeBlackBoxFuncCall(
                o.BBXor(o.FunctionInput(a, 32), o.FunctionInput(y, 32), z)))
            opcodes.append(o.OpcodeDirective(o.DirToLeRadix(lin((1, z)), digits, 256)))
            opcodes.extend(range_check(d, 8) for d in digits)
            outputs.append(z)
        sources = outputs
    return lib.Circuit(
        current_witness_index=next_witness - 1,
        opcodes=opcodes,
        private_parameters=set(inputs),
    )


def u32_inputs(circuit, batch: int, seed: int = 99) -> List[Dict[int, int]]:
    """Seeded u32 values for every input of :func:`build_u32_circuit`."""
    rng = random.Random(seed)
    witnesses = sorted(int(w) for w in circuit.circuit_arguments())
    return [{w: rng.randrange(1 << 32) for w in witnesses} for _ in range(batch)]


def build_quotient_circuit(lib=None):
    """Two Quotient directives over private inputs w1, w2, w3: w1 / w2 into
    (w4, w5) with no predicate, and (w1 w2 + 3 w1 + 7) / (w2 + 1) into
    (w6, w7) under the predicate w3.  ``lib`` as in :func:`build_u32_circuit`."""
    lib = lib or PORT_CLASSES
    o, fe, w = lib.opcodes, lib.FieldElement, lib.Witness

    def lin(*terms, q_c=0):
        return lib.Expression(linear_combinations=[(fe(c), w(i)) for c, i in terms], q_c=fe(q_c))

    compound = lib.Expression(mul_terms=[(fe(1), w(1), w(2))],
                              linear_combinations=[(fe(3), w(1))], q_c=fe(7))
    return lib.Circuit(
        current_witness_index=7,
        opcodes=[
            o.OpcodeDirective(o.DirQuotient(o.QuotientDirective(
                a=lin((1, 1)), b=lin((1, 2)), q=w(4), r=w(5), predicate=None))),
            o.OpcodeDirective(o.DirQuotient(o.QuotientDirective(
                a=compound, b=lin((1, 2), q_c=1), q=w(6), r=w(7), predicate=lin((1, 3))))),
        ],
        private_parameters={w(1), w(2), w(3)},
    )


def quotient_edge_inputs(modulus: int) -> List[Dict[int, int]]:
    """Inputs (w1, w2, w3) of :func:`build_quotient_circuit` at its edges:
    b = 0, predicate 0, a < b, a = p - 1, the divisor 2^32, b + 1 = p."""
    cases = [
        (modulus - 1, 2, 1), (5, 0, 1), (3, 7, 0), (modulus - 1, modulus - 1, 1),
        (12345678901234567890, 1 << 32, 5), (1 << 200, 3, modulus - 1), (0, 9, 1),
        (7, modulus - 1, 1),
    ]
    return [{1: a, 2: b, 3: c} for a, b, c in cases]


# Pairs (a, b) that reach the rare branches of word-level long division
# (Knuth's Algorithm D in base 2^32), found once by searching dividends and
# divisors of 2-5 words drawn from {0, 1, 2^31 - 1, 2^31, 2^32 - 1}: the
# digit estimate at the limit 2^32 - 1, the estimate corrected once and
# twice (over by one and by two), and the multiply-subtract that borrows and
# adds the divisor back.
DIVMOD_RARE_BRANCH_PAIRS = (
    (1 << 64, 0x1_00000000_00000001),  # add back, a = b - 1
    (1 << 96, 0x1_00000000_00000001),  # add back, a one word longer
    (0x7FFFFFFF_80000000_00000000_00000000, 0x80000000_00000000_00000001),  # add back
    (0x7FFFFFFF_00000000_00000000, 0x80000000_FFFFFFFF),  # corrected twice
    (0xFFFFFFFF_00000000_00000000, 0x1_00000001_7FFFFFFF),  # corrected twice
    (0x7FFFFFFF_00000000_00000000_00000000, 0x80000000_FFFFFFFF_00000000),  # corrected twice
    (1 << 64, 0x1_00000001),  # estimate at its limit
    (1 << 96, 0x1_00000001_00000000),  # estimate at its limit
    (1 << 32, 0x1_00000001),  # corrected once, a = b - 1
    (1 << 128, 0x1_00000001_00000000),  # corrected once
)


def divmod_edge_operands(modulus: int, seed: int = 5):
    """Dividends and divisors (two lists of ints < 2^256) at the edges of a
    256-bit division: a < b, a = b, b = 0, b = 1, a = p - 1, a = 2^256 - 1,
    b = 2^255 and above it, the Quotient's divisor 2^32, and for each k in
    1..256 a dividend of exactly k significant bits over a divisor of
    k // 2 + 1 bits.  Then the edges of word-level division:
    :data:`DIVMOD_RARE_BRANCH_PAIRS`; divisors whose top word needs a shift of
    0 and of 31 bits to normalise, at 1, 2 and 8 words; a one below and one
    above b; and :func:`divmod_word_grid`, three pairs for every pair of word
    lengths."""
    rng = random.Random(seed)
    top = (1 << 256) - 1
    x = rng.randrange(1 << 200)
    pairs = [
        (5, 7), (x, x << 40), (x, x), (modulus - 1, modulus - 1), (x, 0), (0, 0), (x, 1),
        (top, 1), (modulus - 1, 2), (modulus - 1, 1 << 32), (modulus - 1, 3), (top, 1 << 255),
        (top, 3), (top, top), (x, 1 << 255), (top, (1 << 255) + 1), (top - 1, top),
        (rng.randrange(1 << 255, 1 << 256), rng.randrange(1 << 255, 1 << 256)),
        ((1 << 65) - 1, 1 << 32), (0, 9),
    ]
    for k in range(1, 257):
        a = rng.randrange(1 << (k - 1), 1 << k)
        d = k // 2 + 1
        pairs.append((a, rng.randrange(1 << (d - 1), 1 << d)))
    pairs += DIVMOD_RARE_BRANCH_PAIRS
    for words in (1, 2, 8):  # divisors of `words` words, top word shifted by 0 and by 31
        low = rng.randrange(1 << (32 * words - 32))
        for b in (low | 0xFFFFFFFF << (32 * words - 32), low | 1 << (32 * words - 32)):
            pairs += [(top, b), (rng.randrange(b, 1 << 256), b), ((b << 3 | 5) & top, b)]
    for b in (1 << 32, (1 << 128) + 5, rng.randrange(1 << 200), modulus - 1):
        pairs += [(b - 1, b), (b + 1, b)]
    grid_a, grid_b = divmod_word_grid(3, seed)
    return [a for a, _ in pairs] + grid_a, [b for _, b in pairs] + grid_b


def divmod_word_grid(per_pair: int, seed: int = 6):
    """For every pair of word lengths (m, n) in 1..8, ``per_pair`` random
    dividends of exactly m 32-bit words over divisors of exactly n: two lists
    of 64 x ``per_pair`` ints."""
    rng = random.Random(seed)
    a, b = [], []
    for m in range(1, 9):
        for n in range(1, 9):
            for _ in range(per_pair):
                a.append(rng.randrange(1 << (32 * m - 32), 1 << (32 * m)))
                b.append(rng.randrange(1 << (32 * n - 32), 1 << (32 * n)))
    return a, b


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
