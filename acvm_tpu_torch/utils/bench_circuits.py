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

from .. import brillig as br
from .. import stdlib
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
                               FieldElement=FieldElement, opcodes=ops, brillig=br,
                               stdlib=stdlib)


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


def build_sha256_circuit(num_bytes: int = 32, lib=None):
    """The compiler's SHA-256 fallback (reference stdlib/src/blackbox_fallbacks/
    sha256.rs, expanded in place of a ``SHA256`` black box the backend does
    not support) over ``num_bytes`` input bytes w1..w_n, its 32 output bytes
    in the next 32 witnesses.  Straight-line Brillig hints (u32 add, sub,
    mul, constants), range checks, AND/XOR, Quotient and ToLeRadix: at 32
    bytes, 28,980 opcodes over 15,793 witnesses.  ``lib`` as in
    :func:`build_u32_circuit`, with ``stdlib`` (the package whose ``sha256``
    builds the fallback) beside the classes."""
    lib = lib or PORT_CLASSES
    W = lib.Witness
    inputs = [W(i + 1) for i in range(num_bytes)]
    outputs = [W(num_bytes + 1 + i) for i in range(32)]
    num_witness, opcodes = lib.stdlib.sha256(
        [(lib.Expression.from_witness(w), 8) for w in inputs], outputs, num_bytes + 33)
    return lib.Circuit(
        current_witness_index=num_witness - 1,
        opcodes=opcodes,
        private_parameters=set(inputs),
    )


def sha256_inputs(batch: int, seed: int = 11, num_bytes: int = 32):
    """Seeded messages for :func:`build_sha256_circuit`, columnar: witness i + 1
    holds byte i of every message, as a (batch,) uint8 array."""
    import numpy as np

    msgs = np.random.default_rng(seed).integers(0, 256, size=(num_bytes, batch), dtype=np.uint8)
    return {i + 1: msgs[i] for i in range(num_bytes)}


def build_array_circuit(
    num_blocks: int = 8,
    block_size: int = 1024,
    rounds: int = 32,
    final_reads: int = 4,
    num_seeds: int = 32,
    lib=None,
):
    """Noir arrays read and written at runtime indices: ``num_blocks`` memory
    blocks of ``block_size`` entries.

    * Inputs: ``num_seeds`` seeds s_0.. (w1..), then the index of every access
      and the edge opcodes' flags, each a fresh input where it is used.
    * Entry j of block k is a_kj = s_(j mod num_seeds) + (k + 1) j: one static
      solve gate each, all in one level; then ``MemoryInit`` of each block.
    * ``rounds`` rounds a block, each ``x = A_k[i]``, ``y = x s_r + r`` and
      ``A_k[j] = y`` (s_r = s_(r mod num_seeds)), i and j runtime inputs.
    * ``final_reads`` reads a block at runtime indices.
    * Three edge opcodes: a read of block 0 under a predicate witness; a read
      of block 1 under a runtime operation selector (0 reads, anything else
      would write the still unknown value and fail); a write to block 2 of an
      already known witness under a runtime selector (where it is 0 the
      opcode reads into a known witness and fails, as ``pwg.ACVM`` does).

    Returns the circuit; :func:`array_inputs` fills its inputs.  ``lib`` as in
    :func:`build_u32_circuit`.  The defaults give 9,003 opcodes over 9,320
    witnesses."""
    lib = lib or PORT_CLASSES
    o, fe, W = lib.opcodes, lib.FieldElement, lib.Witness
    next_witness = 1
    inputs = []

    def fresh(is_input=False):
        nonlocal next_witness
        next_witness += 1
        w = W(next_witness - 1)
        if is_input:
            inputs.append(w)
        return w

    def expr(w):
        return lib.Expression.from_witness(w)

    def mem_op(k, operation, index, value, predicate=None):
        return o.OpcodeMemoryOp(o.BlockId(k), o.MemOp(operation, index, value), predicate)

    zero, one = lib.Expression.zero(), lib.Expression.from_field(fe(1))
    seeds = [fresh(True) for _ in range(num_seeds)]
    opcodes = []
    blocks = []
    for k in range(num_blocks):
        entries = [fresh() for _ in range(block_size)]
        for j, a in enumerate(entries):
            opcodes.append(o.OpcodeArithmetic(lib.Expression(
                linear_combinations=[(fe(1), seeds[j % num_seeds]), (-fe(1), a)],
                q_c=fe((k + 1) * j))))
        blocks.append(entries)
    opcodes.extend(o.OpcodeMemoryInit(o.BlockId(k), entries) for k, entries in enumerate(blocks))
    for r in range(rounds):
        s_r = seeds[r % num_seeds]
        for k in range(num_blocks):
            x, y = fresh(), fresh()
            opcodes.append(mem_op(k, zero, expr(fresh(True)), expr(x)))
            opcodes.append(o.OpcodeArithmetic(lib.Expression(
                mul_terms=[(fe(1), min(x, s_r), max(x, s_r))],
                linear_combinations=[(-fe(1), y)], q_c=fe(r))))
            opcodes.append(mem_op(k, one, expr(fresh(True)), expr(y)))
    for k in range(num_blocks):
        for _ in range(final_reads):
            opcodes.append(mem_op(k, zero, expr(fresh(True)), expr(fresh())))
    pred = fresh(True)
    opcodes.append(mem_op(0, zero, expr(fresh(True)), expr(fresh()), predicate=expr(pred)))
    sel = fresh(True)
    opcodes.append(mem_op(1 % num_blocks, expr(sel), expr(fresh(True)), expr(fresh())))
    sel = fresh(True)
    opcodes.append(mem_op(2 % num_blocks, expr(sel), expr(fresh(True)), expr(seeds[0])))
    return lib.Circuit(
        current_witness_index=next_witness - 1,
        opcodes=opcodes,
        private_parameters=set(inputs),
    )


def build_uint_ops_circuit(width: int = 32, lib=None):
    """Every operation of the stdlib's ``UIntGadget`` (reference
    stdlib/src/blackbox_fallbacks/uint.rs) once, over the inputs x = w1 and
    y = w2 of ``width`` bits: add, sub, mul, and, xor, or, not, rol by 7, ror by
    11, left shift by 5, right shift by 9, x >= y, x < y and the Euclidean
    division x / y (a Quotient, its range checks and constraints; y = 0 fails
    the instance).  Each is a Brillig hint and the constraints that check it.
    Returns ``(circuit, outputs)``, the output witness of each operation by
    name.  ``lib`` as in :func:`build_sha256_circuit`."""
    lib = lib or PORT_CLASSES
    W, UInt = lib.Witness, lib.stdlib.UIntGadget
    x, y = UInt(W(1), width), UInt(W(2), width)
    num_witness = 3
    opcodes, outputs = [], {}
    binary = ("add", "sub", "mul", "and_", "xor", "or_", "more_than_eq_comparison",
              "less_than_comparison")
    for name in binary:
        out, ops_, num_witness = getattr(x, name)(y, num_witness)
        opcodes += ops_
        outputs[name] = out.inner
    for name, arg in (("rol", 7), ("ror", 11), ("leftshift", 5), ("rightshift", 9)):
        out, ops_, num_witness = getattr(x, name)(arg, num_witness)
        opcodes += ops_
        outputs[name] = out.inner
    out, ops_, num_witness = x.not_(num_witness)
    opcodes += ops_
    outputs["not_"] = out.inner
    q, r, ops_, num_witness = UInt.euclidean_division(x, y, num_witness)
    opcodes += ops_
    outputs["div_q"], outputs["div_r"] = q.inner, r.inner
    circuit = lib.Circuit(current_witness_index=num_witness - 1, opcodes=opcodes,
                          private_parameters={W(1), W(2)})
    return circuit, outputs


def array_inputs(circuit, batch: int, seed: int = 13, fail_instance=None):
    """Columnar inputs of :func:`build_array_circuit`: every index below its
    block's size, the predicate witness 0 or 1 at random, the reading
    selector 0, the writing selector a random nonzero u32, and random field
    elements for the seeds (every other input).  With ``fail_instance`` set,
    that instance's index of the middle memory opcode is its block's size: it
    fails at that opcode and no other instance fails.  Returns ``(columns,
    fail_opcode)`` (None without ``fail_instance``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    size, mem_ops, cols = {}, [], {}

    def col(e):
        return int(e.linear_combinations[0][1])

    for index, op in enumerate(circuit.opcodes):  # either package's classes
        if type(op).__name__ == "OpcodeMemoryOp":
            mem_ops.append((index, op))
            cols[col(op.op.index)] = rng.integers(0, size[op.block_id.id], size=batch,
                                                  dtype=np.uint64)
            if op.predicate is not None:
                cols[col(op.predicate)] = rng.integers(0, 2, size=batch, dtype=np.uint64)
        elif type(op).__name__ == "OpcodeMemoryInit":
            size[op.block_id.id] = len(op.init)
    reading, writing = [op.op.operation for _, op in mem_ops[-2:]]
    cols[col(reading)] = np.zeros(batch, np.uint64)
    cols[col(writing)] = rng.integers(1, 1 << 32, size=batch, dtype=np.uint64)
    pyrng = random.Random(seed)
    for w in sorted(int(w) for w in circuit.private_parameters if int(w) not in cols):
        cols[w] = np.array([pyrng.randrange(BN254_FR.modulus) for _ in range(batch)], dtype=object)
    if fail_instance is None:
        return cols, None
    index, op = mem_ops[len(mem_ops) // 2]
    cols[col(op.op.index)][fail_instance] = size[op.block_id.id]
    return cols, index


# The binary ops of a Brillig block and the bit sizes the ops circuit runs
# them at; the VM shifts only up to 128 bits (brillig_vm/vm.py:159).
BRILLIG_BIT_SIZES = (1, 8, 32, 64, 127, 128, 254, 256)


def build_brillig_ops_circuit(lib=None):
    """One straight-line Brillig block for each binary op: the 5 field ops,
    and the 13 int ops at each of :data:`BRILLIG_BIT_SIZES` (the shifts at
    128 bits and below, by the constant bit_size // 2), each over the inputs
    w1, w2 into one fresh witness.  Then two blocks of several steps: one
    under the predicate w3 (a 32-bit add and a field product), and one that
    reads a compound input (w1 + 2 w2), renames registers with ``Mov`` and
    ``Const`` and chains a 64-bit product, a field add and a 128-bit
    subtraction.  ``lib`` as in :func:`build_u32_circuit`, with ``brillig``
    (the package's Brillig opcodes) beside the classes."""
    lib = lib or PORT_CLASSES
    o, fe, W, b = lib.opcodes, lib.FieldElement, lib.Witness, lib.brillig
    R = b.RegisterIndex
    a_w, b_w, pred = W(1), W(2), W(3)
    next_witness = 4
    opcodes = []

    def block(code, n_out=1, inputs=None, predicate=None):
        nonlocal next_witness
        outs = [W(next_witness + i) for i in range(n_out)]
        next_witness += n_out
        ins = inputs or [lib.Expression.from_witness(a_w), lib.Expression.from_witness(b_w)]
        opcodes.append(o.OpcodeBrillig(o.Brillig(
            inputs=[o.BrilligInputSingle(e) for e in ins],
            outputs=[o.BrilligOutputSimple(w) for w in outs],
            foreign_call_results=[], bytecode=list(code) + [b.OpStop()], predicate=predicate)))

    for op in b.BinaryFieldOp:
        block([b.OpBinaryFieldOp(R(0), op, R(0), R(1))])
    for bits in BRILLIG_BIT_SIZES:
        for op in b.BinaryIntOp:
            if op in (b.BinaryIntOp.Shl, b.BinaryIntOp.Shr):
                if bits > 128:
                    continue
                block([b.OpConst(R(1), b.Value(fe(bits // 2))),
                       b.OpBinaryIntOp(R(0), op, bits, R(0), R(1))])
            else:
                block([b.OpBinaryIntOp(R(0), op, bits, R(0), R(1))])
    block([b.OpBinaryIntOp(R(2), b.BinaryIntOp.Add, 32, R(0), R(1)),
           b.OpBinaryFieldOp(R(1), b.BinaryFieldOp.Mul, R(0), R(1)),
           b.OpMov(R(0), R(2))], n_out=2, predicate=lib.Expression.from_witness(pred))
    compound = lib.Expression(linear_combinations=[(fe(1), a_w), (fe(2), b_w)])
    block([b.OpMov(R(2), R(0)),
           b.OpConst(R(3), b.Value(fe((1 << 64) - 3))),
           b.OpBinaryIntOp(R(0), b.BinaryIntOp.Mul, 64, R(2), R(3)),
           b.OpBinaryFieldOp(R(1), b.BinaryFieldOp.Add, R(0), R(1)),
           b.OpBinaryIntOp(R(2), b.BinaryIntOp.Sub, 128, R(0), R(1))],
          n_out=3, inputs=[compound, lib.Expression.from_witness(b_w)])
    return lib.Circuit(
        current_witness_index=next_witness - 1,
        opcodes=opcodes,
        private_parameters={a_w, b_w, pred},
    )


def brillig_ops_inputs(batch: int, modulus: int = BN254_FR.modulus, seed: int = 17):
    """Columnar (w1, w2, w3) for :func:`build_brillig_ops_circuit`: pairs of
    the n edge values 0, 1, 2, p - 1, p - 2 and, for each bit size k, 2^k - 1,
    2^(k-1), 2^k and a random k-bit value (those below p), then random field
    elements; w3 (the predicate) 0 or 1 at random.  Instance i = q n + r
    pairs edge r with edge 3r + q (mod n): every edge is a left operand in
    each n instances, n instances from q = 0 pair it with three right
    operands, and the first n^2 instances hold every pair once."""
    import numpy as np

    rng = random.Random(seed)
    edges = {0, 1, 2, modulus - 1, modulus - 2}
    for k in BRILLIG_BIT_SIZES:
        edges.update({(1 << k) - 1, 1 << (k - 1), 1 << k, rng.randrange(1 << k)})
    edges = sorted(v for v in edges if v < modulus)
    n = len(edges)
    pairs = [(edges[i % n], edges[(3 * (i % n) + i // n) % n]) for i in range(min(batch, n * n))]
    pairs += [(rng.randrange(modulus), rng.randrange(modulus)) for _ in range(batch - len(pairs))]
    return {
        1: np.array([x for x, _ in pairs], dtype=object),
        2: np.array([y for _, y in pairs], dtype=object),
        3: np.array([rng.randrange(2) for _ in range(batch)], dtype=np.uint64),
    }


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


HASH_KINDS = {"sha256": ops.BBSha256, "blake2s": ops.BBBlake2s, "keccak256": ops.BBKeccak256}


def build_gadget_circuit(
    kind: str, num_gadgets: int = 8, msg_len: int = 64
) -> Circuit:
    """A circuit of ``num_gadgets`` independent black-box gadget calls, for
    gadget-throughput measurements.

    kinds: "sha256" / "blake2s" / "keccak256" (per gadget: ``msg_len``
    byte-witness inputs -> 32 byte-witness outputs), "pedersen" (2 field
    inputs -> commitment point x, y), "fixed_base" (2 u128-limb inputs ->
    point x, y), "schnorr" (pub x/y + 64 sig bytes + ``msg_len`` message
    bytes -> bool), and "ecdsa_k1" / "ecdsa_r1" (32+32 pubkey bytes + 64 sig
    bytes + 32 hashed-message bytes -> bool).
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
        elif kind in ("ecdsa_k1", "ecdsa_r1"):
            px = fresh_n(32)
            py = fresh_n(32)
            sig = fresh_n(64)
            hashed = fresh_n(32)
            input_witnesses.extend(px + py + sig + hashed)
            cls = ops.BBEcdsaSecp256k1 if kind == "ecdsa_k1" else ops.BBEcdsaSecp256r1
            call = cls(
                public_key_x=[ops.FunctionInput(w, 8) for w in px],
                public_key_y=[ops.FunctionInput(w, 8) for w in py],
                signature=[ops.FunctionInput(w, 8) for w in sig],
                hashed_message=[ops.FunctionInput(w, 8) for w in hashed],
                output=fresh(),
            )
        elif kind in HASH_KINDS:
            ins = fresh_n(msg_len)
            input_witnesses.extend(ins)
            call = HASH_KINDS[kind](
                inputs=[ops.FunctionInput(w, 8) for w in ins],
                outputs=fresh_n(32),
            )
        else:
            raise NotImplementedError(
                f"build_gadget_circuit: kind {kind!r} is not ported (sha256, blake2s, "
                "keccak256, pedersen, fixed_base, schnorr, ecdsa_k1 and ecdsa_r1 are)"
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
    bulk ingest path of ``BatchSolver.initial_state``.  Bytes (hash messages)
    come back as uint8 arrays, pedersen field scalars as object arrays,
    fixed-base limbs as uint64 arrays, and every schnorr instance carries the
    same valid signature."""
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
    if kind in ("ecdsa_k1", "ecdsa_r1"):
        from ..blackbox.ec import secp256k1, secp256r1

        curve = secp256k1 if kind == "ecdsa_k1" else secp256r1
        pyrng = random.Random(seed)
        n = curve.params.n
        d = pyrng.randrange(1, n)
        Q = curve.mul(d, curve.generator())
        cols = {}
        for opcode in circuit.opcodes:
            call = opcode.call
            z_bytes = bytes(pyrng.randrange(256) for _ in range(32))
            z = int.from_bytes(z_bytes, "big")
            while True:
                k = pyrng.randrange(1, n)
                r = curve.mul(k, curve.generator())[0] % n
                if r == 0:
                    continue
                s = pow(k, -1, n) * (z + r * d) % n
                if s == 0:
                    continue
                if s > n // 2:
                    s = n - s  # low-S (blackbox_solver/src/lib.rs:101-210)
                break
            sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
            qx = Q[0].to_bytes(32, "big")
            qy = Q[1].to_bytes(32, "big")
            for j, fi in enumerate(call.public_key_x):
                cols[int(fi.witness)] = np.full(batch, qx[j], dtype=np.uint8)
            for j, fi in enumerate(call.public_key_y):
                cols[int(fi.witness)] = np.full(batch, qy[j], dtype=np.uint8)
            for j, fi in enumerate(call.signature):
                cols[int(fi.witness)] = np.full(batch, sig[j], dtype=np.uint8)
            for j, fi in enumerate(call.hashed_message):
                cols[int(fi.witness)] = np.full(batch, z_bytes[j], dtype=np.uint8)
        return cols
    if kind in HASH_KINDS:
        return {w: rng.integers(0, 256, size=batch, dtype=np.uint8) for w in witnesses}
    raise NotImplementedError(
        f"gadget_inputs_columnar: kind {kind!r} is not ported (sha256, blake2s, "
        "keccak256, pedersen, fixed_base, schnorr, ecdsa_k1 and ecdsa_r1 are)"
    )


ECDSA_CURVES = {"ecdsa_k1": "secp256k1", "ecdsa_r1": "secp256r1"}


def _ecdsa_curve(kind: str):
    from ..blackbox.ec import secp256k1, secp256r1

    return {"ecdsa_k1": secp256k1, "ecdsa_r1": secp256r1}[kind]


def _ecdsa_sign(curve, rng: random.Random, d: int, z: int):
    """A low-S signature (r, s) of the scalar z under key d."""
    n = curve.params.n
    while True:
        k = rng.randrange(1, n)
        r = curve.mul(k, curve.generator())[0] % n
        s = pow(k, -1, n) * (z + r * d) % n
        if r and s:
            return r, min(s, n - s)


def _sqrt_mod(a: int, p: int):
    """A square root mod p (p = 3 mod 4, as both curves' p), or None."""
    y = pow(a, (p + 1) // 4, p)
    return y if y * y % p == a % p else None


def ecdsa_planted(kind: str, seed: int = 5):
    """The edge cases of ECDSA verification, each a ``(label, (x, y, r, s,
    z), valid, err)`` of Python ints (x, y the key, z the hashed message) and
    what the reference verifier says of it: ``err`` where it raises (a
    coordinate >= p, an off-curve key, r or s zero or >= n, z >= n), else
    ``valid``.

    valid; tampered s; high S; off-curve key; r = 0, r = n, s = 0, z = n;
    z = 0 (u1 G at infinity, valid); z = -r d (u1 G = -u2 Q: R at infinity);
    z = r d with s = 2 r d / k (u1 G = u2 Q: the doubling branch, valid);
    x(R) >= n (R with x in [n, p), Q = c R, z = 0, s = r c, the sign of c
    picked for low S: the conditional subtract of x(R) mod n, valid)."""
    curve = _ecdsa_curve(kind)
    cp = curve.params
    n, p = cp.n, cp.p
    rng = random.Random(seed)
    d = rng.randrange(1, n)
    Q = curve.mul(d, curve.generator())
    z = rng.randrange(n)
    r, s = _ecdsa_sign(curve, rng, d, z)
    cases = [
        ("valid", (*Q, r, s, z), True, False),
        ("tampered_s", (*Q, r, s - 1 if s > 1 else s + 1, z), False, False),
        ("high_s", (*Q, r, n - s, z), False, False),
        ("off_curve_key", (Q[0], (Q[1] + 1) % p, r, s, z), False, True),
        ("r_zero", (*Q, 0, s, z), False, True),
        ("r_n", (*Q, n, s, z), False, True),
        ("s_zero", (*Q, r, 0, z), False, True),
        ("z_n", (*Q, r, s, n), False, True),
    ]
    r0, s0 = _ecdsa_sign(curve, rng, d, 0)
    cases.append(("z_zero", (*Q, r0, s0, 0), True, False))
    r1, s1 = _ecdsa_sign(curve, rng, d, 1)
    cases.append(("r_at_infinity", (*Q, r1, s1, (-r1 * d) % n), False, False))
    while True:  # u1 G = u2 Q = (k / 2) G
        k = rng.randrange(1, n)
        r2 = curve.mul(k, curve.generator())[0] % n
        s2 = 2 * r2 * d * pow(k, -1, n) % n
        if r2 and s2:
            break
    cases.append(("u1G_eq_u2Q", (*Q, r2, min(s2, n - s2), r2 * d % n), True, False))
    t = 1  # R = (n + t, y): x(R) mod n = t = r
    while (y_big := _sqrt_mod(pow(n + t, 3, p) + cp.a * (n + t) + cp.b, p)) is None:
        t += 1
    c = rng.randrange(1, n)
    if t * c % n > n // 2:
        c = n - c
    Qc = curve.mul(c, (n + t, y_big))  # u2 = r / s = 1 / c: u2 Q = R
    cases.append(("x_of_R_ge_n", (*Qc, t, t * c % n, 0), True, False))
    return cases


def ecdsa_mul_edges(kind: str, seed: int = 5):
    """Lanes of R = u1 G + u2 Q at the edges of ``ecdsa_mul``'s chain, each a
    ``(label, u1, u2, Q)`` of Python ints (Q an affine pair; the scalars
    taken as they come, all 256 bits): u2 = 0, 1, 7, 8, 15, 16 (the low
    window's digit and carry), n - 1, 2^255 and 2^256 - 1 (every nibble 15:
    a top window that carries); u1 = 0; u1 G = u2 Q and u1 G = -u2 Q (the
    last addition's doubling and infinity); u2 = n + 2 s_0 (the accumulator
    equals the last window's entry: the doubling inside the ladder) and u2 =
    n (its negative: infinity there); an off-curve Q with Y = 0 (its lane is
    run all the same: 2Q has Z = 0)."""
    curve = _ecdsa_curve(kind)
    n, p = curve.params.n, curve.params.p
    rng = random.Random(seed)
    d = rng.randrange(1, n)
    Q = curve.mul(d, curve.generator())
    lanes = [(f"u2_{label}", rng.randrange(n), k2, Q) for label, k2 in (
        ("0", 0), ("1", 1), ("7", 7), ("8", 8), ("15", 15), ("16", 16), ("n-1", n - 1),
        ("2^255", 1 << 255), ("2^256-1", (1 << 256) - 1))]
    k2 = rng.randrange(1, n)
    lanes += [("u1_0", 0, k2, Q), ("u1G_eq_u2Q", k2 * d % n, k2, Q),
              ("u1G_eq_minus_u2Q", -k2 * d % n, k2, Q)]
    s0 = (8 - n) % 16 - 8  # the low digit s of n + 2s is s itself
    assert s0 != 0
    lanes += [("acc_eq_entry", rng.randrange(n), n + 2 * s0, Q),
              ("acc_eq_minus_entry", rng.randrange(n), n, Q)]
    x = rng.randrange(1, p)
    assert not curve.is_on_curve((x, 0))
    lanes.append(("off_curve_y_0", rng.randrange(n), rng.randrange(n), (x, 0)))
    return lanes


def ecdsa_instance_bytes(values) -> Dict[str, bytes]:
    """(x, y, r, s, z) -> the gadget's byte strings, big-endian."""
    x, y, r, s, z = values
    return {"pub_x": x.to_bytes(32, "big"), "pub_y": y.to_bytes(32, "big"),
            "sig": r.to_bytes(32, "big") + s.to_bytes(32, "big"), "msg": z.to_bytes(32, "big")}


def ecdsa_inputs(circuit: Circuit, batch: int, kind: str, seed: int = 7, pool: int = 256):
    """Columnar uint16 inputs for an ECDSA gadget circuit over ``batch``
    instances, and what each gadget of each instance must give.

    Each gadget draws from its own pool of up to ``pool`` distinct (key,
    message, low-S signature) tuples, made from ``seed`` and tiled over the
    batch, so neighbouring instances run different scalars.  The k cases of
    :func:`ecdsa_planted` come first: instance i < k holds case i on gadget
    0 and case i + 1 (mod k) on gadget 1 (so an instance fails at opcode 0 or
    at opcode 1, whichever gadget errs first), and instance k has the
    signature byte 63 of gadget 0 raised by 256 (only the low byte is read).

    Returns ``(cols, valid, err)``: ``{witness: (B,) uint16}`` and two
    ``(G, B)`` bool arrays."""
    import numpy as np

    curve = _ecdsa_curve(kind)
    n = curve.params.n
    rng = random.Random(seed)
    G = len(circuit.opcodes)
    per_gadget = []
    for _ in range(G):
        tuples = []
        for _ in range(min(pool, batch)):
            d = rng.randrange(1, n)
            Q = curve.mul(d, curve.generator())
            z = rng.randrange(n)
            r, s = _ecdsa_sign(curve, rng, d, z)
            tuples.append((*Q, r, s, z))
        per_gadget.append(tuples)
    rows = [[per_gadget[g][b % len(per_gadget[g])] for b in range(batch)] for g in range(G)]
    valid = np.ones((G, batch), dtype=bool)
    err = np.zeros((G, batch), dtype=bool)
    cases = ecdsa_planted(kind, seed)
    for b in range(min(len(cases), batch)):
        for g in range(min(G, 2)):
            _, values, ok, bad = cases[(b + g) % len(cases)]
            rows[g][b] = values
            valid[g, b], err[g, b] = ok and not bad, bad
    cols = {}
    for g, opcode in enumerate(circuit.opcodes):
        call = opcode.call
        raw = np.zeros((batch, 160), dtype=np.uint16)
        for b, values in enumerate(rows[g]):
            parts = ecdsa_instance_bytes(values)
            raw[b] = np.frombuffer(parts["pub_x"] + parts["pub_y"] + parts["sig"] + parts["msg"],
                                   dtype=np.uint8)
        witnesses = [*call.public_key_x, *call.public_key_y, *call.signature,
                     *call.hashed_message]
        for j, fi in enumerate(witnesses):
            cols[int(fi.witness)] = raw[:, j].copy()
    if G and batch > len(cases):
        cols[int(circuit.opcodes[0].call.signature[63].witness)][len(cases)] += 256
    return cols, valid, err


def columnar_instance(columnar, index: int) -> Dict[int, int]:
    """Extract one instance from columnar inputs as a {witness: int} dict."""
    return {w: int(a[index]) for w, a in columnar.items()}


def sort_network_bits(n: int) -> int:
    """Control bits of the AS-Waksman network over n wires, as
    ``pwg.sorting.route`` emits them: 129 for 32, 321 for 64, 769 for 128."""
    if n < 2:
        return 0
    if n == 2:
        return 1
    return n // 2 + (n - 1) // 2 + sort_network_bits(n // 2) + sort_network_bits(n - n // 2)


def oracle_affine(name: str, inputs):
    """The foreign-call handler of :func:`build_sort_circuit`'s oracle block:
    ``oracle_affine(x) = 3 x + 1 mod p``."""
    if name != "oracle_affine":
        raise ValueError(f"unknown oracle {name!r}")
    return [(3 * int(inputs[0][0]) + 1) % BN254_FR.modulus]


def build_sort_circuit(n: int = 64, lib=None):
    """The ACIR of a Noir program that sorts an array of ``n`` u32 values,
    prints the decimal digits of their sum and asks an oracle for a value it
    then constrains, in that opcode order:

    * ``Range(k_i, 32)`` for each input key k_i (witnesses 1..n), and the
      solve gate ``total = sum k_i``;
    * ``PermutationSort(inputs=[[k_i]], tuple_size=1, sort_by=[0])`` into
      :func:`sort_network_bits` (n) control bits, each checked boolean
      (``c c - c = 0``);
    * the AS-Waksman switch network those bits drive, wired in the order
      ``route()`` emits them (``pwg/sorting.py``: the input switches, the
      output switches, then the two sub-networks): a switch of bit c over
      (a, b) is the two solve gates ``out_a = a + c b - c a`` and
      ``out_b = b - c b + c a``; its outputs are the sorted keys s_i;
    * each difference ``d_i = s_(i+1) - s_i`` as a solve gate and
      ``Range(d_i, 32)``;
    * ``ToLeRadix(total, radix=10)`` into 12 digits, each ``Range(digit, 4)``,
      and the check ``sum 10^j digit_j - total = 0``;
    * a Brillig block that makes one foreign call (``"oracle_affine"``, input
      ``total``) and returns its answer, and the check
      ``answer - (3 total + 1) = 0``: solve with
      ``foreign_call_handler=oracle_affine``.

    n = 64: 1,171 opcodes over 1,104 witnesses.  ``lib`` as in
    :func:`build_brillig_ops_circuit`; :func:`sort_circuit_roles` names its
    witnesses."""
    return _sort_circuit(n, lib or PORT_CLASSES)[0]


def sort_circuit_roles(n: int = 64) -> Dict[str, List[int]]:
    """The witnesses of :func:`build_sort_circuit` (n) by role: ``keys``,
    ``total``, ``bits``, ``sorted`` (the network's outputs), ``diffs``,
    ``digits`` (little-endian) and ``answer`` (the oracle's)."""
    return _sort_circuit(n, PORT_CLASSES)[1]


def _sort_circuit(n: int, lib):
    
    o, fe, W, b = lib.opcodes, lib.FieldElement, lib.Witness, lib.brillig
    keys = [W(1 + i) for i in range(n)]
    next_witness = n + 1
    opcodes = []

    def fresh():
        nonlocal next_witness
        next_witness += 1
        return W(next_witness - 1)

    def gate(mul=(), lin=(), q=0):
        opcodes.append(o.OpcodeArithmetic(lib.Expression(
            mul_terms=[(fe(c), x, y) for c, x, y in mul],
            linear_combinations=[(fe(c), x) for c, x in lin], q_c=fe(q))))

    def range_check(w, bits):
        opcodes.append(o.OpcodeBlackBoxFuncCall(o.BBRange(o.FunctionInput(w, bits))))

    for k in keys:
        range_check(k, 32)
    total = fresh()
    gate(lin=[(1, k) for k in keys] + [(-1, total)])
    bits = [fresh() for _ in range(sort_network_bits(n))]
    opcodes.append(o.OpcodeDirective(o.DirPermutationSort(
        inputs=[[lib.Expression.from_witness(k)] for k in keys], tuple_size=1, bits=bits,
        sort_by=[0])))
    for c in bits:
        gate(mul=[(1, c, c)], lin=[(-1, c)])

    def switch(c, x, y):
        out_a, out_b = fresh(), fresh()
        gate(mul=[(1, c, y), (-1, c, x)], lin=[(1, x), (-1, out_a)])
        gate(mul=[(-1, c, y), (1, c, x)], lin=[(1, y), (-1, out_b)])
        return out_a, out_b

    def network(xs, off):
        """Outputs of the network over the wires xs whose bits start at
        bits[off] (the layout of route()'s result)."""
        m = len(xs)
        if m == 1:
            return list(xs)
        if m == 2:
            return list(switch(bits[off], xs[0], xs[1]))
        m1 = m // 2
        inner = [None] * m
        for i in range(m // 2):
            inner[i], inner[i + m1] = switch(bits[off + i], xs[2 * i], xs[2 * i + 1])
        if m % 2:
            inner[m - 1] = xs[m - 1]
        off_y = off + m // 2
        off_sub = off_y + (m - 1) // 2
        iy = network(inner[:m1], off_sub) + network(inner[m1:], off_sub + sort_network_bits(m1))
        ys = [None] * m
        for j in range((m - 1) // 2):
            ys[2 * j], ys[2 * j + 1] = switch(bits[off_y + j], iy[j], iy[j + m1])
        ys[m - 1] = iy[m - 1]
        if m % 2 == 0:
            ys[m - 2] = iy[m1 - 1]
        return ys

    s = network(keys, 0)
    diffs = []
    for lo, hi in zip(s, s[1:]):
        diffs.append(fresh())
        gate(lin=[(1, hi), (-1, lo), (-1, diffs[-1])])
        range_check(diffs[-1], 32)
    digits = [fresh() for _ in range(12)]
    opcodes.append(o.OpcodeDirective(o.DirToLeRadix(lib.Expression.from_witness(total), digits, 10)))
    for dg in digits:
        range_check(dg, 4)
    gate(lin=[(10 ** j, dg) for j, dg in enumerate(digits)] + [(-1, total)])
    answer = fresh()
    R0 = b.RomRegister(b.RegisterIndex(0))
    opcodes.append(o.OpcodeBrillig(o.Brillig(
        inputs=[o.BrilligInputSingle(lib.Expression.from_witness(total))],
        outputs=[o.BrilligOutputSimple(answer)], foreign_call_results=[],
        bytecode=[b.OpForeignCall("oracle_affine", (R0,), (R0,)), b.OpStop()], predicate=None)))
    gate(lin=[(1, answer), (-3, total)], q=-1)
    circuit = lib.Circuit(current_witness_index=next_witness - 1, opcodes=opcodes,
                          private_parameters=set(keys))
    roles = dict(keys=keys, total=[total], bits=bits, sorted=s, diffs=diffs, digits=digits,
                 answer=[answer])
    return circuit, {k: [int(w) for w in v] for k, v in roles.items()}


def sort_inputs(circuit, batch: int, seed: int = 21, fail_instance=None):
    """Columnar keys of :func:`build_sort_circuit`, a (batch,) uint64 array a
    key: random u32 values, except that every fourth instance (b = 1 mod 4)
    draws its keys from 0..15, so that it sorts duplicates.  With
    ``fail_instance`` set, that instance's middle key is 2^32: it fails its
    ``Range`` (opcode n // 2, the first opcode it fails) and no other
    instance fails.  Returns ``(columns, fail_opcode)`` (None without
    ``fail_instance``)."""
    import numpy as np

    n = len(circuit.private_parameters)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, size=(n, batch), dtype=np.uint64)
    dup = np.arange(batch) % 4 == 1
    keys[:, dup] = rng.integers(0, 16, size=(n, int(dup.sum())), dtype=np.uint64)
    fail_op = None
    if fail_instance is not None:
        keys[n // 2, fail_instance] = 1 << 32
        fail_op = n // 2
    return {1 + i: keys[i] for i in range(n)}, fail_op


# ---------------------------------------------------------------------------
# Unconstrained loops: the device Brillig VM's circuits
# ---------------------------------------------------------------------------


def insertion_sort_bytecode(n: int, b=br) -> list:
    """An unconstrained insertion sort of the n words of memory at the pointer
    in r0, in place; r0 (the output array's pointer) is left as it was.  The
    inner loop loads a neighbouring pair, compares it at 32 bits and calls a
    two-Store swap helper that returns: 22 opcodes, n (n - 1) / 2 swaps at
    most (1,656 opcodes for 16 keys in descending order)."""
    R, I, V = b.RegisterIndex, b.BinaryIntOp, b.Value.from_int
    return [
        b.OpConst(R(1), V(n)),                                  # 0: r1 = n
        b.OpConst(R(4), V(1)),                                  # 1: r4 = 1
        b.OpConst(R(2), V(1)),                                  # 2: i = 1
        b.OpBinaryIntOp(R(9), I.LessThan, 32, R(2), R(1)),      # 3: outer: i < n?
        b.OpJumpIfNot(R(9), 18),                                # 4
        b.OpMov(R(3), R(2)),                                    # 5: j = i
        b.OpJumpIfNot(R(3), 16),                                # 6: inner: j == 0 -> next i
        b.OpBinaryIntOp(R(6), I.Add, 32, R(0), R(3)),           # 7: &a[j]
        b.OpBinaryIntOp(R(5), I.Sub, 32, R(6), R(4)),           # 8: &a[j - 1]
        b.OpLoad(R(7), R(5)),                                   # 9
        b.OpLoad(R(8), R(6)),                                   # 10
        b.OpBinaryIntOp(R(9), I.LessThanEquals, 32, R(7), R(8)),  # 11: in order?
        b.OpJumpIf(R(9), 16),                                   # 12
        b.OpCall(19),                                           # 13: swap
        b.OpBinaryIntOp(R(3), I.Sub, 32, R(3), R(4)),           # 14: j -= 1
        b.OpJump(6),                                            # 15
        b.OpBinaryIntOp(R(2), I.Add, 32, R(2), R(4)),           # 16: next i
        b.OpJump(3),                                            # 17
        b.OpStop(),                                             # 18
        b.OpStore(R(5), R(8)),                                  # 19: swap: a[j - 1] = a[j]
        b.OpStore(R(6), R(7)),                                  # 20:       a[j] = a[j - 1]
        b.OpReturn(),                                           # 21
    ]


def isqrt_bytecode(b=br) -> list:
    """r0 = isqrt(r0) for r0 < 2^36 by binary search at 64 bits: lo = 0,
    hi = 2^18 + 1 (lo^2 <= s < hi^2), mid = (lo + hi) / 2 by an UnsignedDiv,
    about 19 iterations of 10 opcodes."""
    R, I, V = b.RegisterIndex, b.BinaryIntOp, b.Value.from_int
    return [
        b.OpConst(R(1), V(0)),                                  # 0: lo
        b.OpConst(R(2), V((1 << 18) + 1)),                      # 1: hi
        b.OpConst(R(3), V(1)),                                  # 2
        b.OpConst(R(4), V(2)),                                  # 3
        b.OpBinaryIntOp(R(5), I.Add, 64, R(1), R(3)),           # 4: loop: lo + 1 < hi?
        b.OpBinaryIntOp(R(6), I.LessThan, 64, R(5), R(2)),      # 5
        b.OpJumpIfNot(R(6), 16),                                # 6
        b.OpBinaryIntOp(R(7), I.Add, 64, R(1), R(2)),           # 7
        b.OpBinaryIntOp(R(7), I.UnsignedDiv, 64, R(7), R(4)),   # 8: mid
        b.OpBinaryIntOp(R(8), I.Mul, 64, R(7), R(7)),           # 9
        b.OpBinaryIntOp(R(9), I.LessThanEquals, 64, R(8), R(0)),  # 10: mid^2 <= s?
        b.OpJumpIfNot(R(9), 14),                                # 11
        b.OpMov(R(1), R(7)),                                    # 12: lo = mid
        b.OpJump(4),                                            # 13
        b.OpMov(R(2), R(7)),                                    # 14: hi = mid
        b.OpJump(4),                                            # 15
        b.OpMov(R(0), R(1)),                                    # 16
        b.OpStop(),                                             # 17
    ]


def inverse_bytecode(b=br) -> list:
    """r0 = 1 / (r0 - r1) in the field, trapping where r0 = r1 (an
    ``assert(x != 0)`` before the inverse)."""
    R, F = b.RegisterIndex, b.BinaryFieldOp
    return [
        b.OpBinaryFieldOp(R(2), F.Sub, R(0), R(1)),             # 0: x
        b.OpConst(R(3), b.Value.from_int(0)),                   # 1
        b.OpBinaryFieldOp(R(4), F.Equals, R(2), R(3)),          # 2
        b.OpJumpIfNot(R(4), 5),                                 # 3
        b.OpTrap(),                                             # 4
        b.OpConst(R(5), b.Value.from_int(1)),                   # 5
        b.OpBinaryFieldOp(R(0), F.Div, R(5), R(2)),             # 6
        b.OpStop(),                                             # 7
    ]


def build_brillig_vm_circuit(n_keys: int = 16, seed: int = 31, lib=None):
    """The ACIR of a Noir program that calls three ``unconstrained`` helpers
    with loops and constrains their answers, in that opcode order:

    * ``Range(k_i, 32)`` for each key k_i (witnesses 1..n), and the solve gate
      ``s = sum k_i``;
    * block A, :func:`insertion_sort_bytecode` over one array input of the
      keys into one array output t; the gaps ``t_(i+1) - t_i`` as solve gates,
      each with ``Range(., 32)``; and a grand-product permutation check at a
      challenge c drawn from ``seed``: ``prod (c - k_i) = prod (c - t_i)`` as
      two chains of solve gates and one assert-zero;
    * block B, :func:`isqrt_bytecode` of s into r, and ``s - r^2`` and
      ``r^2 + 2 r - s`` as solve gates, each with ``Range(., 37)``;
    * block C, :func:`inverse_bytecode` of (k_0, k_1) into inv, and the
      assert-zero ``(k_0 - k_1) inv - 1 = 0``.

    The three blocks read only inputs and the sum, so they are one host stage
    between device segments.  16 keys: 88 opcodes over 84 witnesses; the
    worst case of the sort (keys in descending order) takes 1,656 opcodes
    against the step budget's 2,432.  ``lib`` as in
    :func:`build_brillig_ops_circuit`; :func:`brillig_vm_circuit_roles` names
    its witnesses."""
    return _vm_circuit(n_keys, seed, lib or PORT_CLASSES)[0]


def brillig_vm_circuit_roles(n_keys: int = 16) -> Dict[str, List[int]]:
    """The witnesses of :func:`build_brillig_vm_circuit` by role: ``keys``,
    ``total``, ``sorted`` (t), ``gaps``, ``root`` (r), ``inverse``, and the
    opcode indices of the three blocks (``blocks``)."""
    return _vm_circuit(n_keys, 0, PORT_CLASSES)[1]


def _vm_circuit(n: int, seed: int, lib):
    o, fe, W, b = lib.opcodes, lib.FieldElement, lib.Witness, lib.brillig
    E = lib.Expression.from_witness
    keys = [W(1 + i) for i in range(n)]
    next_witness = n + 1
    opcodes, blocks = [], []

    def fresh():
        nonlocal next_witness
        next_witness += 1
        return W(next_witness - 1)

    def gate(mul=(), lin=(), q=0):
        opcodes.append(o.OpcodeArithmetic(lib.Expression(
            mul_terms=[(fe(c), x, y) for c, x, y in mul],
            linear_combinations=[(fe(c), x) for c, x in lin], q_c=fe(q))))

    def range_check(w, bits):
        opcodes.append(o.OpcodeBlackBoxFuncCall(o.BBRange(o.FunctionInput(w, bits))))

    def block(inputs, outputs, bytecode):
        blocks.append(len(opcodes))
        opcodes.append(o.OpcodeBrillig(o.Brillig(
            inputs=inputs, outputs=outputs, foreign_call_results=[], bytecode=bytecode,
            predicate=None)))

    for k in keys:
        range_check(k, 32)
    total = fresh()
    gate(lin=[(1, k) for k in keys] + [(-1, total)])

    t = [fresh() for _ in range(n)]
    block([o.BrilligInputArray([E(k) for k in keys])], [o.BrilligOutputArray(t)],
          insertion_sort_bytecode(n, b))
    gaps = []
    for lo, hi in zip(t, t[1:]):
        gaps.append(fresh())
        gate(lin=[(1, hi), (-1, lo), (-1, gaps[-1])])
        range_check(gaps[-1], 32)
    c = random.Random(seed).randrange(1, BN254_FR.modulus)

    def product(ws):  # prod (c - w) as a chain of solve gates
        acc = fresh()
        gate(lin=[(-1, ws[0]), (-1, acc)], q=c)
        for w in ws[1:]:
            nxt = fresh()
            gate(mul=[(-1, acc, w)], lin=[(c, acc), (-1, nxt)])
            acc = nxt
        return acc

    gate(lin=[(1, product(keys)), (-1, product(t))])

    root = fresh()
    block([o.BrilligInputSingle(E(total))], [o.BrilligOutputSimple(root)], isqrt_bytecode(b))
    below, above = fresh(), fresh()
    gate(mul=[(1, root, root)], lin=[(-1, total), (1, below)])  # below = s - r^2
    range_check(below, 37)
    gate(mul=[(-1, root, root)], lin=[(-2, root), (1, total), (1, above)])  # above = r^2 + 2r - s
    range_check(above, 37)

    inverse = fresh()
    block([o.BrilligInputSingle(E(keys[0])), o.BrilligInputSingle(E(keys[1]))],
          [o.BrilligOutputSimple(inverse)], inverse_bytecode(b))
    gate(mul=[(1, keys[0], inverse), (-1, keys[1], inverse)], q=-1)
    circuit = lib.Circuit(current_witness_index=next_witness - 1, opcodes=opcodes,
                          private_parameters=set(keys))
    roles = dict(keys=keys, total=[total], sorted=t, gaps=gaps, root=[root], inverse=[inverse])
    roles = {k: [int(w) for w in v] for k, v in roles.items()}
    roles["blocks"] = blocks
    return circuit, roles


def brillig_vm_inputs(circuit, batch: int, seed: int = 23):
    """Columnar keys of :func:`build_brillig_vm_circuit`, a (batch,) uint64
    array a key: random u32 values, every fourth instance (b = 1 mod 4) drawn
    from 0..15 (duplicates), k_0 != k_1 everywhere but in these instances:

    * 0: the keys in descending order (the sort's worst case);
    * 1: every key 2^32 - 1 (so k_0 = k_1: it traps in block C);
    * 2: k_0 = k_1 (it traps in block C, at that block's opcode index);
    * 3: the middle key 2^32 (it fails its ``Range``, opcode n // 2, first).

    Returns ``(columns, fails)``: fails maps each failing instance to the
    first opcode it fails; every other instance is satisfied."""
    import numpy as np

    n = len(circuit.private_parameters)
    block_c = [i for i, op in enumerate(circuit.opcodes)
               if type(op).__name__ == "OpcodeBrillig"][-1]
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, size=(n, batch), dtype=np.uint64)
    dup = np.arange(batch) % 4 == 1
    keys[:, dup] = rng.integers(0, 16, size=(n, int(dup.sum())), dtype=np.uint64)
    same = keys[0] == keys[1]
    keys[1, same] ^= np.uint64(1)
    keys[:, 0] = (n - np.arange(n, dtype=np.uint64)) * np.uint64(1_000_003)
    keys[:, 1] = (1 << 32) - 1
    keys[1, 2] = keys[0, 2]
    keys[n // 2, 3] = 1 << 32
    fails = {1: block_c, 2: block_c, 3: n // 2}
    return {1 + i: keys[i] for i in range(n)}, fails


def _sum_loop_bytecode(b) -> list:
    """r0 = 1 + 2 + ... + r0 by a JumpIfNot loop at 64 bits (per-instance trip
    counts): the JAX package's fixture (tests/test_brillig_vm_device.py)."""
    R, I = b.RegisterIndex, b.BinaryIntOp
    return [b.OpConst(R(1), b.Value.from_int(0)), b.OpConst(R(2), b.Value.from_int(1)),
            b.OpJumpIfNot(R(0), 6),
            b.OpBinaryIntOp(R(1), I.Add, 64, R(1), R(0)),
            b.OpBinaryIntOp(R(0), I.Sub, 64, R(0), R(2)),
            b.OpJump(2), b.OpMov(R(0), R(1)), b.OpStop()]


def _binary_search_bytecode(n: int, b) -> list:
    """r0 = the lower bound of r1 in the sorted array at the pointer in r0
    (Load and branches): the JAX package's fixture."""
    R, I, V = b.RegisterIndex, b.BinaryIntOp, b.Value.from_int
    return [b.OpConst(R(2), V(0)), b.OpConst(R(3), V(n)), b.OpConst(R(4), V(1)),
            b.OpConst(R(5), V(2)),
            b.OpBinaryIntOp(R(6), I.LessThan, 64, R(2), R(3)), b.OpJumpIfNot(R(6), 16),
            b.OpBinaryIntOp(R(7), I.Add, 64, R(2), R(3)),
            b.OpBinaryIntOp(R(7), I.UnsignedDiv, 64, R(7), R(5)),
            b.OpBinaryIntOp(R(8), I.Add, 64, R(0), R(7)), b.OpLoad(R(9), R(8)),
            b.OpBinaryIntOp(R(10), I.LessThan, 64, R(9), R(1)), b.OpJumpIfNot(R(10), 14),
            b.OpBinaryIntOp(R(2), I.Add, 64, R(7), R(4)), b.OpJump(4),
            b.OpMov(R(3), R(7)), b.OpJump(4), b.OpMov(R(0), R(2)), b.OpStop()]


def _call_trap_bytecode(b) -> list:
    """r0 = 3 r0 in a called subroutine that traps where r0 = 7 (Call, Return,
    a conditional Trap): the JAX package's fixture."""
    R, I, V = b.RegisterIndex, b.BinaryIntOp, b.Value.from_int
    return [b.OpCall(3), b.OpMov(R(0), R(1)), b.OpStop(),
            b.OpConst(R(2), V(3)), b.OpBinaryIntOp(R(1), I.Mul, 64, R(0), R(2)),
            b.OpConst(R(3), V(7)), b.OpBinaryIntOp(R(4), I.Equals, 64, R(0), R(3)),
            b.OpJumpIfNot(R(4), 9), b.OpTrap(), b.OpReturn()]


VM_EDGE_ARRAY = 8  # the binary search's array


def build_brillig_vm_edges_circuit(lib=None, array: int = VM_EDGE_ARRAY):
    """The JAX package's three device-VM fixtures as one circuit of four
    blocks (opcodes 0-3), each a host stage: the sum loop of w1 into w2; the
    binary search of the needle w(3 + n) in the sorted array w3..w(2 + n) of
    ``n = array`` words into w(4 + n); Call/Return with a conditional Trap of
    w(5 + n) into w(6 + n) (trapping where it is 7); the sum loop of w(8 + n)
    again under the predicate w(7 + n), into w(9 + n).  At the default 8
    words: w11 into w12, w13 into w14, w16 under w15 into w17."""
    lib = lib or PORT_CLASSES
    o, W, b = lib.opcodes, lib.Witness, lib.brillig
    E = lib.Expression.from_witness
    n = array

    def block(inputs, out, bytecode, predicate=None):
        return o.OpcodeBrillig(o.Brillig(
            inputs=inputs, outputs=[o.BrilligOutputSimple(W(out))], foreign_call_results=[],
            bytecode=bytecode, predicate=predicate))

    arr = [E(W(3 + i)) for i in range(n)]
    opcodes = [
        block([o.BrilligInputSingle(E(W(1)))], 2, _sum_loop_bytecode(b)),
        block([o.BrilligInputArray(arr), o.BrilligInputSingle(E(W(3 + n)))], 4 + n,
              _binary_search_bytecode(n, b)),
        block([o.BrilligInputSingle(E(W(5 + n)))], 6 + n, _call_trap_bytecode(b)),
        block([o.BrilligInputSingle(E(W(8 + n)))], 9 + n, _sum_loop_bytecode(b),
              predicate=E(W(7 + n))),
    ]
    inputs = {W(i) for i in (1, 3 + n, 5 + n, 7 + n, 8 + n)} | {W(3 + i) for i in range(n)}
    return lib.Circuit(current_witness_index=9 + n, opcodes=opcodes, private_parameters=inputs)


def brillig_vm_edge_inputs(batch: int, seed: int = 29, escape_instance=None,
                           array: int = VM_EDGE_ARRAY):
    """Columns of :func:`build_brillig_vm_edges_circuit` at the same
    ``array``: sum-loop counts in 0..199, sorted arrays of values below 100
    with needles in 0..104, call inputs in 0..9 (7 traps), the predicate 0 or
    1 at random.  With ``escape_instance`` set, that instance's first loop
    runs 1,000 times, past the step budget (8 opcodes: 1,536 steps): the block
    escapes and reruns instance by instance.  Returns ``(columns, expected,
    trap)``: the four outputs and the trap mask by Python's reckoning."""
    import bisect

    import numpy as np

    n = array
    rng = np.random.default_rng(seed)
    cols = {1: rng.integers(0, 200, batch, dtype=np.uint64)}
    if escape_instance is not None:
        cols[1][escape_instance] = 1000
    arrays = np.sort(rng.integers(0, 100, (batch, n), dtype=np.uint64), axis=1)
    for i in range(n):
        cols[3 + i] = arrays[:, i].copy()
    cols[3 + n] = rng.integers(0, 105, batch, dtype=np.uint64)
    cols[5 + n] = rng.integers(0, 10, batch, dtype=np.uint64)
    cols[7 + n] = rng.integers(0, 2, batch, dtype=np.uint64)
    cols[8 + n] = rng.integers(0, 200, batch, dtype=np.uint64)
    trap = cols[5 + n] == 7
    expected = {
        2: [int(v) * (int(v) + 1) // 2 for v in cols[1]],
        4 + n: [bisect.bisect_left(list(arrays[k]), int(cols[3 + n][k])) for k in range(batch)],
        6 + n: [0 if t else 3 * int(v) for v, t in zip(cols[5 + n], trap)],
        9 + n: [int(v) * (int(v) + 1) // 2 * int(q) for v, q in zip(cols[8 + n], cols[7 + n])],
    }
    return cols, expected, trap


def build_brillig_vm_wide_registers_circuit(lib=None, registers: int = 300):
    """One block, the sum loop of w1 into w2 with its count, its step and its
    sum in the top three of ``registers`` registers: a register file too
    large for the device VM to keep on chip at the default 300 (300 KB a warp
    of 32 instances)."""
    lib = lib or PORT_CLASSES
    o, W, b = lib.opcodes, lib.Witness, lib.brillig
    R, I, V = b.RegisterIndex, b.BinaryIntOp, b.Value.from_int
    n, one, acc = R(registers - 1), R(registers - 2), R(registers - 3)
    bytecode = [b.OpMov(n, R(0)), b.OpConst(acc, V(0)), b.OpConst(one, V(1)),
                b.OpJumpIfNot(n, 7),
                b.OpBinaryIntOp(acc, I.Add, 64, acc, n), b.OpBinaryIntOp(n, I.Sub, 64, n, one),
                b.OpJump(3), b.OpMov(R(0), acc), b.OpStop()]
    block = o.OpcodeBrillig(o.Brillig(
        inputs=[o.BrilligInputSingle(lib.Expression.from_witness(W(1)))],
        outputs=[o.BrilligOutputSimple(W(2))], foreign_call_results=[], bytecode=bytecode,
        predicate=None))
    return lib.Circuit(current_witness_index=2, opcodes=[block], private_parameters={W(1)})


# ---------------------------------------------------------------------------
# Hash gadgets: a Merkle-membership program
# ---------------------------------------------------------------------------

MEMO_BYTES = 200


def build_membership_circuit(depth: int = 16, lib=None):
    """The ACIR of a Noir program that proves membership in a Merkle tree, in
    the shape of a Semaphore-style proof, in that opcode order:

    * inputs: a 32-byte ``secret``, ``depth`` path ``bits``, ``depth``
      32-byte ``siblings``, an ``ext_nullifier`` (a field element, hashed as
      its 32 little-endian bytes: read at 254 bits), a ``MEMO_BYTES``-byte
      ``memo`` and ``memo_len``; ``Range(., 8)`` on every byte input, as
      Noir's ``[u8; N]`` parameters carry;
    * ``leaf = blake2s(secret)``;
    * for each level: the boolean check ``b b - b = 0``; the selection
      ``left_j = cur_j + b (sib_j - cur_j)`` and
      ``right_j = sib_j + b (cur_j - sib_j)`` (64 solve gates); then
      ``cur = sha256(left || right)``; the last ``cur`` is the ``root``;
    * ``nullifier = hash_to_field_128_security(secret || ext_nullifier)``;
    * ``signal = keccak256(root || memo)`` of its first ``memo_len`` bytes
      (the variable-length form; ``memo_len`` past the 232 bytes fails);
    * ``binding = keccak256(root || signal)``.

    depth = 16: 1,804 opcodes over 2,395 witnesses.  ``lib`` as in
    :func:`build_brillig_ops_circuit`; :func:`membership_circuit_roles`
    names its witnesses."""
    return _membership_circuit(depth, lib or PORT_CLASSES)[0]


def membership_circuit_roles(depth: int = 16) -> Dict[str, List[int]]:
    """The witnesses of :func:`build_membership_circuit` (depth) by role:
    ``secret``, ``bits``, ``siblings`` (level by level), ``ext_nullifier``,
    ``memo``, ``memo_len``, ``leaf``, ``path`` (each level's digest, the
    last the root), ``root``, ``nullifier``, ``signal``, ``binding``; and the
    opcode indices ``bool_check_opcodes`` (one a level) and
    ``keccak_var_opcode``."""
    return _membership_circuit(depth, PORT_CLASSES)[1]


def _membership_circuit(depth: int, lib):
    o, fe, W = lib.opcodes, lib.FieldElement, lib.Witness
    next_witness = 1
    opcodes = []

    def fresh_n(n):
        nonlocal next_witness
        next_witness += n
        return [W(next_witness - n + i) for i in range(n)]

    def gate(mul=(), lin=()):
        opcodes.append(o.OpcodeArithmetic(lib.Expression(
            mul_terms=[(fe(c), x, y) for c, x, y in mul],
            linear_combinations=[(fe(c), x) for c, x in lin], q_c=fe(0))))

    def call(c):
        opcodes.append(o.OpcodeBlackBoxFuncCall(c))
        return len(opcodes) - 1

    def as_bytes(ws):
        return [o.FunctionInput(w, 8) for w in ws]

    secret, bits = fresh_n(32), fresh_n(depth)
    siblings = [fresh_n(32) for _ in range(depth)]
    (ext,), memo, (memo_len,) = fresh_n(1), fresh_n(MEMO_BYTES), fresh_n(1)
    for w in secret + [w for sib in siblings for w in sib] + memo:
        call(o.BBRange(o.FunctionInput(w, 8)))
    leaf = fresh_n(32)
    call(o.BBBlake2s(inputs=as_bytes(secret), outputs=leaf))
    cur, path, checks = leaf, [], []
    for b, sib in zip(bits, siblings):
        gate(mul=[(1, b, b)], lin=[(-1, b)])
        checks.append(len(opcodes) - 1)
        left, right = fresh_n(32), fresh_n(32)
        for c, s, out in zip(cur, sib, left):
            gate(mul=[(1, b, s), (-1, b, c)], lin=[(1, c), (-1, out)])
        for c, s, out in zip(cur, sib, right):
            gate(mul=[(1, b, c), (-1, b, s)], lin=[(1, s), (-1, out)])
        cur = fresh_n(32)
        call(o.BBSha256(inputs=as_bytes(left + right), outputs=cur))
        path += cur
    (nullifier,) = fresh_n(1)
    call(o.BBHashToField128Security(inputs=as_bytes(secret) + [o.FunctionInput(ext, 254)],
                                    output=nullifier))
    signal = fresh_n(32)
    var_op = call(o.BBKeccak256VariableLength(inputs=as_bytes(cur + memo),
                                              var_message_size=o.FunctionInput(memo_len, 32),
                                              outputs=signal))
    binding = fresh_n(32)
    call(o.BBKeccak256(inputs=as_bytes(cur + signal), outputs=binding))
    inputs = secret + bits + [w for sib in siblings for w in sib] + [ext] + memo + [memo_len]
    circuit = lib.Circuit(current_witness_index=next_witness - 1, opcodes=opcodes,
                          private_parameters=set(inputs))
    roles = dict(secret=secret, bits=bits, siblings=[w for sib in siblings for w in sib],
                 ext_nullifier=[ext], memo=memo, memo_len=[memo_len], leaf=leaf, path=path,
                 root=cur, nullifier=[nullifier], signal=signal, binding=binding)
    roles = {k: [int(w) for w in v] for k, v in roles.items()}
    roles.update(bool_check_opcodes=checks, keccak_var_opcode=[var_op])
    return circuit, roles


def membership_inputs(circuit, batch: int, seed: int = 41):
    """Columnar inputs of :func:`build_membership_circuit`: random bytes
    (uint8) for the secret, siblings and memo, random path bits (uint8), a
    random field element for the external nullifier (object ints) and a
    ``memo_len`` in 0..232 (uint64)."""
    import numpy as np

    depth = (len(circuit.private_parameters) - 34 - MEMO_BYTES) // 33
    roles = membership_circuit_roles(depth)
    rng = np.random.default_rng(seed)
    cols = {w: rng.integers(0, 256, size=batch, dtype=np.uint8)
            for w in roles["secret"] + roles["siblings"] + roles["memo"]}
    cols.update({w: rng.integers(0, 2, size=batch, dtype=np.uint8) for w in roles["bits"]})
    pyrng = random.Random(seed)
    cols[roles["ext_nullifier"][0]] = np.array(
        [pyrng.randrange(BN254_FR.modulus) for _ in range(batch)], dtype=object)
    cols[roles["memo_len"][0]] = rng.integers(0, 32 + MEMO_BYTES + 1, size=batch, dtype=np.uint64)
    return cols


def membership_outputs(instance: Dict[int, int], depth: int = 16):
    """What :func:`build_membership_circuit` (depth) computes for one
    instance (witness -> int), from the host hashes and Python ints: a dict of
    ``leaf``, ``path``, ``root``, ``signal``, ``binding`` (bytes) and
    ``nullifier`` (int).  The selection is the circuit's own arithmetic mod
    p, so a path bit other than 0 or 1 gives what the gates give.
    ``signal`` and ``binding`` are None where ``memo_len`` (its low 128 bits,
    as the sequential engine reads it) is past the message."""
    from ..blackbox import hashes

    p = BN254_FR.modulus
    roles = membership_circuit_roles(depth)
    col = lambda role: [instance[w] for w in roles[role]]  # noqa: E731
    secret = bytes(col("secret"))
    cur = hashes.blake2s(secret)
    out = {"leaf": cur, "path": b""}
    sibs = col("siblings")
    for i, b in enumerate(col("bits")):
        sib = sibs[32 * i: 32 * i + 32]
        left = bytes((c + b * (s - c)) % p & 0xFF for c, s in zip(cur, sib))
        right = bytes((s + b * (c - s)) % p & 0xFF for c, s in zip(cur, sib))
        cur = hashes.sha256(left + right)
        out["path"] += cur
    out["root"] = cur
    ext = FieldElement(instance[roles["ext_nullifier"][0]]).to_le_bytes()
    out["nullifier"] = int(hashes.hash_to_field_128_security(secret + ext))
    size = instance[roles["memo_len"][0]] % (1 << 128)
    message = cur + bytes(col("memo"))
    out["signal"] = hashes.keccak256(message[:size]) if size <= len(message) else None
    out["binding"] = hashes.keccak256(cur + out["signal"]) if out["signal"] is not None else None
    return out
