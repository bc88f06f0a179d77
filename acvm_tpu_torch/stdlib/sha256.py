"""SHA-256 fallback circuit builder (reference: stdlib/src/blackbox_fallbacks/sha256.rs).

Builds the full SHA-256 compression in ACIR gates over the UInt32 gadget:
byte-decompose the inputs, pad per the SHA-256 rules, run the message schedule
and 64 rounds per block, and constrain the outputs to the digest bytes.
"""

from __future__ import annotations

from typing import List, Tuple

from .. import brillig as br
from ..acir.expression import Expression
from ..acir.witness import Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from .helpers import VariableStore
from .uint import UIntGadget, uint32_from_witnesses, _brillig, _const_input
from .utils import byte_decomposition, round_to_nearest_byte

INIT_CONSTANTS = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

ROUND_CONSTANTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]


def pad(number: int, bit_size: int, num_witness: int):
    """Load a constant padding byte/word with a range constraint (sha256.rs:146-170)."""
    new_opcodes: List[ops.Opcode] = []
    variables = VariableStore(num_witness)
    pad_witness = variables.new_variable()
    new_opcodes.append(
        _brillig(
            [_const_input(number)],
            [ops.BrilligOutputSimple(pad_witness)],
            [br.OpStop()],
        )
    )
    new_opcodes.append(
        ops.OpcodeBlackBoxFuncCall(
            ops.BBRange(ops.FunctionInput(pad_witness, bit_size))
        )
    )
    return variables.finalize(), pad_witness, new_opcodes


def sha256(
    inputs: List[Tuple[Expression, int]],
    outputs: List[Witness],
    num_witness: int,
) -> Tuple[int, List[ops.Opcode]]:
    new_opcodes: List[ops.Opcode] = []
    new_inputs: List[Witness] = []
    total_num_bytes = 0

    for expr, num_bits in inputs:
        num_bytes = round_to_nearest_byte(num_bits)
        total_num_bytes += num_bytes
        extra, extra_inputs, num_witness = byte_decomposition(
            expr, num_bytes, num_witness
        )
        new_opcodes.extend(extra)
        new_inputs.extend(extra_inputs)

    result, num_witness, extra = create_sha256_constraint(
        new_inputs, total_num_bytes, num_witness
    )
    new_opcodes.extend(extra)

    for out, res in zip(outputs, result):
        expr = Expression.from_witness(out)
        expr.linear_combinations.append((-FieldElement.one(), res))
        new_opcodes.append(ops.OpcodeArithmetic(expr))
    return num_witness, new_opcodes


def create_sha256_constraint(
    input_witnesses: List[Witness], total_num_bytes: int, num_witness: int
):
    new_opcodes: List[ops.Opcode] = []
    input_list = list(input_witnesses)

    message_bits = total_num_bytes * 8
    num_witness, pad_witness, extra = pad(128, 8, num_witness)
    new_opcodes.extend(extra)
    input_list.append(pad_witness)

    bytes_per_block = 64
    num_bytes = len(input_list) + 8
    num_blocks = num_bytes // bytes_per_block + (num_bytes % bytes_per_block != 0)
    num_total_bytes = num_blocks * bytes_per_block
    for _ in range(num_bytes, num_total_bytes):
        num_witness, pad_witness, extra = pad(0, 8, num_witness)
        new_opcodes.extend(extra)
        input_list.append(pad_witness)
    num_witness, pad_witness, extra = pad(message_bits, 64, num_witness)
    new_opcodes.extend(extra)
    extra, length_bytes, num_witness = byte_decomposition(
        Expression.from_witness(pad_witness), 8, num_witness
    )
    new_opcodes.extend(extra)
    input_list.extend(length_bytes)

    words, extra, num_witness = uint32_from_witnesses(input_list, num_witness)
    new_opcodes.extend(extra)
    rolling_hash, extra, num_witness = _load_constants(INIT_CONSTANTS, num_witness)
    new_opcodes.extend(extra)
    round_constants, extra, num_witness = _load_constants(
        ROUND_CONSTANTS, num_witness
    )
    new_opcodes.extend(extra)

    blocks = [words[i : i + 16] for i in range(0, len(words), 16)]
    for block in blocks:
        rolling_hash, extra, num_witness = sha256_block(
            block, rolling_hash, round_constants, num_witness
        )
        new_opcodes.extend(extra)

    result: List[Witness] = []
    for state_word in rolling_hash:
        extra, word_bytes, num_witness = byte_decomposition(
            Expression.from_witness(state_word.inner), 4, num_witness
        )
        new_opcodes.extend(extra)
        result.extend(word_bytes)

    return result, num_witness, new_opcodes


def _load_constants(constants, num_witness):
    new_opcodes: List[ops.Opcode] = []
    gadgets = []
    for value in constants:
        gadget, extra, num_witness = UIntGadget.load_constant(value, 32, num_witness)
        new_opcodes.extend(extra)
        gadgets.append(gadget)
    return gadgets, new_opcodes, num_witness


def sha256_block(block, rolling_hash, round_constants, num_witness):
    o: List[ops.Opcode] = []
    w = list(block)

    def run(res):
        nonlocal num_witness
        gadget, extra, num_witness = res
        o.extend(extra)
        return gadget

    def run4(res):
        nonlocal num_witness
        g1, g2, extra, num_witness = res
        o.extend(extra)
        return g1, g2

    for i in range(16, 64):
        a1 = run(w[i - 15].ror(7, num_witness))
        a2 = run(w[i - 15].ror(18, num_witness))
        a3 = run(w[i - 15].rightshift(3, num_witness))
        a4 = run(a1.xor(a2, num_witness))
        s0 = run(a4.xor(a3, num_witness))

        b1 = run(w[i - 2].ror(17, num_witness))
        b2 = run(w[i - 2].ror(19, num_witness))
        b3 = run(w[i - 2].rightshift(10, num_witness))
        b4 = run(b1.xor(b2, num_witness))
        s1 = run(b4.xor(b3, num_witness))

        c1 = run(w[i - 16].add(w[i - 7], num_witness))
        c2 = run(c1.add(s0, num_witness))
        c3 = run(c2.add(s1, num_witness))
        w.append(c3)

    a, b, c, d, e, f, g, h = rolling_hash

    for i in range(64):
        # S1 = e.ror(6) ^ e.ror(11) ^ e.ror(25)
        a1 = run(e.ror(6, num_witness))
        a2 = run(e.ror(11, num_witness))
        a3 = run(e.ror(25, num_witness))
        a4 = run(a1.xor(a2, num_witness))
        S1 = run(a4.xor(a3, num_witness))

        # ch = (e & f) + (~e & g)
        b1 = run(e.and_(f, num_witness))
        b2 = run(e.not_(num_witness))
        b3 = run(b2.and_(g, num_witness))
        ch = run(b1.add(b3, num_witness))

        # temp1 = h + S1 + ch + k[i] + w[i]
        c1 = run(h.add(S1, num_witness))
        c2 = run(c1.add(ch, num_witness))
        c3 = run(c2.add(round_constants[i], num_witness))
        temp1 = run(c3.add(w[i], num_witness))

        # S0 = a.ror(2) ^ a.ror(13) ^ a.ror(22)
        d1 = run(a.ror(2, num_witness))
        d2 = run(a.ror(13, num_witness))
        d3 = run(a.ror(22, num_witness))
        d4 = run(d1.xor(d2, num_witness))
        S0 = run(d4.xor(d3, num_witness))

        # T0 = b & c; maj = (a & (b + c - 2*T0)) + T0
        T0 = run(b.and_(c, num_witness))
        e1 = run(T0.add(T0, num_witness))
        e2 = run(c.sub(e1, num_witness))
        e3 = run(b.add(e2, num_witness))
        e4 = run(a.and_(e3, num_witness))
        maj = run(e4.add(T0, num_witness))

        temp2 = run(S0.add(maj, num_witness))

        h = g
        g = f
        f = e
        new_e = run(d.add(temp1, num_witness))
        d = c
        c = b
        b = a
        new_a = run(temp1.add(temp2, num_witness))
        a = new_a
        e = new_e

    outputs = []
    for state, prev in zip((a, b, c, d, e, f, g, h), rolling_hash):
        outputs.append(run(state.add(prev, num_witness)))

    return outputs, o, num_witness
