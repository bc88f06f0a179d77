"""BLAKE2s fallback circuit builder (reference: stdlib/src/blackbox_fallbacks/blake2s.rs).

Full BLAKE2s-256 over the UInt32 gadget: state struct (h/t/f), G mixing
function, 10 rounds per block with the BLAKE2 message schedule.
"""

from __future__ import annotations

from typing import List, Tuple

from ..acir.expression import Expression
from ..acir.witness import Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from .uint import UIntGadget, uint32_from_witnesses
from .utils import byte_decomposition, round_to_nearest_byte

BLAKE2S_BLOCKBYTES = 64

MSG_SCHEDULE_BLAKE2 = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

INITIAL_H = [
    0x6B08E647, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
IV_VALUE = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


class _Cursor:
    """Threads the witness counter and opcode list through gadget calls."""

    def __init__(self, num_witness: int):
        self.num_witness = num_witness
        self.opcodes: List[ops.Opcode] = []

    def run(self, result):
        gadget, extra, self.num_witness = result
        self.opcodes.extend(extra)
        return gadget

    def const(self, value: int) -> UIntGadget:
        return self.run(UIntGadget.load_constant(value, 32, self.num_witness))


def blake2s(
    inputs: List[Tuple[Expression, int]],
    outputs: List[Witness],
    num_witness: int,
) -> Tuple[int, List[ops.Opcode]]:
    new_opcodes: List[ops.Opcode] = []
    new_inputs: List[Witness] = []

    for expr, num_bits in inputs:
        num_bytes = round_to_nearest_byte(num_bits)
        extra, extra_inputs, num_witness = byte_decomposition(
            expr, num_bytes, num_witness
        )
        new_opcodes.extend(extra)
        new_inputs.extend(extra_inputs)

    result, num_witness, extra = create_blake2s_constraint(new_inputs, num_witness)
    new_opcodes.extend(extra)

    for out, res in zip(outputs, result):
        expr = Expression.from_witness(out)
        expr.linear_combinations.append((-FieldElement.one(), res))
        new_opcodes.append(ops.OpcodeArithmetic(expr))
    return num_witness, new_opcodes


def create_blake2s_constraint(input_witnesses: List[Witness], num_witness: int):
    cur = _Cursor(num_witness)

    h = [cur.const(v) for v in INITIAL_H]
    t = [cur.const(0), cur.const(0)]
    f = [cur.const(0), cur.const(0)]
    blockbytes = cur.const(64)
    iv = [cur.const(v) for v in IV_VALUE]

    offset = 0
    size = len(input_witnesses)

    while size > BLAKE2S_BLOCKBYTES:
        _increment_counter(cur, t, blockbytes)
        _compress(
            cur, h, t, f, iv,
            input_witnesses[offset : offset + BLAKE2S_BLOCKBYTES],
        )
        offset += BLAKE2S_BLOCKBYTES
        size -= BLAKE2S_BLOCKBYTES

    u32_max = cur.const(0xFFFFFFFF)
    f[0] = u32_max

    final_block = list(input_witnesses[offset:])
    for _ in range(BLAKE2S_BLOCKBYTES - len(final_block)):
        final_block.append(cur.const(0).inner)

    size_w = cur.const(size)
    _increment_counter(cur, t, size_w)
    _compress(cur, h, t, f, iv, final_block)

    result: List[Witness] = []
    for state_word in h:
        extra, word_bytes, cur.num_witness = byte_decomposition(
            Expression.from_witness(state_word.inner), 4, cur.num_witness
        )
        cur.opcodes.extend(extra)
        word_bytes.reverse()  # blake2s output is little-endian per word
        result.extend(word_bytes)

    return result, cur.num_witness, cur.opcodes


def _increment_counter(cur: _Cursor, t: List[UIntGadget], inc: UIntGadget):
    t[0] = cur.run(t[0].add(inc, cur.num_witness))
    to_inc = cur.run(t[0].less_than_comparison(inc, cur.num_witness))
    t[1] = cur.run(t[1].add(to_inc, cur.num_witness))


def _compress(cur: _Cursor, h, t, f, iv, block: List[Witness]):
    m = []
    for i in range(16):
        mi_bytes = list(block[i * 4 : i * 4 + 4])
        mi_bytes.reverse()
        gadgets, extra, cur.num_witness = uint32_from_witnesses(
            mi_bytes, cur.num_witness
        )
        cur.opcodes.extend(extra)
        m.append(gadgets[0])

    v = list(h[:8])
    v.extend(iv[0:4])
    v.append(cur.run(t[0].xor(iv[4], cur.num_witness)))
    v.append(cur.run(t[1].xor(iv[5], cur.num_witness)))
    v.append(cur.run(f[0].xor(iv[6], cur.num_witness)))
    v.append(cur.run(f[1].xor(iv[7], cur.num_witness)))

    for round_index in range(10):
        _round(cur, v, m, round_index)

    for i in range(8):
        a = cur.run(h[i].xor(v[i], cur.num_witness))
        h[i] = cur.run(a.xor(v[i + 8], cur.num_witness))


def _round(cur: _Cursor, v, m, round_index: int):
    schedule = MSG_SCHEDULE_BLAKE2[round_index]
    _g(cur, v, 0, 4, 8, 12, m[schedule[0]], m[schedule[1]])
    _g(cur, v, 1, 5, 9, 13, m[schedule[2]], m[schedule[3]])
    _g(cur, v, 2, 6, 10, 14, m[schedule[4]], m[schedule[5]])
    _g(cur, v, 3, 7, 11, 15, m[schedule[6]], m[schedule[7]])
    _g(cur, v, 0, 5, 10, 15, m[schedule[8]], m[schedule[9]])
    _g(cur, v, 1, 6, 11, 12, m[schedule[10]], m[schedule[11]])
    _g(cur, v, 2, 7, 8, 13, m[schedule[12]], m[schedule[13]])
    _g(cur, v, 3, 4, 9, 14, m[schedule[14]], m[schedule[15]])


def _g(cur: _Cursor, state, a, b, c, d, x, y):
    state[a] = cur.run(
        cur.run(state[a].add(state[b], cur.num_witness)).add(x, cur.num_witness)
    )
    state[d] = cur.run(
        cur.run(state[d].xor(state[a], cur.num_witness)).ror(16, cur.num_witness)
    )
    state[c] = cur.run(state[c].add(state[d], cur.num_witness))
    state[b] = cur.run(
        cur.run(state[b].xor(state[c], cur.num_witness)).ror(12, cur.num_witness)
    )
    state[a] = cur.run(
        cur.run(state[a].add(state[b], cur.num_witness)).add(y, cur.num_witness)
    )
    state[d] = cur.run(
        cur.run(state[d].xor(state[a], cur.num_witness)).ror(8, cur.num_witness)
    )
    state[c] = cur.run(state[c].add(state[d], cur.num_witness))
    state[b] = cur.run(
        cur.run(state[b].xor(state[c], cur.num_witness)).ror(7, cur.num_witness)
    )
