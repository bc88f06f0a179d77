"""Keccak-256 fallback circuit builder (reference: stdlib/src/blackbox_fallbacks/keccak256.rs).

Keccak-f[1600] over the UInt64 gadget: sponge with rate 136, 24 rounds of
theta/rho-pi/chi/iota, original 0x01 padding.
"""

from __future__ import annotations

from typing import List, Tuple

from ..acir.expression import Expression
from ..acir.witness import Witness
from ..acir import opcodes as ops
from ..fields.field import FieldElement
from .sha256 import pad
from .uint import UIntGadget, uint64_from_witnesses
from .utils import byte_decomposition, round_to_nearest_byte

STATE_NUM_BYTES = 200
BITS = 256
WORD_SIZE = 8
BLOCK_SIZE = (1600 - BITS * 2) // WORD_SIZE  # 136

ROUND_CONSTANTS = [
    1, 0x8082, 0x800000000000808A, 0x8000000080008000,
    0x808B, 0x80000001, 0x8000000080008081, 0x8000000000008009,
    0x8A, 0x88, 0x80008009, 0x8000000A,
    0x8000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x80000001, 0x8000000080008008,
]
RHO = [1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44]
PI = [10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1]


class _Cursor:
    def __init__(self, num_witness: int):
        self.num_witness = num_witness
        self.opcodes: List[ops.Opcode] = []

    def run(self, result):
        gadget, extra, self.num_witness = result
        self.opcodes.extend(extra)
        return gadget

    def const8(self, value: int) -> UIntGadget:
        return self.run(UIntGadget.load_constant(value, 8, self.num_witness))

    def const64(self, value: int) -> UIntGadget:
        return self.run(UIntGadget.load_constant(value, 64, self.num_witness))


def keccak256(
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

    result, num_witness, extra = create_keccak_constraint(new_inputs, num_witness)
    new_opcodes.extend(extra)

    for out, res in zip(outputs, result):
        expr = Expression.from_witness(out)
        expr.linear_combinations.append((-FieldElement.one(), res))
        new_opcodes.append(ops.OpcodeArithmetic(expr))
    return num_witness, new_opcodes


def create_keccak_constraint(input_witnesses: List[Witness], num_witness: int):
    cur = _Cursor(num_witness)
    num_blocks = len(input_witnesses) // BLOCK_SIZE + 1

    padded = _pad_keccak(cur, list(input_witnesses), num_blocks)

    state = [cur.const8(0) for _ in range(STATE_NUM_BYTES)]

    for i in range(num_blocks):
        for j in range(BLOCK_SIZE):
            state[j] = cur.run(
                state[j].xor(
                    UIntGadget(padded[i * BLOCK_SIZE + j], 8), cur.num_witness
                )
            )
        state = _keccakf(cur, state)

    result = [x.inner for x in state[:32]]
    return result, cur.num_witness, cur.opcodes


def _keccakf(cur: _Cursor, state: List[UIntGadget]) -> List[UIntGadget]:
    # Repack 200 u8 lanes into 25 u64 words (little-endian per word).
    state_witnesses: List[Witness] = []
    for i in range(len(state) // 8):
        for j in range(8):
            state_witnesses.append(state[i * 8 + (7 - j)].inner)
    state_u64, extra, cur.num_witness = uint64_from_witnesses(
        state_witnesses, cur.num_witness
    )
    cur.opcodes.extend(extra)

    for round_constant in ROUND_CONSTANTS:
        state_u64 = _keccak_round(cur, state_u64, round_constant)

    state_u8: List[UIntGadget] = []
    for word in state_u64:
        extra, u8s, cur.num_witness = byte_decomposition(
            Expression.from_witness(word.inner), 8, cur.num_witness
        )
        cur.opcodes.extend(extra)
        u8s.reverse()
        state_u8.extend(UIntGadget(w, 8) for w in u8s)
    return state_u8


def _keccak_round(cur: _Cursor, a: List[UIntGadget], round_const: int):
    # theta
    array = [cur.const64(0) for _ in range(5)]
    for x in range(5):
        for y_count in range(5):
            y = y_count * 5
            array[x] = cur.run(array[x].xor(a[x + y], cur.num_witness))
    for x in range(5):
        for y_count in range(5):
            y = y_count * 5
            a_ele = cur.run(array[(x + 1) % 5].rol(1, cur.num_witness))
            b_ele = cur.run(array[(x + 4) % 5].xor(a_ele, cur.num_witness))
            a[x + y] = cur.run(a[x + y].xor(b_ele, cur.num_witness))

    # rho and pi
    last = a[1]
    for x in range(24):
        array[0] = a[PI[x]]
        a[PI[x]] = cur.run(last.rol(RHO[x], cur.num_witness))
        last = array[0]

    # chi
    for y_step in range(5):
        y = y_step * 5
        array[:5] = a[y : y + 5]
        for x in range(5):
            a_ele = cur.run(array[(x + 1) % 5].not_(cur.num_witness))
            b_ele = cur.run(a_ele.and_(array[(x + 2) % 5], cur.num_witness))
            a[y + x] = cur.run(array[x].xor(b_ele, cur.num_witness))

    # iota
    rc = cur.const64(round_const)
    a[0] = cur.run(a[0].xor(rc, cur.num_witness))
    return a


def _pad_keccak(cur: _Cursor, input_list: List[Witness], num_blocks: int):
    total_len = BLOCK_SIZE * num_blocks

    cur.num_witness, pad_witness, extra = pad(0x01, 8, cur.num_witness)
    cur.opcodes.extend(extra)
    input_list.append(pad_witness)
    for _ in range(total_len - len(input_list)):
        cur.num_witness, pad_witness, extra = pad(0x00, 8, cur.num_witness)
        cur.opcodes.extend(extra)
        input_list.append(pad_witness)

    zero_x_80 = cur.const8(0x80)
    final_pad = cur.run(
        UIntGadget(input_list[total_len - 1], 8).xor(zero_x_80, cur.num_witness)
    )
    input_list[total_len - 1] = final_pad.inner
    return input_list
