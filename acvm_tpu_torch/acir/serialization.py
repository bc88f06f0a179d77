"""Binary wire format: bincode 1.3 (fixed-int, little-endian) + gzip.

The reference serializes ``Circuit`` and ``WitnessMap`` with ``bincode::serialize``
followed by a flate2 gzip stream (``acir/src/circuit/mod.rs:146-161``,
``acir/src/native_types/witness_map.rs:108-146``).  Bincode's default serde codec:

  * fixed-width little-endian integers (usize as u64)
  * ``u64`` length prefixes on sequences/strings/maps
  * enum variants encoded as a ``u32`` index in declaration order
  * ``Option`` as a 1-byte tag
  * structs/tuples as the concatenation of their fields

``FieldElement`` has a custom serde impl that writes its 64-char lowercase hex
string (``acir_field/src/generic_ark.rs:114-134``), which we reproduce.

Byte-exactness is guaranteed at the *bincode layer* (gunzip(reference bytes) ==
our bincode bytes); the gzip container itself is only guaranteed to round-trip,
since compressed output is compressor-specific.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import List

from ..fields.field import FieldElement
from .. import brillig as br
from . import opcodes as ops
from .circuit import Circuit, OpcodeLocation, PublicInputs
from .expression import Expression
from .witness import Witness, WitnessMap


# ==========================================================================
# Low-level bincode reader/writer
# ==========================================================================


class Writer:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: List[bytes] = []

    def bytes_(self, b: bytes):
        self.parts.append(b)

    def u8(self, v: int):
        self.parts.append(struct.pack("<B", v))

    def bool_(self, v: bool):
        self.u8(1 if v else 0)

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def usize(self, v: int):
        self.u64(v)

    def variant(self, v: int):
        self.u32(v)

    def length(self, v: int):
        self.u64(v)

    def string(self, s: str):
        data = s.encode("utf-8")
        self.length(len(data))
        self.bytes_(data)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("bincode: unexpected end of input")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def bool_(self) -> bool:
        v = self.u8()
        if v > 1:
            raise ValueError("bincode: invalid bool")
        return bool(v)

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    usize = u64
    variant = u32
    length = u64

    def string(self) -> str:
        n = self.length()
        return self.take(n).decode("utf-8")

    def done(self) -> bool:
        return self.pos == len(self.data)


# ==========================================================================
# FieldElement / Witness primitives
# ==========================================================================


def write_field(w: Writer, f: FieldElement):
    w.string(f.to_hex())


def read_field(r: Reader) -> FieldElement:
    f = FieldElement.from_hex(r.string())
    if f is None:
        raise ValueError("bincode: invalid FieldElement hex")
    return f


def write_witness(w: Writer, wit: Witness):
    w.u32(int(wit))


def read_witness(r: Reader) -> Witness:
    return Witness(r.u32())


# ==========================================================================
# Expression
# ==========================================================================


def write_expression(w: Writer, e: Expression):
    w.length(len(e.mul_terms))
    for coeff, wl, wr in e.mul_terms:
        write_field(w, coeff)
        write_witness(w, wl)
        write_witness(w, wr)
    w.length(len(e.linear_combinations))
    for coeff, wit in e.linear_combinations:
        write_field(w, coeff)
        write_witness(w, wit)
    write_field(w, e.q_c)


def read_expression(r: Reader) -> Expression:
    mul_terms = [
        (read_field(r), read_witness(r), read_witness(r)) for _ in range(r.length())
    ]
    linear = [(read_field(r), read_witness(r)) for _ in range(r.length())]
    return Expression(mul_terms, linear, read_field(r))


def write_opt_expression(w: Writer, e):
    if e is None:
        w.bool_(False)
    else:
        w.bool_(True)
        write_expression(w, e)


def read_opt_expression(r: Reader):
    return read_expression(r) if r.bool_() else None


# ==========================================================================
# Brillig ISA
# ==========================================================================


def _write_register(w: Writer, reg: br.RegisterIndex):
    w.usize(int(reg))


def _read_register(r: Reader) -> br.RegisterIndex:
    return br.RegisterIndex(r.usize())


def _write_heap_array(w: Writer, arr: br.HeapArray):
    _write_register(w, arr.pointer)
    w.usize(arr.size)


def _read_heap_array(r: Reader) -> br.HeapArray:
    return br.HeapArray(_read_register(r), r.usize())


def _write_heap_vector(w: Writer, vec: br.HeapVector):
    _write_register(w, vec.pointer)
    _write_register(w, vec.size)


def _read_heap_vector(r: Reader) -> br.HeapVector:
    return br.HeapVector(_read_register(r), _read_register(r))


def _write_rom(w: Writer, rom):
    w.variant(rom.VARIANT)
    if isinstance(rom, br.RomRegister):
        _write_register(w, rom.index)
    elif isinstance(rom, br.RomHeapArray):
        _write_heap_array(w, rom.array)
    elif isinstance(rom, br.RomHeapVector):
        _write_heap_vector(w, rom.vector)
    else:
        raise TypeError(rom)


def _read_rom(r: Reader):
    v = r.variant()
    if v == 0:
        return br.RomRegister(_read_register(r))
    if v == 1:
        return br.RomHeapArray(_read_heap_array(r))
    if v == 2:
        return br.RomHeapVector(_read_heap_vector(r))
    raise ValueError(f"bincode: bad RegisterOrMemory variant {v}")


def _write_value(w: Writer, v: br.Value):
    write_field(w, v.inner)


def _read_value(r: Reader) -> br.Value:
    return br.Value(read_field(r))


def _write_blackbox_op(w: Writer, op: br.BlackBoxOp):
    w.variant(op.VARIANT)
    if isinstance(op, (br.BBSha256, br.BBBlake2s, br.BBKeccak256)):
        _write_heap_vector(w, op.message)
        _write_heap_array(w, op.output)
    elif isinstance(op, br.BBHashToField128Security):
        _write_heap_vector(w, op.message)
        _write_register(w, op.output)
    elif isinstance(op, (br.BBEcdsaSecp256k1, br.BBEcdsaSecp256r1)):
        _write_heap_vector(w, op.hashed_msg)
        _write_heap_array(w, op.public_key_x)
        _write_heap_array(w, op.public_key_y)
        _write_heap_array(w, op.signature)
        _write_register(w, op.result)
    elif isinstance(op, br.BBSchnorrVerify):
        _write_register(w, op.public_key_x)
        _write_register(w, op.public_key_y)
        _write_heap_vector(w, op.message)
        _write_heap_vector(w, op.signature)
        _write_register(w, op.result)
    elif isinstance(op, br.BBPedersen):
        _write_heap_vector(w, op.inputs)
        _write_register(w, op.domain_separator)
        _write_heap_array(w, op.output)
    elif isinstance(op, br.BBFixedBaseScalarMul):
        _write_register(w, op.low)
        _write_register(w, op.high)
        _write_heap_array(w, op.result)
    else:
        raise TypeError(op)


def _read_blackbox_op(r: Reader) -> br.BlackBoxOp:
    v = r.variant()
    if v in (0, 1, 2):
        message, output = _read_heap_vector(r), _read_heap_array(r)
        cls = [br.BBSha256, br.BBBlake2s, br.BBKeccak256][v]
        return cls(message, output)
    if v == 3:
        return br.BBHashToField128Security(_read_heap_vector(r), _read_register(r))
    if v in (4, 5):
        args = (
            _read_heap_vector(r),
            _read_heap_array(r),
            _read_heap_array(r),
            _read_heap_array(r),
            _read_register(r),
        )
        return (br.BBEcdsaSecp256k1 if v == 4 else br.BBEcdsaSecp256r1)(*args)
    if v == 6:
        return br.BBSchnorrVerify(
            _read_register(r),
            _read_register(r),
            _read_heap_vector(r),
            _read_heap_vector(r),
            _read_register(r),
        )
    if v == 7:
        return br.BBPedersen(
            _read_heap_vector(r), _read_register(r), _read_heap_array(r)
        )
    if v == 8:
        return br.BBFixedBaseScalarMul(
            _read_register(r), _read_register(r), _read_heap_array(r)
        )
    raise ValueError(f"bincode: bad BlackBoxOp variant {v}")


def write_brillig_opcode(w: Writer, op: br.BrilligOpcode):
    w.variant(op.VARIANT)
    if isinstance(op, br.OpBinaryFieldOp):
        _write_register(w, op.destination)
        w.variant(int(op.op))
        _write_register(w, op.lhs)
        _write_register(w, op.rhs)
    elif isinstance(op, br.OpBinaryIntOp):
        _write_register(w, op.destination)
        w.variant(int(op.op))
        w.u32(op.bit_size)
        _write_register(w, op.lhs)
        _write_register(w, op.rhs)
    elif isinstance(op, (br.OpJumpIfNot, br.OpJumpIf)):
        _write_register(w, op.condition)
        w.usize(op.location)
    elif isinstance(op, (br.OpJump, br.OpCall)):
        w.usize(op.location)
    elif isinstance(op, br.OpConst):
        _write_register(w, op.destination)
        _write_value(w, op.value)
    elif isinstance(op, br.OpReturn):
        pass
    elif isinstance(op, br.OpForeignCall):
        w.string(op.function)
        w.length(len(op.destinations))
        for d in op.destinations:
            _write_rom(w, d)
        w.length(len(op.inputs))
        for i in op.inputs:
            _write_rom(w, i)
    elif isinstance(op, br.OpMov):
        _write_register(w, op.destination)
        _write_register(w, op.source)
    elif isinstance(op, br.OpLoad):
        _write_register(w, op.destination)
        _write_register(w, op.source_pointer)
    elif isinstance(op, br.OpStore):
        _write_register(w, op.destination_pointer)
        _write_register(w, op.source)
    elif isinstance(op, br.OpBlackBox):
        _write_blackbox_op(w, op.op)
    elif isinstance(op, (br.OpTrap, br.OpStop)):
        pass
    else:
        raise TypeError(op)


def read_brillig_opcode(r: Reader) -> br.BrilligOpcode:
    v = r.variant()
    if v == 0:
        dest = _read_register(r)
        o = br.BinaryFieldOp(r.variant())
        return br.OpBinaryFieldOp(dest, o, _read_register(r), _read_register(r))
    if v == 1:
        dest = _read_register(r)
        o = br.BinaryIntOp(r.variant())
        bit_size = r.u32()
        return br.OpBinaryIntOp(dest, o, bit_size, _read_register(r), _read_register(r))
    if v == 2:
        return br.OpJumpIfNot(_read_register(r), r.usize())
    if v == 3:
        return br.OpJumpIf(_read_register(r), r.usize())
    if v == 4:
        return br.OpJump(r.usize())
    if v == 5:
        return br.OpCall(r.usize())
    if v == 6:
        return br.OpConst(_read_register(r), _read_value(r))
    if v == 7:
        return br.OpReturn()
    if v == 8:
        function = r.string()
        destinations = tuple(_read_rom(r) for _ in range(r.length()))
        inputs = tuple(_read_rom(r) for _ in range(r.length()))
        return br.OpForeignCall(function, destinations, inputs)
    if v == 9:
        return br.OpMov(_read_register(r), _read_register(r))
    if v == 10:
        return br.OpLoad(_read_register(r), _read_register(r))
    if v == 11:
        return br.OpStore(_read_register(r), _read_register(r))
    if v == 12:
        return br.OpBlackBox(_read_blackbox_op(r))
    if v == 13:
        return br.OpTrap()
    if v == 14:
        return br.OpStop()
    raise ValueError(f"bincode: bad Brillig opcode variant {v}")


def _write_fc_output(w: Writer, out: br.ForeignCallOutput):
    w.variant(out.VARIANT)
    if isinstance(out, br.FcSingle):
        _write_value(w, out.value)
    elif isinstance(out, br.FcArray):
        w.length(len(out.values))
        for v in out.values:
            _write_value(w, v)
    else:
        raise TypeError(out)


def _read_fc_output(r: Reader) -> br.ForeignCallOutput:
    v = r.variant()
    if v == 0:
        return br.FcSingle(_read_value(r))
    if v == 1:
        return br.FcArray(tuple(_read_value(r) for _ in range(r.length())))
    raise ValueError(f"bincode: bad ForeignCallOutput variant {v}")


def _write_fc_result(w: Writer, res: br.ForeignCallResult):
    w.length(len(res.values))
    for v in res.values:
        _write_fc_output(w, v)


def _read_fc_result(r: Reader) -> br.ForeignCallResult:
    return br.ForeignCallResult(tuple(_read_fc_output(r) for _ in range(r.length())))


# ==========================================================================
# BlackBoxFuncCall
# ==========================================================================


def _write_function_input(w: Writer, fi: ops.FunctionInput):
    write_witness(w, fi.witness)
    w.u32(fi.num_bits)


def _read_function_input(r: Reader) -> ops.FunctionInput:
    return ops.FunctionInput(read_witness(r), r.u32())


def _write_fi_vec(w: Writer, inputs):
    w.length(len(inputs))
    for fi in inputs:
        _write_function_input(w, fi)


def _read_fi_vec(r: Reader):
    return [_read_function_input(r) for _ in range(r.length())]


def _write_witness_vec(w: Writer, wits):
    w.length(len(wits))
    for wit in wits:
        write_witness(w, wit)


def _read_witness_vec(r: Reader):
    return [read_witness(r) for _ in range(r.length())]


def write_blackbox_call(w: Writer, c: ops.BlackBoxFuncCall):
    w.variant(c.VARIANT)
    if isinstance(c, (ops.BBAnd, ops.BBXor)):
        _write_function_input(w, c.lhs)
        _write_function_input(w, c.rhs)
        write_witness(w, c.output)
    elif isinstance(c, ops.BBRange):
        _write_function_input(w, c.input)
    elif isinstance(c, (ops.BBSha256, ops.BBBlake2s, ops.BBKeccak256)):
        _write_fi_vec(w, c.inputs)
        _write_witness_vec(w, c.outputs)
    elif isinstance(c, ops.BBSchnorrVerify):
        _write_function_input(w, c.public_key_x)
        _write_function_input(w, c.public_key_y)
        _write_fi_vec(w, c.signature)
        _write_fi_vec(w, c.message)
        write_witness(w, c.output)
    elif isinstance(c, ops.BBPedersen):
        _write_fi_vec(w, c.inputs)
        w.u32(c.domain_separator)
        write_witness(w, c.outputs[0])
        write_witness(w, c.outputs[1])
    elif isinstance(c, ops.BBHashToField128Security):
        _write_fi_vec(w, c.inputs)
        write_witness(w, c.output)
    elif isinstance(c, (ops.BBEcdsaSecp256k1, ops.BBEcdsaSecp256r1)):
        _write_fi_vec(w, c.public_key_x)
        _write_fi_vec(w, c.public_key_y)
        _write_fi_vec(w, c.signature)
        _write_fi_vec(w, c.hashed_message)
        write_witness(w, c.output)
    elif isinstance(c, ops.BBFixedBaseScalarMul):
        _write_function_input(w, c.low)
        _write_function_input(w, c.high)
        write_witness(w, c.outputs[0])
        write_witness(w, c.outputs[1])
    elif isinstance(c, ops.BBKeccak256VariableLength):
        _write_fi_vec(w, c.inputs)
        _write_function_input(w, c.var_message_size)
        _write_witness_vec(w, c.outputs)
    elif isinstance(c, ops.BBRecursiveAggregation):
        _write_fi_vec(w, c.verification_key)
        _write_fi_vec(w, c.proof)
        _write_fi_vec(w, c.public_inputs)
        _write_function_input(w, c.key_hash)
        if c.input_aggregation_object is None:
            w.bool_(False)
        else:
            w.bool_(True)
            _write_fi_vec(w, c.input_aggregation_object)
        _write_witness_vec(w, c.output_aggregation_object)
    else:
        raise TypeError(c)


def read_blackbox_call(r: Reader) -> ops.BlackBoxFuncCall:
    v = r.variant()
    if v in (0, 1):
        cls = ops.BBAnd if v == 0 else ops.BBXor
        return cls(_read_function_input(r), _read_function_input(r), read_witness(r))
    if v == 2:
        return ops.BBRange(_read_function_input(r))
    if v in (3, 4, 11):
        cls = {3: ops.BBSha256, 4: ops.BBBlake2s, 11: ops.BBKeccak256}[v]
        return cls(_read_fi_vec(r), _read_witness_vec(r))
    if v == 5:
        return ops.BBSchnorrVerify(
            _read_function_input(r),
            _read_function_input(r),
            _read_fi_vec(r),
            _read_fi_vec(r),
            read_witness(r),
        )
    if v == 6:
        inputs = _read_fi_vec(r)
        sep = r.u32()
        return ops.BBPedersen(inputs, sep, (read_witness(r), read_witness(r)))
    if v == 7:
        return ops.BBHashToField128Security(_read_fi_vec(r), read_witness(r))
    if v in (8, 9):
        cls = ops.BBEcdsaSecp256k1 if v == 8 else ops.BBEcdsaSecp256r1
        return cls(
            _read_fi_vec(r),
            _read_fi_vec(r),
            _read_fi_vec(r),
            _read_fi_vec(r),
            read_witness(r),
        )
    if v == 10:
        return ops.BBFixedBaseScalarMul(
            _read_function_input(r),
            _read_function_input(r),
            (read_witness(r), read_witness(r)),
        )
    if v == 12:
        return ops.BBKeccak256VariableLength(
            _read_fi_vec(r), _read_function_input(r), _read_witness_vec(r)
        )
    if v == 13:
        vk = _read_fi_vec(r)
        proof = _read_fi_vec(r)
        pub = _read_fi_vec(r)
        key_hash = _read_function_input(r)
        iao = _read_fi_vec(r) if r.bool_() else None
        oao = _read_witness_vec(r)
        return ops.BBRecursiveAggregation(vk, proof, pub, key_hash, iao, oao)
    raise ValueError(f"bincode: bad BlackBoxFuncCall variant {v}")


# ==========================================================================
# Directives, Brillig blocks, memory ops
# ==========================================================================


def write_directive(w: Writer, d: ops.Directive):
    w.variant(d.VARIANT)
    if isinstance(d, ops.DirQuotient):
        q = d.quotient
        write_expression(w, q.a)
        write_expression(w, q.b)
        write_witness(w, q.q)
        write_witness(w, q.r)
        write_opt_expression(w, q.predicate)
    elif isinstance(d, ops.DirToLeRadix):
        write_expression(w, d.a)
        _write_witness_vec(w, d.b)
        w.u32(d.radix)
    elif isinstance(d, ops.DirPermutationSort):
        w.length(len(d.inputs))
        for tup in d.inputs:
            w.length(len(tup))
            for e in tup:
                write_expression(w, e)
        w.u32(d.tuple_size)
        _write_witness_vec(w, d.bits)
        w.length(len(d.sort_by))
        for i in d.sort_by:
            w.u32(i)
    else:
        raise TypeError(d)


def read_directive(r: Reader) -> ops.Directive:
    v = r.variant()
    if v == 0:
        return ops.DirQuotient(
            ops.QuotientDirective(
                read_expression(r),
                read_expression(r),
                read_witness(r),
                read_witness(r),
                read_opt_expression(r),
            )
        )
    if v == 1:
        return ops.DirToLeRadix(read_expression(r), _read_witness_vec(r), r.u32())
    if v == 2:
        inputs = [
            [read_expression(r) for _ in range(r.length())] for _ in range(r.length())
        ]
        tuple_size = r.u32()
        bits = _read_witness_vec(r)
        sort_by = [r.u32() for _ in range(r.length())]
        return ops.DirPermutationSort(inputs, tuple_size, bits, sort_by)
    raise ValueError(f"bincode: bad Directive variant {v}")


def write_brillig(w: Writer, b: ops.Brillig):
    w.length(len(b.inputs))
    for inp in b.inputs:
        w.variant(inp.VARIANT)
        if isinstance(inp, ops.BrilligInputSingle):
            write_expression(w, inp.expr)
        else:
            w.length(len(inp.exprs))
            for e in inp.exprs:
                write_expression(w, e)
    w.length(len(b.outputs))
    for out in b.outputs:
        w.variant(out.VARIANT)
        if isinstance(out, ops.BrilligOutputSimple):
            write_witness(w, out.witness)
        else:
            _write_witness_vec(w, out.witnesses)
    w.length(len(b.foreign_call_results))
    for res in b.foreign_call_results:
        _write_fc_result(w, res)
    w.length(len(b.bytecode))
    for op in b.bytecode:
        write_brillig_opcode(w, op)
    write_opt_expression(w, b.predicate)


def read_brillig(r: Reader) -> ops.Brillig:
    inputs = []
    for _ in range(r.length()):
        v = r.variant()
        if v == 0:
            inputs.append(ops.BrilligInputSingle(read_expression(r)))
        elif v == 1:
            inputs.append(
                ops.BrilligInputArray(
                    [read_expression(r) for _ in range(r.length())]
                )
            )
        else:
            raise ValueError(f"bincode: bad BrilligInputs variant {v}")
    outputs = []
    for _ in range(r.length()):
        v = r.variant()
        if v == 0:
            outputs.append(ops.BrilligOutputSimple(read_witness(r)))
        elif v == 1:
            outputs.append(ops.BrilligOutputArray(_read_witness_vec(r)))
        else:
            raise ValueError(f"bincode: bad BrilligOutputs variant {v}")
    results = [_read_fc_result(r) for _ in range(r.length())]
    bytecode = [read_brillig_opcode(r) for _ in range(r.length())]
    predicate = read_opt_expression(r)
    return ops.Brillig(inputs, outputs, results, bytecode, predicate)


def _write_memop(w: Writer, m: ops.MemOp):
    write_expression(w, m.operation)
    write_expression(w, m.index)
    write_expression(w, m.value)


def _read_memop(r: Reader) -> ops.MemOp:
    return ops.MemOp(read_expression(r), read_expression(r), read_expression(r))


# ==========================================================================
# Opcode / Circuit / WitnessMap
# ==========================================================================


def write_opcode(w: Writer, op: ops.Opcode):
    w.variant(op.VARIANT)
    if isinstance(op, ops.OpcodeArithmetic):
        write_expression(w, op.expr)
    elif isinstance(op, ops.OpcodeBlackBoxFuncCall):
        write_blackbox_call(w, op.call)
    elif isinstance(op, ops.OpcodeDirective):
        write_directive(w, op.directive)
    elif isinstance(op, ops.OpcodeBrillig):
        write_brillig(w, op.brillig)
    elif isinstance(op, ops.OpcodeMemoryOp):
        w.u32(op.block_id.id)
        _write_memop(w, op.op)
        write_opt_expression(w, op.predicate)
    elif isinstance(op, ops.OpcodeMemoryInit):
        w.u32(op.block_id.id)
        _write_witness_vec(w, op.init)
    else:
        raise TypeError(op)


def read_opcode(r: Reader) -> ops.Opcode:
    v = r.variant()
    if v == 0:
        return ops.OpcodeArithmetic(read_expression(r))
    if v == 1:
        return ops.OpcodeBlackBoxFuncCall(read_blackbox_call(r))
    if v == 2:
        return ops.OpcodeDirective(read_directive(r))
    if v == 3:
        return ops.OpcodeBrillig(read_brillig(r))
    if v == 4:
        return ops.OpcodeMemoryOp(
            ops.BlockId(r.u32()), _read_memop(r), read_opt_expression(r)
        )
    if v == 5:
        return ops.OpcodeMemoryInit(ops.BlockId(r.u32()), _read_witness_vec(r))
    raise ValueError(f"bincode: bad Opcode variant {v}")


def _write_opcode_location(w: Writer, loc: OpcodeLocation):
    if loc.brillig_index is None:
        w.variant(0)
        w.usize(loc.acir_index)
    else:
        w.variant(1)
        w.usize(loc.acir_index)
        w.usize(loc.brillig_index)


def _read_opcode_location(r: Reader) -> OpcodeLocation:
    v = r.variant()
    if v == 0:
        return OpcodeLocation.acir(r.usize())
    if v == 1:
        return OpcodeLocation.brillig(r.usize(), r.usize())
    raise ValueError(f"bincode: bad OpcodeLocation variant {v}")


def circuit_to_bincode(c: Circuit) -> bytes:
    w = Writer()
    w.u32(c.current_witness_index)
    w.length(len(c.opcodes))
    for op in c.opcodes:
        write_opcode(w, op)
    # BTreeSet<Witness>: sorted
    for witness_set in (
        sorted(c.private_parameters),
        sorted(c.public_parameters.witnesses),
        sorted(c.return_values.witnesses),
    ):
        w.length(len(witness_set))
        for wit in witness_set:
            write_witness(w, wit)
    w.length(len(c.assert_messages))
    for loc, msg in c.assert_messages:
        _write_opcode_location(w, loc)
        w.string(msg)
    return w.getvalue()


def circuit_from_bincode(data: bytes) -> Circuit:
    r = Reader(data)
    current_witness_index = r.u32()
    opcodes = [read_opcode(r) for _ in range(r.length())]
    private_parameters = {read_witness(r) for _ in range(r.length())}
    public_parameters = PublicInputs({read_witness(r) for _ in range(r.length())})
    return_values = PublicInputs({read_witness(r) for _ in range(r.length())})
    assert_messages = [
        (_read_opcode_location(r), r.string()) for _ in range(r.length())
    ]
    if not r.done():
        raise ValueError("bincode: trailing bytes after Circuit")
    return Circuit(
        current_witness_index,
        opcodes,
        private_parameters,
        public_parameters,
        return_values,
        assert_messages,
    )


def witness_map_to_bincode(wm: WitnessMap) -> bytes:
    w = Writer()
    w.length(len(wm))
    for wit, value in wm:  # WitnessMap iterates sorted (BTreeMap order)
        write_witness(w, wit)
        write_field(w, value)
    return w.getvalue()


def witness_map_from_bincode(data: bytes) -> WitnessMap:
    r = Reader(data)
    wm = WitnessMap()
    for _ in range(r.length()):
        wit = read_witness(r)
        wm.insert(wit, read_field(r))
    if not r.done():
        raise ValueError("bincode: trailing bytes after WitnessMap")
    return wm


# ==========================================================================
# gzip container
# ==========================================================================


def _gzip_compress(data: bytes) -> bytes:
    # mtime=0 matches the reference output header (deterministic archives).
    return gzip.compress(data, compresslevel=6, mtime=0)


def _gzip_decompress(data: bytes) -> bytes:
    return gzip.decompress(data)


def serialize_circuit(c: Circuit) -> bytes:
    return _gzip_compress(circuit_to_bincode(c))


def deserialize_circuit(data: bytes) -> Circuit:
    return circuit_from_bincode(_gzip_decompress(data))


def compress_witness(wm: WitnessMap) -> bytes:
    return _gzip_compress(witness_map_to_bincode(wm))


def decompress_witness(data: bytes) -> WitnessMap:
    return witness_map_from_bincode(_gzip_decompress(data))


# ==========================================================================
# Alternative wire format: msgpack primitives + raw deflate
# (reference feature `serialize-messagepack`, acir/src/circuit/mod.rs:128-143:
# rmp_serde + flate2 DeflateEncoder).  The reference ships no golden bytes and
# no tests for this feature, and rmp_serde is not available offline, so
# byte-compatibility is unverifiable; what we guarantee is the feature's
# contract — a second, variable-width compact encoding of the same schema,
# deflate-compressed, fully round-tripping.  Encoding: the identical schema
# walk as the bincode layer, with every primitive emitted as a well-formed
# msgpack value (minimal-width uints, str8/16/32 strings) instead of
# bincode's fixed-width little-endian fields.
# ==========================================================================


class MsgpackWriter(Writer):
    """Writer emitting msgpack-encoded primitives (schema-driven stream)."""

    def _uint(self, v: int):
        if v < 0x80:
            self.parts.append(struct.pack("B", v))
        elif v <= 0xFF:
            self.parts.append(struct.pack(">BB", 0xCC, v))
        elif v <= 0xFFFF:
            self.parts.append(struct.pack(">BH", 0xCD, v))
        elif v <= 0xFFFFFFFF:
            self.parts.append(struct.pack(">BI", 0xCE, v))
        else:
            self.parts.append(struct.pack(">BQ", 0xCF, v))

    def u8(self, v: int):
        self._uint(v)

    def bool_(self, v: bool):
        self.parts.append(b"\xc3" if v else b"\xc2")

    def u32(self, v: int):
        self._uint(v)

    def u64(self, v: int):
        self._uint(v)

    def usize(self, v: int):
        self._uint(v)

    def variant(self, v: int):
        self._uint(v)

    def length(self, v: int):
        self._uint(v)

    def string(self, s: str):
        data = s.encode("utf-8")
        n = len(data)
        if n < 32:
            self.parts.append(struct.pack("B", 0xA0 | n))
        elif n <= 0xFF:
            self.parts.append(struct.pack(">BB", 0xD9, n))
        elif n <= 0xFFFF:
            self.parts.append(struct.pack(">BH", 0xDA, n))
        else:
            self.parts.append(struct.pack(">BI", 0xDB, n))
        self.parts.append(data)


class MsgpackReader(Reader):
    def _uint(self) -> int:
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag == 0xCC:
            return self.take(1)[0]
        if tag == 0xCD:
            return struct.unpack(">H", self.take(2))[0]
        if tag == 0xCE:
            return struct.unpack(">I", self.take(4))[0]
        if tag == 0xCF:
            return struct.unpack(">Q", self.take(8))[0]
        raise ValueError(f"msgpack: expected uint, got tag 0x{tag:02x}")

    def u8(self) -> int:
        return self._uint()

    def bool_(self) -> bool:
        tag = self.take(1)[0]
        if tag == 0xC3:
            return True
        if tag == 0xC2:
            return False
        raise ValueError(f"msgpack: expected bool, got tag 0x{tag:02x}")

    def u32(self) -> int:
        return self._uint()

    def u64(self) -> int:
        return self._uint()

    def usize(self) -> int:
        return self._uint()

    def variant(self) -> int:
        return self._uint()

    def length(self) -> int:
        return self._uint()

    def string(self) -> str:
        tag = self.take(1)[0]
        if 0xA0 <= tag <= 0xBF:
            n = tag & 0x1F
        elif tag == 0xD9:
            n = self.take(1)[0]
        elif tag == 0xDA:
            n = struct.unpack(">H", self.take(2))[0]
        elif tag == 0xDB:
            n = struct.unpack(">I", self.take(4))[0]
        else:
            raise ValueError(f"msgpack: expected str, got tag 0x{tag:02x}")
        return self.take(n).decode("utf-8")


def _circuit_write_body(w: Writer, c: Circuit):
    w.u32(c.current_witness_index)
    w.length(len(c.opcodes))
    for op in c.opcodes:
        write_opcode(w, op)
    for witness_set in (
        sorted(c.private_parameters),
        sorted(c.public_parameters.witnesses),
        sorted(c.return_values.witnesses),
    ):
        w.length(len(witness_set))
        for wit in witness_set:
            write_witness(w, wit)
    w.length(len(c.assert_messages))
    for loc, msg in c.assert_messages:
        _write_opcode_location(w, loc)
        w.string(msg)


def _circuit_read_body(r: Reader) -> Circuit:
    current_witness_index = r.u32()
    opcodes = [read_opcode(r) for _ in range(r.length())]
    private_parameters = {read_witness(r) for _ in range(r.length())}
    public_parameters = PublicInputs({read_witness(r) for _ in range(r.length())})
    return_values = PublicInputs({read_witness(r) for _ in range(r.length())})
    assert_messages = [
        (_read_opcode_location(r), r.string()) for _ in range(r.length())
    ]
    if not r.done():
        raise ValueError("trailing bytes after Circuit")
    return Circuit(
        current_witness_index,
        opcodes,
        private_parameters,
        public_parameters,
        return_values,
        assert_messages,
    )


def serialize_circuit_msgpack(c: Circuit) -> bytes:
    """`serialize-messagepack` feature analogue: msgpack body + raw deflate."""
    w = MsgpackWriter()
    _circuit_write_body(w, c)
    compressor = zlib.compressobj(9, zlib.DEFLATED, -15)  # raw deflate
    return compressor.compress(w.getvalue()) + compressor.flush()


def deserialize_circuit_msgpack(data: bytes) -> Circuit:
    body = zlib.decompress(data, -15)
    return _circuit_read_body(MsgpackReader(body))
