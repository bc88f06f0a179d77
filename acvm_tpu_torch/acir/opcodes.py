"""ACIR opcodes: arithmetic gates, black-box gadget calls, directives, Brillig
blocks, and memory ops.

Mirrors ``acir/src/circuit/opcodes.rs``, ``opcodes/black_box_function_call.rs``,
``opcodes/memory_operation.rs``, ``directives.rs`` and ``brillig.rs``.  Variant
numbering (``VARIANT``) follows Rust declaration order for the wire format.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from enum import IntEnum
from typing import List, Optional, Tuple, Union

from ..fields.field import FieldElement
from ..brillig import BrilligOpcode, ForeignCallResult
from .expression import Expression
from .witness import Witness


class BlackBoxFunc(IntEnum):
    """Gadget-kind enum (acir/src/circuit/black_box_functions.rs:14-52)."""

    AND = 0
    XOR = 1
    RANGE = 2
    SHA256 = 3
    Blake2s = 4
    SchnorrVerify = 5
    Pedersen = 6
    HashToField128Security = 7
    EcdsaSecp256k1 = 8
    EcdsaSecp256r1 = 9
    FixedBaseScalarMul = 10
    Keccak256 = 11
    RecursiveAggregation = 12

    def func_name(self) -> str:
        return _BB_NAMES[self]

    @classmethod
    def lookup(cls, name: str) -> Optional["BlackBoxFunc"]:
        return _BB_BY_NAME.get(name)


_BB_NAMES = {
    BlackBoxFunc.SHA256: "sha256",
    BlackBoxFunc.SchnorrVerify: "schnorr_verify",
    BlackBoxFunc.Blake2s: "blake2s",
    BlackBoxFunc.Pedersen: "pedersen",
    BlackBoxFunc.HashToField128Security: "hash_to_field_128_security",
    BlackBoxFunc.EcdsaSecp256k1: "ecdsa_secp256k1",
    BlackBoxFunc.FixedBaseScalarMul: "fixed_base_scalar_mul",
    BlackBoxFunc.AND: "and",
    BlackBoxFunc.XOR: "xor",
    BlackBoxFunc.RANGE: "range",
    BlackBoxFunc.Keccak256: "keccak256",
    BlackBoxFunc.RecursiveAggregation: "recursive_aggregation",
    BlackBoxFunc.EcdsaSecp256r1: "ecdsa_secp256r1",
}
_BB_BY_NAME = {v: k for k, v in _BB_NAMES.items()}


@dataclass(frozen=True)
class FunctionInput:
    """A witness together with how many of its bits the gadget consumes."""

    witness: Witness
    num_bits: int


@dataclass(frozen=True)
class BlockId:
    id: int = 0


@dataclass
class MemOp:
    """Memory op triple {operation (0=read/1=write), index, value} of Expressions."""

    operation: Expression
    index: Expression
    value: Expression

    @classmethod
    def read_at_mem_index(cls, index: Expression, witness: Witness) -> "MemOp":
        return cls(Expression.zero(), index, Expression.from_witness(witness))

    @classmethod
    def write_to_mem_index(cls, index: Expression, value: Expression) -> "MemOp":
        return cls(Expression.one(), index, value)


# --------------------------------------------------------------------------
# BlackBoxFuncCall variants (black_box_function_call.rs:20-115)
# --------------------------------------------------------------------------


@dataclass
class BlackBoxFuncCall:
    VARIANT = -1

    def get_black_box_func(self) -> BlackBoxFunc:
        raise NotImplementedError

    def name(self) -> str:
        return self.get_black_box_func().func_name()

    def get_inputs_vec(self) -> List[FunctionInput]:
        raise NotImplementedError

    def get_outputs_vec(self) -> List[Witness]:
        raise NotImplementedError


@dataclass
class BBAnd(BlackBoxFuncCall):
    lhs: FunctionInput
    rhs: FunctionInput
    output: Witness
    VARIANT = 0

    def get_black_box_func(self):
        return BlackBoxFunc.AND

    def get_inputs_vec(self):
        return [self.lhs, self.rhs]

    def get_outputs_vec(self):
        return [self.output]


@dataclass
class BBXor(BlackBoxFuncCall):
    lhs: FunctionInput
    rhs: FunctionInput
    output: Witness
    VARIANT = 1

    def get_black_box_func(self):
        return BlackBoxFunc.XOR

    def get_inputs_vec(self):
        return [self.lhs, self.rhs]

    def get_outputs_vec(self):
        return [self.output]


@dataclass
class BBRange(BlackBoxFuncCall):
    input: FunctionInput
    VARIANT = 2

    def get_black_box_func(self):
        return BlackBoxFunc.RANGE

    def get_inputs_vec(self):
        return [self.input]

    def get_outputs_vec(self):
        return []


@dataclass
class BBSha256(BlackBoxFuncCall):
    inputs: List[FunctionInput]
    outputs: List[Witness]
    VARIANT = 3

    def get_black_box_func(self):
        return BlackBoxFunc.SHA256

    def get_inputs_vec(self):
        return list(self.inputs)

    def get_outputs_vec(self):
        return list(self.outputs)


@dataclass
class BBBlake2s(BlackBoxFuncCall):
    inputs: List[FunctionInput]
    outputs: List[Witness]
    VARIANT = 4

    def get_black_box_func(self):
        return BlackBoxFunc.Blake2s

    def get_inputs_vec(self):
        return list(self.inputs)

    def get_outputs_vec(self):
        return list(self.outputs)


@dataclass
class BBSchnorrVerify(BlackBoxFuncCall):
    public_key_x: FunctionInput
    public_key_y: FunctionInput
    signature: List[FunctionInput]
    message: List[FunctionInput]
    output: Witness
    VARIANT = 5

    def get_black_box_func(self):
        return BlackBoxFunc.SchnorrVerify

    def get_inputs_vec(self):
        return [self.public_key_x, self.public_key_y, *self.signature, *self.message]

    def get_outputs_vec(self):
        return [self.output]


@dataclass
class BBPedersen(BlackBoxFuncCall):
    inputs: List[FunctionInput]
    domain_separator: int
    outputs: Tuple[Witness, Witness]
    VARIANT = 6

    def get_black_box_func(self):
        return BlackBoxFunc.Pedersen

    def get_inputs_vec(self):
        return list(self.inputs)

    def get_outputs_vec(self):
        return [self.outputs[0], self.outputs[1]]


@dataclass
class BBHashToField128Security(BlackBoxFuncCall):
    inputs: List[FunctionInput]
    output: Witness
    VARIANT = 7

    def get_black_box_func(self):
        return BlackBoxFunc.HashToField128Security

    def get_inputs_vec(self):
        return list(self.inputs)

    def get_outputs_vec(self):
        return [self.output]


@dataclass
class BBEcdsaSecp256k1(BlackBoxFuncCall):
    public_key_x: List[FunctionInput]
    public_key_y: List[FunctionInput]
    signature: List[FunctionInput]
    hashed_message: List[FunctionInput]
    output: Witness
    VARIANT = 8

    def get_black_box_func(self):
        return BlackBoxFunc.EcdsaSecp256k1

    def get_inputs_vec(self):
        return [
            *self.public_key_x,
            *self.public_key_y,
            *self.signature,
            *self.hashed_message,
        ]

    def get_outputs_vec(self):
        return [self.output]


@dataclass
class BBEcdsaSecp256r1(BlackBoxFuncCall):
    public_key_x: List[FunctionInput]
    public_key_y: List[FunctionInput]
    signature: List[FunctionInput]
    hashed_message: List[FunctionInput]
    output: Witness
    VARIANT = 9

    def get_black_box_func(self):
        return BlackBoxFunc.EcdsaSecp256r1

    def get_inputs_vec(self):
        return [
            *self.public_key_x,
            *self.public_key_y,
            *self.signature,
            *self.hashed_message,
        ]

    def get_outputs_vec(self):
        return [self.output]


@dataclass
class BBFixedBaseScalarMul(BlackBoxFuncCall):
    low: FunctionInput
    high: FunctionInput
    outputs: Tuple[Witness, Witness]
    VARIANT = 10

    def get_black_box_func(self):
        return BlackBoxFunc.FixedBaseScalarMul

    def get_inputs_vec(self):
        return [self.low, self.high]

    def get_outputs_vec(self):
        return [self.outputs[0], self.outputs[1]]


@dataclass
class BBKeccak256(BlackBoxFuncCall):
    inputs: List[FunctionInput]
    outputs: List[Witness]
    VARIANT = 11

    def get_black_box_func(self):
        return BlackBoxFunc.Keccak256

    def get_inputs_vec(self):
        return list(self.inputs)

    def get_outputs_vec(self):
        return list(self.outputs)


@dataclass
class BBKeccak256VariableLength(BlackBoxFuncCall):
    inputs: List[FunctionInput]
    var_message_size: FunctionInput
    outputs: List[Witness]
    VARIANT = 12

    def get_black_box_func(self):
        return BlackBoxFunc.Keccak256

    def get_inputs_vec(self):
        return [*self.inputs, self.var_message_size]

    def get_outputs_vec(self):
        return list(self.outputs)


@dataclass
class BBRecursiveAggregation(BlackBoxFuncCall):
    verification_key: List[FunctionInput]
    proof: List[FunctionInput]
    public_inputs: List[FunctionInput]
    key_hash: FunctionInput
    input_aggregation_object: Optional[List[FunctionInput]]
    output_aggregation_object: List[Witness]
    VARIANT = 13

    def get_black_box_func(self):
        return BlackBoxFunc.RecursiveAggregation

    def get_inputs_vec(self):
        return [
            *self.verification_key,
            *self.proof,
            *self.public_inputs,
            self.key_hash,
        ]

    def get_outputs_vec(self):
        return list(self.output_aggregation_object)


# --------------------------------------------------------------------------
# Directives (acir/src/circuit/directives.rs)
# --------------------------------------------------------------------------


@dataclass
class QuotientDirective:
    a: Expression
    b: Expression
    q: Witness
    r: Witness
    predicate: Optional[Expression]


@dataclass
class Directive:
    VARIANT = -1

    def name(self) -> str:
        raise NotImplementedError


@dataclass
class DirQuotient(Directive):
    quotient: QuotientDirective
    VARIANT = 0

    def name(self):
        return "quotient"


@dataclass
class DirToLeRadix(Directive):
    a: Expression
    b: List[Witness]
    radix: int
    VARIANT = 1

    def name(self):
        return "to_le_radix"


@dataclass
class DirPermutationSort(Directive):
    inputs: List[List[Expression]]
    tuple_size: int
    bits: List[Witness]
    sort_by: List[int]
    VARIANT = 2

    def name(self):
        return "permutation_sort"


# --------------------------------------------------------------------------
# ACIR-embedded Brillig block (acir/src/circuit/brillig.rs)
# --------------------------------------------------------------------------


@dataclass
class BrilligInput:
    VARIANT = -1


@dataclass
class BrilligInputSingle(BrilligInput):
    expr: Expression
    VARIANT = 0


@dataclass
class BrilligInputArray(BrilligInput):
    exprs: List[Expression]
    VARIANT = 1


@dataclass
class BrilligOutput:
    VARIANT = -1


@dataclass
class BrilligOutputSimple(BrilligOutput):
    witness: Witness
    VARIANT = 0


@dataclass
class BrilligOutputArray(BrilligOutput):
    witnesses: List[Witness]
    VARIANT = 1


@dataclass
class Brillig:
    inputs: List[BrilligInput]
    outputs: List[BrilligOutput]
    foreign_call_results: List[ForeignCallResult]
    bytecode: List[BrilligOpcode]
    predicate: Optional[Expression]


# --------------------------------------------------------------------------
# Top-level opcode enum (acir/src/circuit/opcodes.rs:14-34)
# --------------------------------------------------------------------------


@dataclass
class Opcode:
    VARIANT = -1

    def name(self) -> str:
        raise NotImplementedError


@dataclass
class OpcodeArithmetic(Opcode):
    expr: Expression
    VARIANT = 0

    def name(self):
        return "arithmetic"


@dataclass
class OpcodeBlackBoxFuncCall(Opcode):
    call: BlackBoxFuncCall
    VARIANT = 1

    def name(self):
        return self.call.name()


@dataclass
class OpcodeDirective(Opcode):
    directive: Directive
    VARIANT = 2

    def name(self):
        return self.directive.name()


@dataclass
class OpcodeBrillig(Opcode):
    brillig: Brillig
    VARIANT = 3

    def name(self):
        return "brillig"


@dataclass
class OpcodeMemoryOp(Opcode):
    block_id: BlockId
    op: MemOp
    predicate: Optional[Expression]
    VARIANT = 4

    def name(self):
        return "mem"


@dataclass
class OpcodeMemoryInit(Opcode):
    block_id: BlockId
    init: List[Witness]
    VARIANT = 5

    def name(self):
        return "init memory block"
