"""The Brillig ISA: opcode/value/foreign-call data model (no execution).

Mirrors the reference crate ``brillig`` (``brillig/src/{opcodes,value,black_box,
foreign_call}.rs``): 15 opcodes over a register machine with grow-on-write
memory, field-valued cells, and black-box gadget calls.  Enum variant numbering
follows Rust declaration order — the binary (bincode) serialization depends on it.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from enum import IntEnum
from typing import List, Union

from ..fields.field import FieldElement


class RegisterIndex(int):
    """Index into VM register space (usize newtype)."""

    __slots__ = ()

    def __repr__(self) -> str:
        return f"r{int(self)}"


@dataclass(frozen=True)
class HeapArray:
    """Fixed-size array at a register-held memory pointer."""

    pointer: RegisterIndex
    size: int


@dataclass(frozen=True)
class HeapVector:
    """Array at a register-held pointer with register-held size."""

    pointer: RegisterIndex
    size: RegisterIndex


@dataclass(frozen=True)
class RegisterValueOrMemory:
    """Base marker; see the three concrete forms below (RegisterOrMemory enum)."""


@dataclass(frozen=True)
class RomRegister(RegisterValueOrMemory):
    index: RegisterIndex
    VARIANT = 0


@dataclass(frozen=True)
class RomHeapArray(RegisterValueOrMemory):
    array: HeapArray
    VARIANT = 1


@dataclass(frozen=True)
class RomHeapVector(RegisterValueOrMemory):
    vector: HeapVector
    VARIANT = 2


RegisterOrMemory = Union[RomRegister, RomHeapArray, RomHeapVector]


class BinaryFieldOp(IntEnum):
    Add = 0
    Sub = 1
    Mul = 2
    Div = 3
    Equals = 4


class BinaryIntOp(IntEnum):
    Add = 0
    Sub = 1
    Mul = 2
    SignedDiv = 3
    UnsignedDiv = 4
    Equals = 5
    LessThan = 6
    LessThanEquals = 7
    And = 8
    Or = 9
    Xor = 10
    Shl = 11
    Shr = 12


@dataclass(frozen=True)
class Value:
    """A VM cell: a field element (brillig/src/value.rs)."""

    inner: FieldElement

    def is_zero(self) -> bool:
        return self.inner.is_zero()

    def to_field(self) -> FieldElement:
        return self.inner

    def to_u128(self) -> int:
        return self.inner.to_u128()

    def to_usize(self) -> int:
        u64 = self.inner.try_to_u64()
        if u64 is None:
            raise ValueError("register does not fit into u64")
        return u64

    @classmethod
    def from_int(cls, v: int) -> "Value":
        return cls(FieldElement(v))

    @classmethod
    def from_bool(cls, v: bool) -> "Value":
        return cls(FieldElement(1 if v else 0))


# --------------------------------------------------------------------------
# Black-box gadget calls native to the VM (brillig/src/black_box.rs)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BlackBoxOp:
    VARIANT = -1


@dataclass(frozen=True)
class BBSha256(BlackBoxOp):
    message: HeapVector
    output: HeapArray
    VARIANT = 0


@dataclass(frozen=True)
class BBBlake2s(BlackBoxOp):
    message: HeapVector
    output: HeapArray
    VARIANT = 1


@dataclass(frozen=True)
class BBKeccak256(BlackBoxOp):
    message: HeapVector
    output: HeapArray
    VARIANT = 2


@dataclass(frozen=True)
class BBHashToField128Security(BlackBoxOp):
    message: HeapVector
    output: RegisterIndex
    VARIANT = 3


@dataclass(frozen=True)
class BBEcdsaSecp256k1(BlackBoxOp):
    hashed_msg: HeapVector
    public_key_x: HeapArray
    public_key_y: HeapArray
    signature: HeapArray
    result: RegisterIndex
    VARIANT = 4


@dataclass(frozen=True)
class BBEcdsaSecp256r1(BlackBoxOp):
    hashed_msg: HeapVector
    public_key_x: HeapArray
    public_key_y: HeapArray
    signature: HeapArray
    result: RegisterIndex
    VARIANT = 5


@dataclass(frozen=True)
class BBSchnorrVerify(BlackBoxOp):
    public_key_x: RegisterIndex
    public_key_y: RegisterIndex
    message: HeapVector
    signature: HeapVector
    result: RegisterIndex
    VARIANT = 6


@dataclass(frozen=True)
class BBPedersen(BlackBoxOp):
    inputs: HeapVector
    domain_separator: RegisterIndex
    output: HeapArray
    VARIANT = 7


@dataclass(frozen=True)
class BBFixedBaseScalarMul(BlackBoxOp):
    low: RegisterIndex
    high: RegisterIndex
    result: HeapArray
    VARIANT = 8


# --------------------------------------------------------------------------
# Opcodes (brillig/src/opcodes.rs:59-137); VARIANT = declaration order.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BrilligOpcode:
    VARIANT = -1

    def name(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class OpBinaryFieldOp(BrilligOpcode):
    destination: RegisterIndex
    op: BinaryFieldOp
    lhs: RegisterIndex
    rhs: RegisterIndex
    VARIANT = 0


@dataclass(frozen=True)
class OpBinaryIntOp(BrilligOpcode):
    destination: RegisterIndex
    op: BinaryIntOp
    bit_size: int
    lhs: RegisterIndex
    rhs: RegisterIndex
    VARIANT = 1


@dataclass(frozen=True)
class OpJumpIfNot(BrilligOpcode):
    condition: RegisterIndex
    location: int
    VARIANT = 2


@dataclass(frozen=True)
class OpJumpIf(BrilligOpcode):
    condition: RegisterIndex
    location: int
    VARIANT = 3


@dataclass(frozen=True)
class OpJump(BrilligOpcode):
    location: int
    VARIANT = 4


@dataclass(frozen=True)
class OpCall(BrilligOpcode):
    location: int
    VARIANT = 5


@dataclass(frozen=True)
class OpConst(BrilligOpcode):
    destination: RegisterIndex
    value: Value
    VARIANT = 6


@dataclass(frozen=True)
class OpReturn(BrilligOpcode):
    VARIANT = 7


@dataclass(frozen=True)
class OpForeignCall(BrilligOpcode):
    function: str
    destinations: tuple  # tuple[RegisterOrMemory, ...]
    inputs: tuple  # tuple[RegisterOrMemory, ...]
    VARIANT = 8


@dataclass(frozen=True)
class OpMov(BrilligOpcode):
    destination: RegisterIndex
    source: RegisterIndex
    VARIANT = 9


@dataclass(frozen=True)
class OpLoad(BrilligOpcode):
    destination: RegisterIndex
    source_pointer: RegisterIndex
    VARIANT = 10


@dataclass(frozen=True)
class OpStore(BrilligOpcode):
    destination_pointer: RegisterIndex
    source: RegisterIndex
    VARIANT = 11


@dataclass(frozen=True)
class OpBlackBox(BrilligOpcode):
    op: BlackBoxOp
    VARIANT = 12


@dataclass(frozen=True)
class OpTrap(BrilligOpcode):
    VARIANT = 13


@dataclass(frozen=True)
class OpStop(BrilligOpcode):
    VARIANT = 14


# --------------------------------------------------------------------------
# Foreign call results (brillig/src/foreign_call.rs)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ForeignCallOutput:
    VARIANT = -1


@dataclass(frozen=True)
class FcSingle(ForeignCallOutput):
    value: Value
    VARIANT = 0


@dataclass(frozen=True)
class FcArray(ForeignCallOutput):
    values: tuple  # tuple[Value, ...]
    VARIANT = 1


@dataclass(frozen=True)
class ForeignCallResult:
    values: tuple  # tuple[ForeignCallOutput, ...]

    @classmethod
    def single(cls, value: Value) -> "ForeignCallResult":
        return cls(values=(FcSingle(value),))

    @classmethod
    def array(cls, values: List[Value]) -> "ForeignCallResult":
        return cls(values=(FcArray(tuple(values)),))
