"""The Brillig unconstrained VM — host interpreter.

Mirrors ``brillig_vm/src/{lib,arithmetic,memory,registers,black_box}.rs``:
a register machine over field-valued cells with grow-on-write registers/memory,
static jump/call targets, integer ops evaluated mod 2^bit_size (signed division
via two's complement), foreign-call pause/replay via a result counter, and
black-box gadget instructions.

The batched solver runs straight-line hint blocks as limb operations on the
device (``acvm_tpu_torch.gpu.brillig_trace``) and as object arrays on the host
(``acvm_tpu_torch.gpu.host_batch``); this host VM defines the semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Sequence, Tuple

from ..fields.field import FieldElement
from .. import brillig as br
from ..acir.opcodes import BlackBoxFunc
from ..blackbox import (
    BlackBoxFunctionSolver,
    BlackBoxResolutionError,
    blake2s,
    ecdsa_secp256k1_verify,
    ecdsa_secp256r1_verify,
    hash_to_field_128_security,
    keccak256,
    sha256,
)
from ..blackbox.ecdsa import EcdsaError

MAX_REGISTERS = 2**16


class VMStatus:
    FINISHED = "finished"
    IN_PROGRESS = "in_progress"
    FAILURE = "failure"
    FOREIGN_CALL_WAIT = "foreign_call_wait"


@dataclass
class ForeignCallWait:
    function: str
    inputs: List[List[br.Value]]


@dataclass
class Failure:
    message: str
    call_stack: List[int]


class Registers:
    """Grow-on-set register file; reads past the end return zero."""

    __slots__ = ("inner",)

    def __init__(self, values: Optional[Sequence[br.Value]] = None):
        self.inner: List[br.Value] = list(values or [])

    def get(self, index: br.RegisterIndex) -> br.Value:
        i = int(index)
        assert i < MAX_REGISTERS, "Reading register past maximum!"
        if i < len(self.inner):
            return self.inner[i]
        return br.Value.from_int(0)

    def set(self, index: br.RegisterIndex, value: br.Value) -> None:
        i = int(index)
        assert i < MAX_REGISTERS, "Writing register past maximum!"
        if i >= len(self.inner):
            self.inner.extend(
                br.Value.from_int(0) for _ in range(i + 1 - len(self.inner))
            )
        self.inner[i] = value


class Memory:
    """Grow-on-write value array."""

    __slots__ = ("inner",)

    def __init__(self, values: Optional[Sequence[br.Value]] = None):
        self.inner: List[br.Value] = list(values or [])

    def read(self, ptr: int) -> br.Value:
        return self.inner[ptr]

    def read_slice(self, ptr: int, length: int) -> List[br.Value]:
        if ptr + length > len(self.inner):
            raise IndexError("memory read out of bounds")
        return self.inner[ptr : ptr + length]

    def write(self, ptr: int, value: br.Value) -> None:
        self.write_slice(ptr, [value])

    def write_slice(self, ptr: int, values: Sequence[br.Value]) -> None:
        new_size = max(len(self.inner), ptr + len(values))
        if new_size > len(self.inner):
            self.inner.extend(
                br.Value.from_int(0) for _ in range(new_size - len(self.inner))
            )
        self.inner[ptr : ptr + len(values)] = list(values)

    def values(self) -> List[br.Value]:
        return self.inner


def evaluate_binary_field_op(
    op: br.BinaryFieldOp, a: FieldElement, b: FieldElement
) -> FieldElement:
    if op == br.BinaryFieldOp.Add:
        return a + b
    if op == br.BinaryFieldOp.Sub:
        return a - b
    if op == br.BinaryFieldOp.Mul:
        return a * b
    if op == br.BinaryFieldOp.Div:
        return a / b
    if op == br.BinaryFieldOp.Equals:
        return FieldElement(1 if a == b else 0)
    raise ValueError(op)


def evaluate_binary_int_op(op: br.BinaryIntOp, a: int, b: int, bit_size: int) -> int:
    """Integer semantics mod 2^bit_size (brillig_vm/src/arithmetic.rs:23-99)."""
    modulo = 1 << bit_size
    if op == br.BinaryIntOp.Add:
        return (a + b) % modulo
    if op == br.BinaryIntOp.Sub:
        return (modulo + a - b) % modulo
    if op == br.BinaryIntOp.Mul:
        return (a * b) % modulo
    if op == br.BinaryIntOp.UnsignedDiv:
        return (a % modulo) // (b % modulo)
    if op == br.BinaryIntOp.SignedDiv:
        sa = _to_signed(a, bit_size)
        sb = _to_signed(b, bit_size)
        # Rust integer division truncates toward zero.
        q = abs(sa) // abs(sb) if sb != 0 else 0
        if (sa < 0) != (sb < 0):
            q = -q
        return _to_unsigned(q, bit_size)
    if op == br.BinaryIntOp.Equals:
        return 1 if (a % modulo) == (b % modulo) else 0
    if op == br.BinaryIntOp.LessThan:
        return 1 if (a % modulo) < (b % modulo) else 0
    if op == br.BinaryIntOp.LessThanEquals:
        return 1 if (a % modulo) <= (b % modulo) else 0
    if op == br.BinaryIntOp.And:
        return (a & b) % modulo
    if op == br.BinaryIntOp.Or:
        return (a | b) % modulo
    if op == br.BinaryIntOp.Xor:
        return (a ^ b) % modulo
    if op == br.BinaryIntOp.Shl:
        assert bit_size <= 128, "unsupported bit size for left shift"
        return (a << b) % modulo
    if op == br.BinaryIntOp.Shr:
        assert bit_size <= 128, "unsupported bit size for right shift"
        return (a >> b) % modulo
    raise ValueError(op)


def _to_signed(a: int, bit_size: int) -> int:
    half = 1 << (bit_size - 1)
    return a if a < half else a - (1 << bit_size)


def _to_unsigned(a: int, bit_size: int) -> int:
    return a % (1 << bit_size)


def _to_u8_vec(values: Sequence[br.Value]) -> bytes:
    """Last byte of each value's BE field encoding (black_box.rs:28-36)."""
    return bytes(v.to_field().to_be_bytes()[-1] for v in values)


def _to_value_vec(data: bytes) -> List[br.Value]:
    return [br.Value.from_int(b) for b in data]


class VM:
    """brillig_vm::VM — executes bytecode until Finished / Failure /
    ForeignCallWait."""

    def __init__(
        self,
        registers: Registers,
        memory: Sequence[br.Value],
        bytecode: List[br.BrilligOpcode],
        foreign_call_results: List[br.ForeignCallResult],
        black_box_solver: BlackBoxFunctionSolver,
    ):
        self.registers = registers
        self.program_counter = 0
        self.foreign_call_counter = 0
        self.foreign_call_results = list(foreign_call_results)
        self.bytecode = bytecode
        self.status = VMStatus.IN_PROGRESS
        self.status_data = None  # Failure or ForeignCallWait when halted
        self.memory = Memory(memory)
        self.call_stack: List[br.Value] = []
        self.black_box_solver = black_box_solver

    # ---- status helpers -----------------------------------------------------
    def _finish(self) -> str:
        self.status = VMStatus.FINISHED
        return self.status

    def _wait_for_foreign_call(self, function: str, inputs) -> str:
        self.status = VMStatus.FOREIGN_CALL_WAIT
        self.status_data = ForeignCallWait(function, inputs)
        return self.status

    def _fail(self, message: str) -> str:
        stack = [v.to_usize() for v in self.call_stack]
        stack.append(self.program_counter)
        self.status = VMStatus.FAILURE
        self.status_data = Failure(message, stack)
        return self.status

    # ---- main loop ----------------------------------------------------------
    def process_opcodes(self) -> str:
        while self.process_opcode() == VMStatus.IN_PROGRESS:
            pass
        return self.status

    def get_memory(self) -> List[br.Value]:
        return self.memory.values()

    def process_opcode(self) -> str:
        op = self.bytecode[self.program_counter]

        if isinstance(op, br.OpBinaryFieldOp):
            a = self.registers.get(op.lhs).to_field()
            b = self.registers.get(op.rhs).to_field()
            self.registers.set(op.destination, br.Value(evaluate_binary_field_op(op.op, a, b)))
            return self._increment_pc()

        if isinstance(op, br.OpBinaryIntOp):
            a = int(self.registers.get(op.lhs).to_field())
            b = int(self.registers.get(op.rhs).to_field())
            result = evaluate_binary_int_op(op.op, a, b, op.bit_size)
            self.registers.set(op.destination, br.Value.from_int(result))
            return self._increment_pc()

        if isinstance(op, br.OpJump):
            return self._set_pc(op.location)

        if isinstance(op, br.OpJumpIf):
            if not self.registers.get(op.condition).is_zero():
                return self._set_pc(op.location)
            return self._increment_pc()

        if isinstance(op, br.OpJumpIfNot):
            if self.registers.get(op.condition).is_zero():
                return self._set_pc(op.location)
            return self._increment_pc()

        if isinstance(op, br.OpReturn):
            if self.call_stack:
                ret = self.call_stack.pop()
                return self._set_pc(ret.to_usize() + 1)
            return self._fail("return opcode hit, but callstack already empty")

        if isinstance(op, br.OpForeignCall):
            return self._process_foreign_call(op)

        if isinstance(op, br.OpMov):
            self.registers.set(op.destination, self.registers.get(op.source))
            return self._increment_pc()

        if isinstance(op, br.OpTrap):
            return self._fail("explicit trap hit in brillig")

        if isinstance(op, br.OpStop):
            return self._finish()

        if isinstance(op, br.OpLoad):
            source = self.registers.get(op.source_pointer)
            value = self.memory.read(source.to_usize())
            self.registers.set(op.destination, value)
            return self._increment_pc()

        if isinstance(op, br.OpStore):
            destination = self.registers.get(op.destination_pointer).to_usize()
            self.memory.write(destination, self.registers.get(op.source))
            return self._increment_pc()

        if isinstance(op, br.OpCall):
            self.call_stack.append(br.Value.from_int(self.program_counter))
            return self._set_pc(op.location)

        if isinstance(op, br.OpConst):
            self.registers.set(op.destination, op.value)
            return self._increment_pc()

        if isinstance(op, br.OpBlackBox):
            try:
                self._evaluate_black_box(op.op)
            except (BlackBoxResolutionError, EcdsaError, IndexError, ValueError) as e:
                return self._fail(str(e))
            return self._increment_pc()

        raise TypeError(f"unknown brillig opcode {op!r}")

    # ---- pieces -------------------------------------------------------------
    def _increment_pc(self) -> str:
        return self._set_pc(self.program_counter + 1)

    def _set_pc(self, value: int) -> str:
        assert self.program_counter < len(self.bytecode)
        self.program_counter = value
        if self.program_counter >= len(self.bytecode):
            self.status = VMStatus.FINISHED
        return self.status

    def _get_rom_values(self, rom) -> List[br.Value]:
        if isinstance(rom, br.RomRegister):
            return [self.registers.get(rom.index)]
        if isinstance(rom, br.RomHeapArray):
            start = self.registers.get(rom.array.pointer)
            return list(self.memory.read_slice(start.to_usize(), rom.array.size))
        if isinstance(rom, br.RomHeapVector):
            start = self.registers.get(rom.vector.pointer)
            size = self.registers.get(rom.vector.size)
            return list(self.memory.read_slice(start.to_usize(), size.to_usize()))
        raise TypeError(rom)

    def _process_foreign_call(self, op: br.OpForeignCall) -> str:
        if self.foreign_call_counter >= len(self.foreign_call_results):
            resolved_inputs = [self._get_rom_values(i) for i in op.inputs]
            return self._wait_for_foreign_call(op.function, resolved_inputs)

        values = self.foreign_call_results[self.foreign_call_counter].values

        invalid_result = False
        for destination, output in zip(op.destinations, values):
            if isinstance(destination, br.RomRegister):
                if not isinstance(output, br.FcSingle):
                    raise RuntimeError(
                        "Function result size does not match brillig bytecode "
                        "(expected 1 result)"
                    )
                self.registers.set(destination.index, output.value)
            elif isinstance(destination, br.RomHeapArray):
                if not isinstance(output, br.FcArray):
                    raise RuntimeError(
                        "Function result size does not match brillig bytecode size"
                    )
                if len(output.values) != destination.array.size:
                    invalid_result = True
                    break
                dest = self.registers.get(destination.array.pointer).to_usize()
                self.memory.write_slice(dest, list(output.values))
            elif isinstance(destination, br.RomHeapVector):
                if not isinstance(output, br.FcArray):
                    raise RuntimeError(
                        "Function result size does not match brillig bytecode size"
                    )
                self.registers.set(
                    destination.vector.size, br.Value.from_int(len(output.values))
                )
                dest = self.registers.get(destination.vector.pointer).to_usize()
                self.memory.write_slice(dest, list(output.values))
            else:
                raise TypeError(destination)

        if len(op.destinations) != len(values):
            self._fail(
                f"{len(values)} output values were provided as a foreign call "
                f"result for {len(op.destinations)} destination slots"
            )
        if invalid_result:
            self._fail("Function result size does not match brillig bytecode")

        self.foreign_call_counter += 1
        return self._increment_pc()

    def _evaluate_black_box(self, op: br.BlackBoxOp) -> None:
        regs, mem = self.registers, self.memory

        def heap_vector_bytes(vec: br.HeapVector) -> bytes:
            return _to_u8_vec(
                mem.read_slice(
                    regs.get(vec.pointer).to_usize(), regs.get(vec.size).to_usize()
                )
            )

        def heap_array_bytes(arr: br.HeapArray) -> bytes:
            return _to_u8_vec(
                mem.read_slice(regs.get(arr.pointer).to_usize(), arr.size)
            )

        if isinstance(op, (br.BBSha256, br.BBBlake2s, br.BBKeccak256)):
            fn = {
                br.BBSha256: sha256,
                br.BBBlake2s: blake2s,
                br.BBKeccak256: keccak256,
            }[type(op)]
            digest = fn(heap_vector_bytes(op.message))
            mem.write_slice(
                regs.get(op.output.pointer).to_usize(), _to_value_vec(digest)
            )
        elif isinstance(op, br.BBHashToField128Security):
            f = hash_to_field_128_security(heap_vector_bytes(op.message))
            regs.set(op.output, br.Value(f))
        elif isinstance(op, (br.BBEcdsaSecp256k1, br.BBEcdsaSecp256r1)):
            func = (
                BlackBoxFunc.EcdsaSecp256k1
                if isinstance(op, br.BBEcdsaSecp256k1)
                else BlackBoxFunc.EcdsaSecp256r1
            )
            pub_x = heap_array_bytes(op.public_key_x)
            pub_y = heap_array_bytes(op.public_key_y)
            sig = heap_array_bytes(op.signature)
            if len(pub_x) != 32:
                raise BlackBoxResolutionError(func, "Invalid public key x length")
            if len(pub_y) != 32:
                raise BlackBoxResolutionError(func, "Invalid public key y length")
            if len(sig) != 64:
                raise BlackBoxResolutionError(func, "Invalid signature length")
            msg = heap_vector_bytes(op.hashed_msg)
            verify = (
                ecdsa_secp256k1_verify
                if isinstance(op, br.BBEcdsaSecp256k1)
                else ecdsa_secp256r1_verify
            )
            regs.set(op.result, br.Value.from_bool(verify(msg, pub_x, pub_y, sig)))
        elif isinstance(op, br.BBSchnorrVerify):
            pub_x = regs.get(op.public_key_x).to_field()
            pub_y = regs.get(op.public_key_y).to_field()
            message = heap_vector_bytes(op.message)
            signature = heap_vector_bytes(op.signature)
            verified = self.black_box_solver.schnorr_verify(
                pub_x, pub_y, signature, message
            )
            regs.set(op.result, br.Value.from_bool(verified))
        elif isinstance(op, br.BBFixedBaseScalarMul):
            low = regs.get(op.low).to_field()
            high = regs.get(op.high).to_field()
            x, y = self.black_box_solver.fixed_base_scalar_mul(low, high)
            mem.write_slice(
                regs.get(op.result.pointer).to_usize(), [br.Value(x), br.Value(y)]
            )
        elif isinstance(op, br.BBPedersen):
            inputs = [
                v.to_field()
                for v in mem.read_slice(
                    regs.get(op.inputs.pointer).to_usize(),
                    regs.get(op.inputs.size).to_usize(),
                )
            ]
            sep = regs.get(op.domain_separator).to_u128()
            if sep >= 1 << 32:
                raise BlackBoxResolutionError(
                    BlackBoxFunc.Pedersen, "Invalid signature length"
                )
            x, y = self.black_box_solver.pedersen(inputs, sep)
            mem.write_slice(
                regs.get(op.output.pointer).to_usize(), [br.Value(x), br.Value(y)]
            )
        else:
            raise TypeError(op)
