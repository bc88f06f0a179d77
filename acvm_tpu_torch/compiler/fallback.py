"""FallbackTransformer: replace unsupported black-box calls with stdlib gate
expansions (reference: acvm/src/compiler/transformers/fallback.rs).

AND/XOR/RANGE always have fallbacks; SHA256/Blake2s/Keccak256/HashToField have
gate expansions as well (the reference gates those behind the
``unstable-fallbacks`` feature; here they are always available).  Unsupported
memory opcodes are hard errors.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

from ..acir.circuit import Circuit
from ..acir.expression import Expression
from ..acir import opcodes as ops


class CompileError(Exception):
    pass


class UnsupportedBlackBox(CompileError):
    def __init__(self, func):
        self.func = func
        super().__init__(
            f"The blackbox function {func.func_name()} is not supported by the "
            "backend and acvm does not have a fallback implementation"
        )


class UnsupportedMemoryOpcode(CompileError):
    def __init__(self, name: str):
        super().__init__(
            f"The opcode {name} is not supported by the backend and acvm does "
            "not have a fallback implementation"
        )


def transform(
    circuit: Circuit,
    is_supported: Callable[[ops.Opcode], bool],
    opcode_positions: List[int],
    enable_hash_fallbacks: bool = True,
) -> Tuple[Circuit, List[int]]:
    supported_opcodes: List[ops.Opcode] = []
    new_positions: List[int] = []
    witness_idx = circuit.current_witness_index + 1

    for idx, opcode in enumerate(circuit.opcodes):
        if isinstance(
            opcode, (ops.OpcodeArithmetic, ops.OpcodeDirective, ops.OpcodeBrillig)
        ):
            new_positions.append(opcode_positions[idx])
            supported_opcodes.append(opcode)
            continue
        if isinstance(opcode, (ops.OpcodeMemoryInit, ops.OpcodeMemoryOp)):
            if not is_supported(opcode):
                raise UnsupportedMemoryOpcode(
                    "MemoryInit"
                    if isinstance(opcode, ops.OpcodeMemoryInit)
                    else "MemoryOp"
                )
            new_positions.append(opcode_positions[idx])
            supported_opcodes.append(opcode)
            continue
        assert isinstance(opcode, ops.OpcodeBlackBoxFuncCall)
        if is_supported(opcode):
            new_positions.append(opcode_positions[idx])
            supported_opcodes.append(opcode)
            continue
        witness_idx, fallback_opcodes = _opcode_fallback(
            opcode.call, witness_idx, enable_hash_fallbacks
        )
        new_positions.extend([opcode_positions[idx]] * len(fallback_opcodes))
        supported_opcodes.extend(fallback_opcodes)

    return (
        Circuit(
            current_witness_index=witness_idx,
            opcodes=supported_opcodes,
            private_parameters=circuit.private_parameters,
            public_parameters=circuit.public_parameters,
            return_values=circuit.return_values,
            assert_messages=circuit.assert_messages,
        ),
        new_positions,
    )


def _opcode_fallback(
    call: ops.BlackBoxFuncCall,
    witness_idx: int,
    enable_hash_fallbacks: bool = True,
):
    from ..stdlib import logic_fallbacks

    if not enable_hash_fallbacks and isinstance(
        call,
        (ops.BBSha256, ops.BBBlake2s, ops.BBKeccak256, ops.BBHashToField128Security),
    ):
        # Mirrors the reference's `unstable-fallbacks` cargo feature: with the
        # feature off, hash gadgets have no gate expansion
        # (compiler/transformers/fallback.rs:107-162).
        raise UnsupportedBlackBox(call.get_black_box_func())

    if isinstance(call, ops.BBAnd):
        assert call.lhs.num_bits == call.rhs.num_bits, (
            "number of bits specified for each input must be the same"
        )
        return logic_fallbacks.and_fallback(
            Expression.from_witness(call.lhs.witness),
            Expression.from_witness(call.rhs.witness),
            call.output,
            call.lhs.num_bits,
            witness_idx,
        )
    if isinstance(call, ops.BBXor):
        assert call.lhs.num_bits == call.rhs.num_bits, (
            "number of bits specified for each input must be the same"
        )
        return logic_fallbacks.xor_fallback(
            Expression.from_witness(call.lhs.witness),
            Expression.from_witness(call.rhs.witness),
            call.output,
            call.lhs.num_bits,
            witness_idx,
        )
    if isinstance(call, ops.BBRange):
        return logic_fallbacks.range_fallback(
            Expression.from_witness(call.input.witness),
            call.input.num_bits,
            witness_idx,
        )
    if isinstance(call, ops.BBSha256):
        from ..stdlib.sha256 import sha256

        return sha256(
            [(Expression.from_witness(fi.witness), fi.num_bits) for fi in call.inputs],
            list(call.outputs),
            witness_idx,
        )
    if isinstance(call, ops.BBBlake2s):
        from ..stdlib.blake2s import blake2s

        return blake2s(
            [(Expression.from_witness(fi.witness), fi.num_bits) for fi in call.inputs],
            list(call.outputs),
            witness_idx,
        )
    if isinstance(call, ops.BBKeccak256):
        from ..stdlib.keccak256 import keccak256

        return keccak256(
            [(Expression.from_witness(fi.witness), fi.num_bits) for fi in call.inputs],
            list(call.outputs),
            witness_idx,
        )
    if isinstance(call, ops.BBHashToField128Security):
        from ..stdlib.hash_to_field import hash_to_field

        return hash_to_field(
            [(Expression.from_witness(fi.witness), fi.num_bits) for fi in call.inputs],
            call.output,
            witness_idx,
        )
    raise UnsupportedBlackBox(call.get_black_box_func())
