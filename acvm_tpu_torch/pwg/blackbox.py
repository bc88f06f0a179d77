"""Black-box opcode dispatch (reference: acvm/src/pwg/blackbox/).

Checks every input witness is assigned, then routes the 14 gadget variants to
the hash/logic/range/signature/EC solvers.
"""

from __future__ import annotations

from typing import List, Optional

from ..acir.opcodes import (
    BBAnd,
    BBBlake2s,
    BBEcdsaSecp256k1,
    BBEcdsaSecp256r1,
    BBFixedBaseScalarMul,
    BBHashToField128Security,
    BBKeccak256,
    BBKeccak256VariableLength,
    BBPedersen,
    BBRange,
    BBRecursiveAggregation,
    BBSchnorrVerify,
    BBSha256,
    BBXor,
    BlackBoxFunc,
    BlackBoxFuncCall,
    FunctionInput,
)
from ..acir.witness import Witness, WitnessMap
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
from ..fields.field import FieldElement
from .errors import (
    BlackBoxFunctionFailed,
    MissingAssignment,
    UnsatisfiedConstrain,
    UnsupportedBlackBoxFunc,
)


def _first_missing_assignment(
    witness_map: WitnessMap, inputs: List[FunctionInput]
) -> Optional[Witness]:
    for fi in inputs:
        if not witness_map.contains_key(fi.witness):
            return fi.witness
    return None


def _get_hash_input(
    witness_map: WitnessMap,
    inputs: List[FunctionInput],
    message_size: Optional[FunctionInput],
) -> bytes:
    from .acvm import witness_to_value

    message = bytearray()
    for fi in inputs:
        value = witness_to_value(witness_map, fi.witness)
        message.extend(value.fetch_nearest_bytes(fi.num_bits))
    if message_size is not None:
        num_bytes_to_take = witness_to_value(witness_map, message_size.witness).to_u128()
        if num_bytes_to_take > len(message):
            raise BlackBoxFunctionFailed(
                BlackBoxFunc.Keccak256,
                "the number of bytes to take from the message is more than the "
                f"number of bytes in the message. {num_bytes_to_take} > {len(message)}",
            )
        return bytes(message[:num_bytes_to_take])
    return bytes(message)


def _write_digest(witness_map: WitnessMap, outputs: List[Witness], digest: bytes):
    from .acvm import insert_value

    for output_witness, value in zip(outputs, digest):
        insert_value(output_witness, FieldElement(value), witness_map)


def _to_u8_vec(witness_map: WitnessMap, inputs: List[FunctionInput]) -> bytes:
    """Last byte of each witness's BE encoding (signature/mod.rs:5-18)."""
    from .acvm import witness_to_value

    return bytes(
        witness_to_value(witness_map, fi.witness).to_be_bytes()[-1] for fi in inputs
    )


def solve(
    backend: BlackBoxFunctionSolver,
    witness_map: WitnessMap,
    bb_func: BlackBoxFuncCall,
) -> None:
    from .acvm import insert_value, witness_to_value

    inputs = bb_func.get_inputs_vec()
    missing = _first_missing_assignment(witness_map, inputs)
    if missing is not None:
        raise MissingAssignment(int(missing))

    func = bb_func.get_black_box_func()

    if isinstance(bb_func, (BBAnd, BBXor)):
        assert bb_func.lhs.num_bits == bb_func.rhs.num_bits, (
            "number of bits specified for each input must be the same"
        )
        lhs = witness_to_value(witness_map, bb_func.lhs.witness)
        rhs = witness_to_value(witness_map, bb_func.rhs.witness)
        if isinstance(bb_func, BBAnd):
            assignment = lhs.and_(rhs, bb_func.lhs.num_bits)
        else:
            assignment = lhs.xor(rhs, bb_func.lhs.num_bits)
        insert_value(bb_func.output, assignment, witness_map)
        return

    if isinstance(bb_func, BBRange):
        w_value = witness_to_value(witness_map, bb_func.input.witness)
        if w_value.num_bits() > bb_func.input.num_bits:
            raise UnsatisfiedConstrain()
        return

    if isinstance(bb_func, (BBSha256, BBBlake2s, BBKeccak256, BBKeccak256VariableLength)):
        hash_fn = {
            BBSha256: sha256,
            BBBlake2s: blake2s,
            BBKeccak256: keccak256,
            BBKeccak256VariableLength: keccak256,
        }[type(bb_func)]
        var_size = (
            bb_func.var_message_size
            if isinstance(bb_func, BBKeccak256VariableLength)
            else None
        )
        message = _get_hash_input(witness_map, bb_func.inputs, var_size)
        digest = hash_fn(message)
        if len(bb_func.outputs) != 32:
            raise BlackBoxFunctionFailed(
                func, f"Expected 32 outputs but encountered {len(bb_func.outputs)}"
            )
        _write_digest(witness_map, bb_func.outputs, digest)
        return

    if isinstance(bb_func, BBHashToField128Security):
        message = _get_hash_input(witness_map, bb_func.inputs, None)
        field = hash_to_field_128_security(message)
        insert_value(bb_func.output, field, witness_map)
        return

    if isinstance(bb_func, BBSchnorrVerify):
        public_key_x = witness_to_value(witness_map, bb_func.public_key_x.witness)
        public_key_y = witness_to_value(witness_map, bb_func.public_key_y.witness)
        signature = _to_u8_vec(witness_map, bb_func.signature)
        message = _to_u8_vec(witness_map, bb_func.message)
        try:
            valid = backend.schnorr_verify(
                public_key_x, public_key_y, signature, message
            )
        except BlackBoxResolutionError as e:
            raise _convert_bb_error(e)
        insert_value(
            bb_func.output, FieldElement(1 if valid else 0), witness_map
        )
        return

    if isinstance(bb_func, BBPedersen):
        scalars = [
            witness_to_value(witness_map, fi.witness) for fi in bb_func.inputs
        ]
        try:
            res_x, res_y = backend.pedersen(scalars, bb_func.domain_separator)
        except BlackBoxResolutionError as e:
            raise _convert_bb_error(e)
        insert_value(bb_func.outputs[0], res_x, witness_map)
        insert_value(bb_func.outputs[1], res_y, witness_map)
        return

    if isinstance(bb_func, (BBEcdsaSecp256k1, BBEcdsaSecp256r1)):
        hashed_message = _to_u8_vec(witness_map, bb_func.hashed_message)
        pub_x = _to_u8_vec(witness_map, bb_func.public_key_x)
        pub_y = _to_u8_vec(witness_map, bb_func.public_key_y)
        sig = _to_u8_vec(witness_map, bb_func.signature)
        if len(pub_x) != 32:
            raise BlackBoxFunctionFailed(
                func, f"expected pubkey_x size 32 but received {len(pub_x)}"
            )
        if len(pub_y) != 32:
            raise BlackBoxFunctionFailed(
                func, f"expected pubkey_y size 32 but received {len(pub_y)}"
            )
        if len(sig) != 64:
            raise BlackBoxFunctionFailed(
                func, f"expected signature size 64 but received {len(sig)}"
            )
        verify = (
            ecdsa_secp256k1_verify
            if isinstance(bb_func, BBEcdsaSecp256k1)
            else ecdsa_secp256r1_verify
        )
        try:
            is_valid = verify(hashed_message, pub_x, pub_y, sig)
        except EcdsaError as e:
            raise BlackBoxFunctionFailed(func, str(e))
        insert_value(
            bb_func.output, FieldElement(1 if is_valid else 0), witness_map
        )
        return

    if isinstance(bb_func, BBFixedBaseScalarMul):
        low = witness_to_value(witness_map, bb_func.low.witness)
        high = witness_to_value(witness_map, bb_func.high.witness)
        try:
            pub_x, pub_y = backend.fixed_base_scalar_mul(low, high)
        except BlackBoxResolutionError as e:
            raise _convert_bb_error(e)
        insert_value(bb_func.outputs[0], pub_x, witness_map)
        insert_value(bb_func.outputs[1], pub_y, witness_map)
        return

    if isinstance(bb_func, BBRecursiveAggregation):
        # Output zeroed; the real value is computed by the proving backend
        # (blackbox/mod.rs:154-161).
        for witness in bb_func.output_aggregation_object:
            insert_value(witness, FieldElement.zero(), witness_map)
        return

    raise UnsupportedBlackBoxFunc(func)


def _convert_bb_error(e: BlackBoxResolutionError):
    if e.unsupported:
        return UnsupportedBlackBoxFunc(e.func)
    return BlackBoxFunctionFailed(e.func, e.reason)
