"""Black-box function solvers (reference: crates ``blackbox_solver`` +
``barretenberg_blackbox_solver``).

Free functions (sha256/blake2s/keccak256/hash_to_field/ecdsa verify) have
canonical implementations here, in pure Python ints: the bit-exactness oracle
of the batched device gadgets (``acvm_tpu_torch.gpu.ec``,
``acvm_tpu_torch.gpu.gadgets``) and what the host stages of the batched
solver and the sequential engine (``acvm_tpu_torch.pwg``) run.  The three
backend-dependent ops (schnorr, pedersen, fixed-base scalar mul over Grumpkin)
go through the :class:`BlackBoxFunctionSolver` protocol so backends can be
swapped, exactly as the reference's trait does
(``blackbox_solver/src/lib.rs:27-45``).
"""

from __future__ import annotations

from typing import List, Protocol, Tuple

from ..fields.field import FieldElement
from ..acir.opcodes import BlackBoxFunc
from . import ec, grumpkin, hashes
from .ecdsa import EcdsaError, ecdsa_secp256k1_verify, ecdsa_secp256r1_verify
from .hashes import blake2s, hash_to_field_128_security, keccak256, sha256


class BlackBoxResolutionError(Exception):
    """unsupported or failed black-box function."""

    def __init__(self, func: BlackBoxFunc, reason: str, unsupported: bool = False):
        self.func = func
        self.reason = reason
        self.unsupported = unsupported
        if unsupported:
            super().__init__(f"unsupported blackbox function: {func.func_name()}")
        else:
            super().__init__(
                f"failed to solve blackbox function: {func.func_name()}, reason: {reason}"
            )


class BlackBoxFunctionSolver(Protocol):
    def schnorr_verify(
        self,
        public_key_x: FieldElement,
        public_key_y: FieldElement,
        signature: bytes,
        message: bytes,
    ) -> bool: ...

    def pedersen(
        self, inputs: List[FieldElement], domain_separator: int
    ) -> Tuple[FieldElement, FieldElement]: ...

    def fixed_base_scalar_mul(
        self, low: FieldElement, high: FieldElement
    ) -> Tuple[FieldElement, FieldElement]: ...


class GrumpkinSolver:
    """Default backend: the Grumpkin implementations of :mod:`.grumpkin`
    (replaces the reference's barretenberg C++/WASM FFI)."""

    def schnorr_verify(self, public_key_x, public_key_y, signature, message):
        try:
            return grumpkin.schnorr_verify(
                public_key_x, public_key_y, bytes(signature), bytes(message)
            )
        except grumpkin.GrumpkinError as e:
            raise BlackBoxResolutionError(BlackBoxFunc.SchnorrVerify, str(e))

    def pedersen(self, inputs, domain_separator):
        try:
            return grumpkin.pedersen_commit(list(inputs), domain_separator)
        except grumpkin.GrumpkinError as e:
            raise BlackBoxResolutionError(BlackBoxFunc.Pedersen, str(e))

    def fixed_base_scalar_mul(self, low, high):
        try:
            return grumpkin.fixed_base_scalar_mul(low, high)
        except grumpkin.GrumpkinError as e:
            raise BlackBoxResolutionError(BlackBoxFunc.FixedBaseScalarMul, str(e))

    def pedersen_barretenberg_compatible(self, num_inputs: int) -> bool:
        """True when pedersen(num_inputs inputs, domain 0) is bit-exact with
        barretenberg's pedersen_plookup_commit.  Our generators match the two
        pinned barretenberg points (wasm/pedersen.rs:38-55); the plookup
        derivation for further generators is unreconstructed."""
        return num_inputs <= 2


class StubBlackBoxSolver:
    """Fixed-return stub mirroring the reference's DummyBlackBoxSolver
    (brillig_vm/src/lib.rs:392-418) for tests that never exercise EC gadgets."""

    def schnorr_verify(self, public_key_x, public_key_y, signature, message):
        return True

    def pedersen(self, inputs, domain_separator):
        return FieldElement(2), FieldElement(3)

    def fixed_base_scalar_mul(self, low, high):
        return FieldElement(4), FieldElement(5)


__all__ = [
    "BlackBoxFunctionSolver",
    "BlackBoxResolutionError",
    "GrumpkinSolver",
    "StubBlackBoxSolver",
    "ec",
    "grumpkin",
    "hashes",
    "sha256",
    "blake2s",
    "keccak256",
    "hash_to_field_128_security",
    "ecdsa_secp256k1_verify",
    "ecdsa_secp256r1_verify",
    "EcdsaError",
]
