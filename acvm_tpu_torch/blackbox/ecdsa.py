"""ECDSA signature verification for secp256k1 and secp256r1.

Mirrors the reference exactly (``blackbox_solver/src/lib.rs:101-210``):
prehashed message, low-S enforcement (BIP-0062 style — high S verifies false),
and *no* truncation of the hashed message: the 32-byte scalar conversions that
the reference unwraps become ``EcdsaError`` here, and an out-of-range r/s/z or
invalid public key raises rather than returning False, matching the reference's
panicking unwraps surfacing as failures.
"""

from __future__ import annotations

from .ec import Curve, secp256k1, secp256r1


class EcdsaError(ValueError):
    pass


def _verify(curve: Curve, hashed_msg: bytes, pub_x: bytes, pub_y: bytes, sig: bytes) -> bool:
    if len(pub_x) != 32 or len(pub_y) != 32:
        raise EcdsaError("public key coordinates must be 32 bytes")
    if len(sig) != 64:
        raise EcdsaError("signature must be 64 bytes")
    if len(hashed_msg) != 32:
        raise EcdsaError("hashed message must be 32 bytes")

    p, n = curve.params.p, curve.params.n
    x = int.from_bytes(pub_x, "big")
    y = int.from_bytes(pub_y, "big")
    if x >= p or y >= p:
        raise EcdsaError("public key coordinate out of field range")
    pubkey = (x, y)
    if not curve.is_on_curve(pubkey):
        raise EcdsaError("public key is not on the curve")

    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    # k256/p256 Signature::try_from rejects out-of-range or zero components.
    if not (1 <= r < n) or not (1 <= s < n):
        raise EcdsaError("signature component out of range")

    z = int.from_bytes(hashed_msg, "big")
    if z >= n:
        # Scalar::from_repr(hashed_msg) fails (reference unwraps -> panic).
        raise EcdsaError("hashed message does not reduce into the scalar field")

    # Low-S rule: high S simply fails verification (lib.rs:137-140).
    if s > n // 2:
        return False

    s_inv = pow(s, -1, n)
    u1 = (z * s_inv) % n
    u2 = (r * s_inv) % n
    R = curve.lincomb(u1, curve.generator(), u2, pubkey)
    if R is None:
        return False
    return R[0] % n == r


def ecdsa_secp256k1_verify(hashed_msg: bytes, pub_x: bytes, pub_y: bytes, sig: bytes) -> bool:
    return _verify(secp256k1, hashed_msg, pub_x, pub_y, sig)


def ecdsa_secp256r1_verify(hashed_msg: bytes, pub_x: bytes, pub_y: bytes, sig: bytes) -> bool:
    return _verify(secp256r1, hashed_msg, pub_x, pub_y, sig)
