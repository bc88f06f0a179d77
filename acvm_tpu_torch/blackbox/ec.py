"""Generic short-Weierstrass curve arithmetic over prime fields (host side).

Used by the ECDSA verifiers (secp256k1 / secp256r1 — reference:
``blackbox_solver/src/lib.rs:101-210``) and by the Grumpkin embedded-curve
gadgets (reference outsources those to barretenberg C++/WASM;
``barretenberg_blackbox_solver/src/wasm``).  Host path uses Jacobian
coordinates with Python ints; the batched device path has its own limb kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class CurveParams:
    name: str
    p: int  # base field modulus
    a: int
    b: int
    n: int  # group order
    gx: int
    gy: int


# y^2 = x^3 + 7 over Fp
SECP256K1 = CurveParams(
    name="secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

# NIST P-256
SECP256R1 = CurveParams(
    name="secp256r1",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)

# Grumpkin: y^2 = x^3 - 17 over BN254's scalar field Fr; its group order is
# BN254's base-field modulus Fq (the 2-cycle).  Generator (1, sqrt(-16)) —
# pinned by the reference golden vector scalar_mul.rs:76-84.
GRUMPKIN = CurveParams(
    name="grumpkin",
    p=0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
    a=0,
    b=-17,
    n=0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
    gx=1,
    gy=0x0000000000000002CF135E7506A45D632D270D45F1181294833FC48D823F272C,
)


Point = Optional[Tuple[int, int]]  # None = point at infinity (affine)


class Curve:
    __slots__ = ("params",)

    def __init__(self, params: CurveParams):
        self.params = params

    # ---- affine predicates --------------------------------------------------
    def is_on_curve(self, pt: Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        p = self.params.p
        return (y * y - (x * x * x + self.params.a * x + self.params.b)) % p == 0

    def generator(self) -> Point:
        return (self.params.gx, self.params.gy % self.params.p)

    # ---- group law (affine, Python ints; fine for host-side use) ------------
    def add(self, p1: Point, p2: Point) -> Point:
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        p = self.params.p
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            # doubling
            lam = (3 * x1 * x1 + self.params.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def neg(self, pt: Point) -> Point:
        if pt is None:
            return None
        x, y = pt
        return (x, (-y) % self.params.p)

    def mul(self, k: int, pt: Point) -> Point:
        k %= self.params.n
        result: Point = None
        addend = pt
        while k:
            if k & 1:
                result = self.add(result, addend)
            addend = self.add(addend, addend)
            k >>= 1
        return result

    def mul_g(self, k: int) -> Point:
        return self.mul(k, self.generator())

    def lincomb(self, k1: int, p1: Point, k2: int, p2: Point) -> Point:
        return self.add(self.mul(k1, p1), self.mul(k2, p2))


secp256k1 = Curve(SECP256K1)
secp256r1 = Curve(SECP256R1)
grumpkin = Curve(GRUMPKIN)
