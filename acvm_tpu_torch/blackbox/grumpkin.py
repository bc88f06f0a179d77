"""Grumpkin embedded-curve gadgets: fixed-base scalar mul, Pedersen, Schnorr.

The reference delegates these three to a prebuilt barretenberg C++ WASM binary
(``barretenberg_blackbox_solver/src/wasm/{scalar_mul,pedersen,schnorr}.rs``).
This module reimplements them from scratch over the Grumpkin curve, in pure
Python ints (the bit-exactness oracle of the batched device gadgets in
``acvm_tpu_torch.gpu.ec``):

The three run their curve arithmetic in the host Grumpkin library
(:mod:`acvm_tpu_torch.native`, C++), as the JAX package's do;
``native=False`` runs it in the pure-Python curve code, the plain version.

* ``fixed_base_scalar_mul`` — bit-exact with the reference golden vectors
  (scalar_mul.rs:76-98): scalar = low + high * 2^128 against generator
  (1, sqrt(-16)), with the u128-limb and grumpkin-modulus validation errors.

* ``pedersen`` — commitment = sum_i s_i * G_i over a generator table.  The first
  two generators of hash index 0 are pinned to the points exposed by the
  reference test suite (pedersen([1],0) and pedersen([0,1],0) golden vectors —
  wasm/pedersen.rs:42-50 and acvm_js/test/shared/pedersen.ts), so commitments
  over <=2 inputs at domain_separator 0 are bit-exact with barretenberg.
  Generators beyond the pinned ones are derived by a documented hash-to-curve
  (keccak256 counter stream); those commitments are deterministic and
  self-consistent but NOT barretenberg-compatible, because the reference ships
  barretenberg's derivation only inside an opaque WASM binary.

* ``schnorr`` — barretenberg-shaped protocol: challenge
  e = blake2s(pedersen_compress(R.x, pub.x, pub.y) || message) reduced into the
  grumpkin scalar field; signature is (s, e) with R = s*G + e*P.  Sign/verify
  round-trips within this framework; cross-compatibility with barretenberg
  signatures inherits the pedersen caveat above.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..fields.field import FieldElement
from .ec import grumpkin, Point
from .hashes import blake2s, keccak256


class GrumpkinError(ValueError):
    pass


P = grumpkin.params.p  # base field (= BN254 Fr)
N = grumpkin.params.n  # scalar field (= BN254 Fq)


def _sqrt_mod_p(a: int) -> Optional[int]:
    a %= P
    if a == 0:
        return 0
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    # Tonelli-Shanks (P % 4 == 1 for this modulus).
    q, s = P - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 5
    while pow(z, (P - 1) // 2, P) != P - 1:
        z += 1
    m, c, t, r = s, pow(z, q, P), pow(a, q, P), pow(a, (q + 1) // 2, P)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m, c = i, b * b % P
        t, r = t * c % P, r * b % P
    return r


# ---------------------------------------------------------------------------
# Fixed-base scalar multiplication (BlackBoxFunc::FixedBaseScalarMul)
# ---------------------------------------------------------------------------


def fixed_base_scalar_mul(
    low: FieldElement, high: FieldElement, *, native: bool = True
) -> Tuple[FieldElement, FieldElement]:
    low_u128 = low.try_into_u128()
    if low_u128 is None:
        raise GrumpkinError(f"invalid grumpkin scalar limb: {low.to_hex()}")
    high_u128 = high.try_into_u128()
    if high_u128 is None:
        raise GrumpkinError(f"invalid grumpkin scalar limb: {high.to_hex()}")

    scalar = low_u128 + (high_u128 << 128)
    if scalar >= N:
        raise GrumpkinError(
            f"invalid grumpkin scalar: {scalar.to_bytes(32, 'big').hex()}"
        )

    if native:
        from .. import native as lib

        point = lib.grumpkin_mul(grumpkin.generator(), scalar)
    else:
        point = grumpkin.mul_g(scalar)
    if point is None:
        return FieldElement.zero(), FieldElement.zero()
    return FieldElement(point[0]), FieldElement(point[1])


# ---------------------------------------------------------------------------
# Pedersen commitment (BlackBoxFunc::Pedersen)
# ---------------------------------------------------------------------------

# Generators pinned by the reference's own test vectors (hash index 0).
_PINNED_GENERATORS: List[Tuple[int, int]] = [
    (
        0x09489945604C9686E698CB69D7BD6FC0CDB02E9FAAE3E1A433F1C342C1A5ECC4,
        0x24F50D25508B4DFB1E8A834E39565F646E217B24CB3A475C2E4991D1BB07A9D8,
    ),
    (
        0x0C5E1DDECD49DE44ED5E5798D3F6FB7C71FE3D37F5BEE8664CF88A445B5BA0AF,
        0x230294A041E26FE80B827C2EF5CB8784642BBAA83842DA2714D62B1F3C4F9752,
    ),
]

_generator_cache: dict = {}

# Externally-injected generator points, keyed (domain_separator, index).
# The barretenberg derivation lives only inside the reference's opaque WASM
# binary (docs/pedersen_compat.md): deployments that hold the real table can
# inject it here and get bit-exact commitments through BOTH engines (the host
# code here and the batch solver read generators through derive_generator).
_EXTERNAL_GENERATORS: dict = {}


def set_external_generators(
    table, domain_separator: int = 0, validate: bool = True
) -> None:
    """Install an externally-supplied Pedersen generator table.

    ``table`` is a sequence of (x, y) ints (or objects with .value), used for
    indices 0..len-1 at ``domain_separator``; it takes precedence over the
    pinned/derived defaults everywhere (host pwg, Brillig VM blackboxes, and
    the device MSM tables, which are built from ``derive_generator``).
    Pass an empty table to clear the domain.  Points are checked to lie on
    Grumpkin unless ``validate=False``.

    Staleness: a ``BatchSolver`` built BEFORE this call has baked device MSM
    window tables from the previous table.  It remembers the points it was
    built from, and its ``solve()`` raises ``RuntimeError`` once they differ
    from what ``derive_generator`` returns: rebuild the plan and the solver
    after changing generators or the Schnorr challenge hook.
    """
    for key in [k for k in _EXTERNAL_GENERATORS if k[0] == domain_separator]:
        del _EXTERNAL_GENERATORS[key]
    for index, point in enumerate(table):
        x, y = point
        x = getattr(x, "value", x)
        y = getattr(y, "value", y)
        if validate and not grumpkin.is_on_curve((x, y)):
            raise GrumpkinError(
                f"external generator {index} is not on the grumpkin curve"
            )
        _EXTERNAL_GENERATORS[(domain_separator, index)] = (x, y)


def clear_external_generators() -> None:
    _EXTERNAL_GENERATORS.clear()


def derive_generator(domain_separator: int, index: int) -> Tuple[int, int]:
    """Deterministic generator table.

    Externally-injected points (``set_external_generators``) win; then index
    0/1 at domain 0 are the pinned barretenberg points; everything else is
    derived by hashing a domain-separated counter with keccak256 and lifting to
    the curve (increment-until-square, sign from the hash's low bit).
    """
    external = _EXTERNAL_GENERATORS.get((domain_separator, index))
    if external is not None:
        return external
    if domain_separator == 0 and index < len(_PINNED_GENERATORS):
        return _PINNED_GENERATORS[index]
    key = (domain_separator, index)
    cached = _generator_cache.get(key)
    if cached is not None:
        return cached
    # The JAX package's seed string, byte for byte: both packages derive the
    # same generators.
    seed = b"acvm_tpu" b".pedersen.generator" + domain_separator.to_bytes(
        4, "big"
    ) + index.to_bytes(4, "big")
    attempt = 0
    while True:
        h = keccak256(seed + attempt.to_bytes(4, "big"))
        x = int.from_bytes(h, "big") % P
        rhs = (x * x * x - 17) % P
        y = _sqrt_mod_p(rhs)
        if y is not None and y != 0:
            if h[31] & 1:
                y = P - y
            point = (x, y)
            assert grumpkin.is_on_curve(point)
            _generator_cache[key] = point
            return point
        attempt += 1


def pedersen_commit(
    inputs: List[FieldElement], domain_separator: int, *, native: bool = True
) -> Tuple[FieldElement, FieldElement]:
    generators = [derive_generator(domain_separator, i) for i in range(len(inputs))]
    if native:
        from .. import native as lib

        acc = lib.grumpkin_msm(generators, [s.value for s in inputs])
    else:
        acc: Point = None
        for scalar, gen in zip(inputs, generators):
            acc = grumpkin.add(acc, grumpkin.mul(scalar.value, gen))
    if acc is None:
        return FieldElement.zero(), FieldElement.zero()
    return FieldElement(acc[0]), FieldElement(acc[1])


def pedersen_compress(
    inputs: List[FieldElement], domain_separator: int = 0, *, native: bool = True
) -> FieldElement:
    x, _ = pedersen_commit(inputs, domain_separator, native=native)
    return x


# ---------------------------------------------------------------------------
# Schnorr over Grumpkin (BlackBoxFunc::SchnorrVerify)
# ---------------------------------------------------------------------------


# Optional externally-supplied challenge function (r_x, (pub_x, pub_y),
# message) -> int.  Lets deployments that know barretenberg's exact challenge
# construction get bit-exact Schnorr through the host code; when set, the
# planner routes SchnorrVerify gates to host stages (a Python hook cannot run
# inside the device pipeline).
_SCHNORR_CHALLENGE_HOOK = None


def set_schnorr_challenge_hook(fn) -> None:
    global _SCHNORR_CHALLENGE_HOOK
    _SCHNORR_CHALLENGE_HOOK = fn


def schnorr_challenge_hook():
    return _SCHNORR_CHALLENGE_HOOK


def _schnorr_challenge(r_x: int, pub: Tuple[int, int], message: bytes,
                       native: bool = True) -> int:
    if _SCHNORR_CHALLENGE_HOOK is not None:
        return int(_SCHNORR_CHALLENGE_HOOK(r_x, pub, message)) % N
    compressed = pedersen_compress(
        [FieldElement(r_x), FieldElement(pub[0]), FieldElement(pub[1])], native=native
    )
    digest = blake2s(compressed.to_be_bytes() + message)
    return int.from_bytes(digest, "big") % N


def schnorr_verify(
    public_key_x: FieldElement,
    public_key_y: FieldElement,
    signature: bytes,
    message: bytes,
    *,
    native: bool = True,
) -> bool:
    if len(signature) != 64:
        raise GrumpkinError("schnorr signature must be 64 bytes (s || e)")
    pub = (public_key_x.value, public_key_y.value)
    if not grumpkin.is_on_curve(pub):
        return False
    s = int.from_bytes(signature[:32], "big") % N
    e = int.from_bytes(signature[32:], "big") % N
    if s == 0:
        return False
    if native:
        from .. import native as lib

        R = lib.grumpkin_msm([grumpkin.generator(), pub], [s, e])
    else:
        R = grumpkin.lincomb(s, grumpkin.generator(), e, pub)
    if R is None:
        return False
    return _schnorr_challenge(R[0], pub, message, native) == e


def schnorr_sign(private_key: int, message: bytes, nonce: Optional[int] = None) -> bytes:
    """Produce an (s, e) signature verifiable by :func:`schnorr_verify`.

    The nonce defaults to a deterministic RFC6979-flavoured derivation from the
    key and message (blake2s-based).
    """
    private_key %= N
    pub = grumpkin.mul_g(private_key)
    if nonce is None:
        nonce = (
            int.from_bytes(
                blake2s(private_key.to_bytes(32, "big") + message + b"nonce"), "big"
            )
            % N
        )
        nonce = nonce or 1
    R = grumpkin.mul_g(nonce)
    e = _schnorr_challenge(R[0], pub, message)
    s = (nonce - private_key * e) % N
    return s.to_bytes(32, "big") + e.to_bytes(32, "big")


def schnorr_public_key(private_key: int) -> Tuple[FieldElement, FieldElement]:
    point = grumpkin.mul_g(private_key % N)
    return FieldElement(point[0]), FieldElement(point[1])
