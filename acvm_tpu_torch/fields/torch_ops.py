"""Batched prime-field arithmetic on tensors: 8 x 32-bit limbs, Montgomery form.

The compute core of the batched witness solver.  Every op is elementwise over
arbitrary leading batch dimensions with a trailing axis of 8 ``int32`` limbs
(the bit pattern of uint32, little-endian).  Montgomery radix R = 2^256, all
results canonical (< p).

``mont_mul``, ``mont_inv`` and ``mont_batch_inv`` go to the hand-written CUDA
kernels for CUDA tensors and to their plain versions for CPU tensors
(:mod:`acvm_tpu_torch.fields.kernels`).  ``add`` / ``sub`` / ``neg`` and the
predicates are plain tensor ops on either device: they have no kernel in the
JAX package either.

A field with 2p >= 2^256 (the secp256k1 / secp256r1 base fields and group
orders of the ECDSA gadgets) runs in *wide* mode, as the JAX ``LimbContext``
does: its sums and products carry a ninth word, and its kernels are the
``*_wide`` builds (:func:`acvm_tpu_torch.fields.kernels.is_wide`).

Semantics mirror the host ``FieldElement``
(:mod:`acvm_tpu_torch.fields.field`), the bit-exactness oracle.
"""

from __future__ import annotations

import torch

from . import kernels
from .kernels import (
    LIMBS,
    half_field,
    int_to_limbs32,
    join_half,
    split_half,
)
from .params import FieldParams, BN254_FR


class LimbContext:
    """Constants of one field on one device (modulus, Montgomery R and R^2,
    the inversion exponent) and the field ops over limb tensors."""

    def __init__(self, params: FieldParams = BN254_FR, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LimbContext: device 'cuda' requested but no CUDA device is "
                "available (pass device='cpu' for the plain versions)"
            )
        # Moduli >= 2^255 need a ninth limb in add/sub/mul intermediates: the
        # wide mode, which picks the *_wide kernels.
        self.wide = kernels.is_wide(params)

        def limbs(v: int) -> torch.Tensor:
            return torch.from_numpy(int_to_limbs32(v).copy()).to(self.device)

        self.p_limbs = limbs(params.modulus)
        self.r2_limbs = limbs(params.r2)
        self.one_limbs = limbs(1)
        self.r_limbs = limbs(params.r)
        self.zero_limbs = torch.zeros(LIMBS, dtype=torch.int32, device=self.device)
        self._half = half_field(params, self.device)

    # ---- modular add / sub --------------------------------------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return join_half(self._half.add(split_half(a), split_half(b)))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return join_half(self._half.sub(split_half(a), split_half(b)))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        # 0 - a: zero stays zero, anything else becomes p - a.
        return self.sub(torch.zeros_like(a), a)

    # ---- Montgomery multiply ------------------------------------------------
    def mont_mul(self, a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
        """(a * b * R^-1) mod p for a, b < p in limb form."""
        return kernels.mont_mul(a, b, self.params, out=out)

    def mont_sq(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, a)

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self.r2_limbs)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self.one_limbs)

    # ---- inversion ----------------------------------------------------------
    def mont_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Inverse in Montgomery form: inv(aR) = a^-1 R.  Zero maps to zero
        (matching the reference FieldElement::inverse).  A narrow field runs
        Fermat (a^(p-2)) in one fused power chain, a wide one constant-time
        divsteps (:func:`kernels.mont_inv`: ``inv_wide``)."""
        return kernels.mont_inv(a, self.params)

    def mont_batch_inv(
        self, a: torch.Tensor, axis: int = -2, max_scan: int = 256
    ) -> torch.Tensor:
        """Montgomery's batch-inversion trick along ``axis``: running products
        amortize ONE Fermat chain over up to ``max_scan`` values (about 3
        products a value instead of 311).  Zero maps to zero, matching
        ``mont_inv``; any chunking gives the same bits.  One ``batch_inv``
        launch on CUDA tensors (:func:`kernels.mont_batch_inv`)."""
        return kernels.mont_batch_inv(a, self.params, axis, max_scan)

    # Lanes (chunks) from which folding pays: on one `batch_inv` launch of n
    # values in chunks of g (a Fermat chain a block of chunks), n / g = 2^14 to
    # 2^15 lanes was the best split at every n from 2^16 to 2^20 measured, and
    # at n = 2^14 the pow kernel beat every split (0.173 ms against 0.196 at
    # g = 4; at 2^16 0.400 against 0.197; `chip_smoke.py --fold-sweep`, H100).
    # The gadget paths' affine conversions (2,048-16,384 values) stay below
    # 2^15 and call the pow kernel directly.
    FOLD_LANES = 1 << 14
    # A wide field inverts by divsteps (``inv_wide``: ~0.02 ms of a lone
    # warp's latency up to ~2^15 values, then ~0.9 ns a value), while the fold
    # still runs a Fermat chain a block of chunks (``batch_inv_wide``,
    # 0.16-0.21 ms whatever the split up to 2^17 values).  `inv_wide` beat
    # every split through 2^17 values (0.120 ms against 0.171 at g = 8) and
    # lost from 2^18 (0.233 against 0.183 at g = 8; at 2^20 0.889 against
    # 0.237 at g = 32; `chip_smoke.py --fold-sweep`, H100, secp256k1 p), so
    # a wide field folds from 2^18 values; the ECDSA paths (8,192-32,768
    # values a call) do not.
    FOLD_FROM_WIDE = 1 << 18

    def fold_rows(self, n: int, group: int = 32) -> int:
        """The rows g that :meth:`mont_inv_grouped` folds n values into (1:
        none).  g is a power of two that divides n (no padding), at most
        ``group``, and doubles only while n / (2g) >= FOLD_LANES: while the
        n / g chunks fill the card the launch is bound by the products; below
        that a chain's depth sets the time, which folding only lengthens.  A
        wide field folds nothing below FOLD_FROM_WIDE values."""
        if self.wide and n < self.FOLD_FROM_WIDE:
            return 1
        g = 1
        while g < group and n % (g * 2) == 0 and n // (g * 2) >= self.FOLD_LANES:
            g *= 2
        return g

    def mont_inv_grouped(self, a: torch.Tensor, group: int = 32) -> torch.Tensor:
        """Invert every value of ``a`` (any shape (..., 8)), folding them into
        :meth:`fold_rows` groups along a new leading axis and amortizing one
        Fermat chain per chunk of g (see ``mont_batch_inv``), or, with no
        fold, by :meth:`mont_inv` directly; any g gives the same bits.
        Folding turns n inversions into 3n products and a chain a block of
        chunks (``kernels.batch_inv_plan``) in one launch."""
        n = a.numel() // LIMBS
        g = self.fold_rows(n, group)
        if g == 1:
            return self.mont_inv(a)
        folded = a.reshape(g, n // g, LIMBS)
        return self.mont_batch_inv(folded, axis=0, max_scan=g).reshape(a.shape)

    def mont_div(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self.mont_inv(b))

    # ---- predicates ----------------------------------------------------------
    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=-1)

    @staticmethod
    def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=-1)

    # ---- bit views (range checks) -------------------------------------------
    @staticmethod
    def num_bits_leq(a: torch.Tensor, num_bits: int) -> torch.Tensor:
        """value < 2^num_bits, elementwise (the RANGE constraint)."""
        full, rem = divmod(num_bits, 32)
        ok = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
        if full < LIMBS:
            start = full
            if rem:
                ok = ok & ((a[..., full].to(torch.int64) & 0xFFFFFFFF) < (1 << rem))
                start += 1
            if start < LIMBS:
                ok = ok & (a[..., start:] == 0).all(dim=-1)
        return ok

    @staticmethod
    def mask_bits(a: torch.Tensor, num_bits: int) -> torch.Tensor:
        """a mod 2^num_bits on limbs."""
        full, rem = divmod(num_bits, 32)
        mask = [-1 if i < full else 0 for i in range(LIMBS)]
        if rem and full < LIMBS:
            mask[full] = (1 << rem) - 1
        return a & torch.tensor(mask, dtype=torch.int32, device=a.device)


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b on (..., 8) limb arrays read as 256-bit unsigned integers
    (broadcasts).  The most significant limb in which they differ decides."""
    a, b = torch.broadcast_tensors(a, b)
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    weight = torch.arange(1, LIMBS + 1, dtype=torch.int64, device=a.device)
    top = ((ua != ub) * weight).amax(dim=-1, keepdim=True)  # 0 where equal
    pick = (top - 1).clamp(min=0)
    return ((top == 0) | (ua.gather(-1, pick) > ub.gather(-1, pick)))[..., 0]
