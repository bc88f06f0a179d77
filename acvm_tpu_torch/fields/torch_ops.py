"""Batched prime-field arithmetic on tensors: 8 x 32-bit limbs, Montgomery form.

The compute core of the batched witness solver.  Every op is elementwise over
arbitrary leading batch dimensions with a trailing axis of 8 ``int32`` limbs
(the bit pattern of uint32, little-endian).  Montgomery radix R = 2^256, all
results canonical (< p).

``mont_mul`` and ``mont_inv`` go to the hand-written CUDA kernels for CUDA
tensors and to their plain versions for CPU tensors
(:mod:`acvm_tpu_torch.fields.kernels`).  ``add`` / ``sub`` / ``neg`` and the
predicates are plain tensor ops on either device: they have no kernel in the
JAX package either.

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
        # Moduli >= 2^255 need a ninth limb in add/sub/mul intermediates (the
        # wide mode of the JAX LimbContext): not ported.
        self.wide = 2 * params.modulus >= 1 << 256
        if self.wide:
            raise NotImplementedError(
                f"LimbContext: field {params.name} needs the wide mode "
                "(p >= 2^255), which is not ported"
            )

        def limbs(v: int) -> torch.Tensor:
            return torch.from_numpy(int_to_limbs32(v).copy()).to(self.device)

        self.p_limbs = limbs(params.modulus)
        self.r2_limbs = limbs(params.r2)
        self.one_limbs = limbs(1)
        self.r_limbs = limbs(params.r)
        self.zero_limbs = torch.zeros(LIMBS, dtype=torch.int32, device=self.device)
        self._half = half_field(params, self.device)
        self.inv_exponent = params.modulus - 2

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
        """Inverse in Montgomery form: inv(aR) = a^-1 R, by Fermat
        (a^(p-2)) in one fused power chain.  Zero maps to zero (matching the
        reference FieldElement::inverse)."""
        return kernels.mont_pow(a, self.inv_exponent, self.params)

    def mont_batch_inv(
        self, a: torch.Tensor, axis: int = -2, max_scan: int = 256
    ) -> torch.Tensor:
        """Montgomery's batch-inversion trick along ``axis``: running prefix
        and suffix products amortize ONE Fermat chain over up to ``max_scan``
        values (about 4 multiplies a value instead of 335).  Zero maps to
        zero, matching ``mont_inv``.

        Axes longer than ``max_scan`` are cut into chunks that are inverted
        independently and side by side (the chunks share every launch).  The
        products associate left to right; the result does not depend on the
        association, and every output is canonical."""
        if a.shape[axis] == 1:
            return self.mont_inv(a)
        a_m = torch.movedim(a, axis, 0)  # (G, ..., 8)
        G = a_m.shape[0]
        rest = a_m.shape[1:]
        gc = min(G, max_scan)
        C = -(-G // gc)
        pad = C * gc - G
        if pad:
            one = self.r_limbs.expand((pad,) + rest)
            a_m = torch.cat([a_m, one], dim=0)
        # (C, gc, ...) -> (gc, C, ...): step i of every chunk is one
        # contiguous slab.
        chunks = a_m.reshape((C, gc) + rest).movedim(1, 0).contiguous()
        inv = self._batch_inv_axis0(chunks)
        inv = inv.movedim(0, 1).reshape((C * gc,) + rest)[:G]
        return torch.movedim(inv, 0, axis)

    def _batch_inv_axis0(self, a_m: torch.Tensor) -> torch.Tensor:
        """Batch inversion along axis 0 (the prefix/suffix-product core)."""
        G = a_m.shape[0]
        is_zero = (a_m == 0).all(dim=-1, keepdim=True)
        b = torch.where(is_zero, self.r_limbs, a_m)
        prefix = torch.empty_like(b)
        suffix = torch.empty_like(b)
        prefix[0] = b[0]
        suffix[G - 1] = b[G - 1]
        for i in range(1, G):
            self.mont_mul(prefix[i - 1], b[i], out=prefix[i])
            self.mont_mul(b[G - 1 - i], suffix[G - i], out=suffix[G - 1 - i])
        total_inv = self.mont_inv(prefix[G - 1])  # (..., 8)
        # inv[i] = prefix[i-1] * suffix[i+1] * total_inv  (empty product = one)
        one = self.r_limbs.expand(b.shape[1:])[None]
        pre = torch.cat([one, prefix[:-1]], dim=0)
        suf = torch.cat([suffix[1:], one], dim=0)
        inv = self.mont_mul(self.mont_mul(pre, suf), total_inv[None])
        return torch.where(is_zero, torch.zeros_like(inv), inv)

    # What one sequential kernel launch costs, in Fermat chains: an H100 runs a
    # chain in about 11 ns and Python launches a small kernel in tens of
    # microseconds.
    CHAINS_PER_LAUNCH = 8192

    def mont_inv_grouped(self, a: torch.Tensor, group: int = 32) -> torch.Tensor:
        """Invert a flat (..., n, 8) array by folding its axis -2 into groups
        of g values and amortizing one Fermat chain per group (see
        ``mont_batch_inv``).  g is a power of two that divides n (no padding),
        at most ``group``; any g gives the same bits.

        A group of g spends about 2g sequential multiply launches to save
        n (1 - 1/g) Fermat chains, so the total 2g + n / (g * CHAINS_PER_LAUNCH)
        is least near g = sqrt(n / (2 * CHAINS_PER_LAUNCH)): g doubles only
        while (2g)^2 * CHAINS_PER_LAUNCH <= n, and arrays below 32,768 values
        are inverted directly."""
        if a.dim() < 2:
            return self.mont_inv(a)
        n = a.shape[-2]
        g = 1
        while g < group and n % (g * 2) == 0 and (2 * g) ** 2 * self.CHAINS_PER_LAUNCH <= n:
            g *= 2
        if g == 1:
            return self.mont_inv(a)
        folded = a.reshape(a.shape[:-2] + (n // g, g, LIMBS))
        return self.mont_batch_inv(folded, axis=-2).reshape(a.shape)

    def mont_div(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self.mont_inv(b))

    # ---- predicates ----------------------------------------------------------
    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=-1)

    @staticmethod
    def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=-1)


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
