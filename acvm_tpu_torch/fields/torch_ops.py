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
    add_half,
    carry_half,
    cond_sub_half,
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
        self._p_half = split_half(self.p_limbs)
        self.inv_exponent = params.modulus - 2

    # ---- modular add / sub --------------------------------------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return join_half(add_half(split_half(a), split_half(b), self._p_half))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        # a - b + p lies in (0, 2p): signed carries, then one conditional
        # subtract.
        s = carry_half(split_half(a) - split_half(b) + self._p_half)
        return join_half(cond_sub_half(s, self._p_half))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        # p - a, with p - 0 = p mapped back to 0 by the conditional subtract.
        s = carry_half(self._p_half - split_half(a))
        return join_half(cond_sub_half(s, self._p_half))

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

    # ---- predicates ----------------------------------------------------------
    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=-1)

    @staticmethod
    def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=-1)
