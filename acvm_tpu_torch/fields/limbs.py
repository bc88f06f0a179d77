"""Host-side packing between Python field integers and device limb tensors.

Interchange representation: little-endian 16x16-bit limbs held in uint32
(`acvm_tpu_torch.fields.params.LIMB_BITS/NUM_LIMBS`).  Device tensors pack two
of these into one 32-bit limb (`acvm_tpu_torch.fields.torch_ops`).
"""

from __future__ import annotations

import numpy as np

from .params import FieldParams, BN254_FR, LIMB_BITS, NUM_LIMBS

_MASK = (1 << LIMB_BITS) - 1


def ints_to_limbs(values, dtype=np.uint32) -> np.ndarray:
    """Pack an iterable of Python ints into an (N, NUM_LIMBS) array."""
    values = list(values)
    out = np.zeros((len(values), NUM_LIMBS), dtype=dtype)
    for row, v in enumerate(values):
        v = int(v)
        for i in range(NUM_LIMBS):
            out[row, i] = (v >> (LIMB_BITS * i)) & _MASK
    return out


def int_to_limbs(value: int, dtype=np.uint32) -> np.ndarray:
    return ints_to_limbs([value], dtype=dtype)[0]


def limbs_to_ints(arr: np.ndarray) -> list[int]:
    """Unpack (..., NUM_LIMBS) limb array into Python ints (flattened rows)."""
    arr = np.asarray(arr)
    flat = arr.reshape(-1, arr.shape[-1])
    out = []
    for row in flat:
        acc = 0
        for i in range(arr.shape[-1]):
            acc |= int(row[i]) << (LIMB_BITS * i)
        out.append(acc)
    return out


def limbs_to_int(arr: np.ndarray) -> int:
    return limbs_to_ints(arr)[0]
