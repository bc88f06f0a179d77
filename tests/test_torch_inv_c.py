"""The C of the divstep inversion (``csrc/inv.cu``), run on the CPU.

``csrc/inv.cu`` (with ``inv.cuh``, plain C++ on int32_t / int64_t) is compiled
with g++ against the stub ``cuda_runtime.h`` of ``tests/test_torch_hash_c.py``,
whose ``INV_LAUNCH`` is a host loop over the grid's one-warp blocks and their
32 threads, and its launcher is called on host memory.  On the four wide
moduli and BN254's r, over the cases of ``tests/test_torch_inv.py`` (edge
lanes, the longest divstep run among seeded draws, random values) and a
ragged count, it equals Python's ints and the plain version.  The card runs
the kernel in ``tests/test_torch_gpu.py``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import pytest
import torch

from acvm_tpu_torch import build
from acvm_tpu_torch.fields import kernels as fk
from test_torch_hash_c import STUB
from test_torch_inv import FIELDS, IDS, as_limbs, inv_cases, inverses


@pytest.fixture(scope="module")
def inv_c(tmp_path_factory):
    """The C launcher of a CPU build of csrc/inv.cu."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("inv_c")
    (out / "cuda_runtime.h").write_text(STUB)
    lib = out / "inv.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++", "-I", str(out),
                    "-o", str(lib), str(build.source_path("inv_wide"))],
                   check=True, capture_output=True, text=True)
    symbol, argtypes = build._SIGNATURES["inv_wide"]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


@pytest.mark.parametrize("params", FIELDS, ids=IDS)
def test_inv_c_equals_ints_and_plain_version(inv_c, params):
    xs = inv_cases(params)[:70]  # 70 values: two whole blocks of 32 and a ragged third
    a = as_limbs(xs)
    out = torch.full_like(a, -1)
    assert inv_c(a.data_ptr(), out.data_ptr(), len(xs), fk._host_ptr(fk.inv_constants(params)), None) == 0
    assert fk.limbs32_to_ints(out.numpy()) == inverses(xs, params)
    assert torch.equal(out, fk.mont_inv_divsteps_plain(a, params))
    # in place (out aliases a), and n = 0 launches nothing
    assert inv_c(a.data_ptr(), a.data_ptr(), len(xs), fk._host_ptr(fk.inv_constants(params)), None) == 0
    assert torch.equal(a, out)
    assert inv_c(a.data_ptr(), a.data_ptr(), 0, fk._host_ptr(fk.inv_constants(params)), None) == 0
