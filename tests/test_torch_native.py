"""The port's host Grumpkin library (acvm_tpu_torch/native) against the
pure-Python curve code and the JAX package's library (acvm_tpu/native), on
the same inputs, tolerance 0; its window tables against the plain ones and
the JAX package's; the host black boxes with and without it."""

import random

import numpy as np
import pytest

from acvm_tpu import native as jax_native
from acvm_tpu.blackbox import grumpkin as jax_grumpkin
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.tpu import ec as jax_ec
from acvm_tpu_torch import native
from acvm_tpu_torch.blackbox import grumpkin as gk
from acvm_tpu_torch.blackbox.ec import grumpkin
from acvm_tpu_torch.convert import limbs32_to_limbs16
from acvm_tpu_torch.fields import FieldElement
from acvm_tpu_torch.gpu import ec

rng = random.Random(5)
N = grumpkin.params.n
G = grumpkin.generator()


@pytest.fixture(scope="module")
def jax_lib():
    if not jax_native.available():
        pytest.skip("the JAX package's native library cannot be built here")
    return jax_native


def test_mul_matches_python_and_the_jax_library(jax_lib):
    scalars = [rng.randrange(N) for _ in range(6)] + [0, 1, N - 1, N, (1 << 256) - 1]
    for k in scalars:
        want = grumpkin.mul(k % N, G)
        assert native.grumpkin_mul(G, k) == want == jax_lib.grumpkin_mul(G, k), k


def test_mul_golden_vectors():
    # scalar 1 -> generator (barretenberg scalar_mul.rs:76-84)
    assert native.grumpkin_mul(G, 1) == G
    p = native.grumpkin_mul(G, 1 + 2 * (1 << 128))
    assert p[0] == 0x0702AB9C7038EEECC179B4F209991BCB68C7CB05BF4C532D804CCAC36199C9A9
    assert p[1] == 0x23F10E9E43A3AE8D75D24154E796AAE12AE7AF546716E8F81A2564F1B5814130


def test_add_and_infinity(jax_lib):
    p = grumpkin.mul(12345, G)
    q = grumpkin.mul(67890, G)
    for a, b in ((p, q), (p, p), (p, grumpkin.neg(p)), (None, p), (p, None), (None, None)):
        assert native.grumpkin_add(a, b) == grumpkin.add(a, b) == jax_lib.grumpkin_add(a, b)
    assert native.grumpkin_add(p, grumpkin.neg(p)) is None
    assert native.grumpkin_mul(G, 0) is None


def test_msm_and_mul_batch(jax_lib):
    points = [grumpkin.mul(rng.randrange(N), G) for _ in range(5)] + [None]
    scalars = [rng.randrange(N) for _ in range(5)] + [7]
    expected = None
    for p, s in zip(points, scalars):
        expected = grumpkin.add(expected, grumpkin.mul(s, p))
    assert native.grumpkin_msm(points, scalars) == expected == jax_lib.grumpkin_msm(points, scalars)
    assert native.grumpkin_msm([], []) is None
    batch = [rng.randrange(N) for _ in range(6)] + [0, N]
    got = native.grumpkin_mul_batch(G, batch)
    assert got == [grumpkin.mul(k % N, G) for k in batch] == jax_lib.grumpkin_mul_batch(G, batch)
    with pytest.raises(ValueError):
        native.grumpkin_msm(points, scalars[:2])


@pytest.mark.parametrize("windows", [8, 64])
def test_window_table_equals_plain_and_the_jax_package_s(windows):
    base = gk.derive_generator(0, 1)
    table = ec._window_table_np(base, windows)
    assert np.array_equal(table, ec._window_table_np(base, windows, native=False))
    jax_table = jax_ec._window_table_np(base, windows)  # (W, 16, 3, 16) uint32
    assert np.array_equal(limbs32_to_limbs16(table.reshape(-1, 8)).reshape(jax_table.shape),
                          jax_table)


def test_host_black_boxes_with_and_without_the_library():
    low, high = FieldElement(1 + rng.randrange(1 << 128)), FieldElement(rng.randrange(1 << 120))
    want = jax_grumpkin.fixed_base_scalar_mul(JFieldElement(low.value), JFieldElement(high.value))
    for use in (True, False):
        got = gk.fixed_base_scalar_mul(low, high, native=use)
        assert (got[0].value, got[1].value) == (want[0].value, want[1].value)
    inputs = [FieldElement(rng.randrange(grumpkin.params.p)) for _ in range(3)]
    want = jax_grumpkin.pedersen_commit([JFieldElement(v.value) for v in inputs], 0)
    for use in (True, False):
        got = gk.pedersen_commit(inputs, 0, native=use)
        assert (got[0].value, got[1].value) == (want[0].value, want[1].value)
    key = rng.randrange(1, N)
    pub = gk.schnorr_public_key(key)
    message = b"the port's host library"
    signature = gk.schnorr_sign(key, message)
    forged = signature[:31] + bytes([signature[31] ^ 1]) + signature[32:]
    for sig, valid in ((signature, True), (forged, False)):
        assert jax_grumpkin.schnorr_verify(
            JFieldElement(pub[0].value), JFieldElement(pub[1].value), sig, message) is valid
        for use in (True, False):
            assert gk.schnorr_verify(pub[0], pub[1], sig, message, native=use) is valid


def test_a_failed_build_raises_with_the_compiler_s_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*broken.cc.*error"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
