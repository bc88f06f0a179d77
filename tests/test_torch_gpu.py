"""The port's kernels against their plain versions on the card.

The CPU tests reach only the plain versions; these run the CUDA kernels, so
they carry the ``gpu`` marker and skip where there is no CUDA device.  They
import nothing of JAX:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from acvm_tpu_torch import build
from acvm_tpu_torch.fields import kernels as fk
from acvm_tpu_torch.fields.params import BLS12_381_FR, BN254_FR
from acvm_tpu_torch.gpu import BatchSolver, plan_circuit
from acvm_tpu_torch.utils import build_wide_arith_circuit, random_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def elements(n, params, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % params.modulus for _ in range(n)]
    vals[:3] = [0, 1, params.modulus - 1]
    return torch.from_numpy(fk.ints_to_limbs32(vals).copy())


@pytest.mark.parametrize("dyn_fraction", [0.0, 0.5])
def test_solver_on_card_equals_solver_on_cpu(card, dyn_fraction):
    circuit = build_wide_arith_circuit(num_inputs=8, num_levels=3, gates_per_level=64,
                                       dyn_fraction=dyn_fraction)
    inputs = random_inputs(circuit, 100)  # a ragged batch: not a multiple of the block
    inputs[7] = {w: 0 for w in inputs[7]}  # every runtime denominator vanishes
    plan = plan_circuit(circuit)
    build.reset_launches()
    gpu = BatchSolver(plan).solve(inputs)
    wanted = ("level", "mul", "pow", "dot") if dyn_fraction else ("level",)
    assert all(build.LAUNCHES[k] > 0 for k in wanted), build.LAUNCHES
    cpu = BatchSolver(plan, device="cpu").solve(inputs)
    assert torch.equal(gpu.panel.cpu(), cpu.panel)
    assert np.array_equal(gpu.ok, cpu.ok) and np.array_equal(gpu.fail, cpu.fail)
    assert bool(gpu.ok[7]) == (dyn_fraction == 0.0)


@pytest.mark.parametrize("params", [BN254_FR, BLS12_381_FR], ids=lambda p: p.name)
def test_field_kernels_equal_plain_versions(card, params):
    a, b = elements(1000, params, 1), elements(1000, params, 2)
    for reduce in (True, False):
        assert torch.equal(fk.mont_mul(a.to(card), b.to(card), params, reduce=reduce).cpu(),
                           fk.mont_mul_plain(a, b, params, reduce))
    assert torch.equal(fk.mont_mul(a.to(card), b[5].to(card), params).cpu(),
                       fk.mont_mul_plain(a, b[5], params))
    for exponent in (0, 12345, params.modulus - 2, (1 << 256) - 1):
        assert torch.equal(fk.mont_pow(a[:70].to(card), exponent, params).cpu(),
                           fk.mont_pow_plain(a[:70], exponent, params))


@pytest.mark.parametrize("t1,t2,with_scale", [(1, 0, False), (0, 1, True), (3, 2, True), (19, 0, False)])
def test_dot_kernel_equals_plain_version(card, t1, t2, with_scale):
    E, B = 5, 70
    p = BN254_FR

    def rand(shape, seed):
        t = elements(int(np.prod(shape)), p, seed).reshape(*shape, 8)
        return t

    lv = rand((E, t1, B), 3) if t1 else None
    lc = rand((E, t1), 4) if t1 else None
    m1 = rand((E, t2, B), 5) if t2 else None
    m2 = rand((E, t2, B), 6) if t2 else None
    mc = rand((E, t2), 7) if t2 else None
    if t1 > 1:
        lc[2, 1] = 0  # a padding term
    qc = rand((E,), 8)
    sc = rand((E,), 9) if with_scale else None
    dev = lambda t: None if t is None else t.to(card)
    got = fk.mont_dot(dev(lv), dev(lc), dev(m1), dev(m2), dev(mc), dev(qc), dev(sc), p)
    assert torch.equal(got.cpu(), fk.mont_dot_plain(lv, lc, m1, m2, mc, qc, sc, p))


def test_level_kernel_equals_plain_version_at_wide_gates(card):
    """Gates of 15-32 linear terms at p - 1 (where a lazy one-chain sum would
    overflow), a product term, padding terms and a ragged batch."""
    from acvm_tpu_torch.gpu import fused_level as fl

    p = BN254_FR.modulus
    NW, B, t1, t2 = 60, 70, 32, 1
    panel = elements(NW * B, BN254_FR, 11).reshape(NW, B, 8)
    panel[1:21] = torch.from_numpy(fk.ints_to_limbs32([p - 1] * (20 * B)).copy()).reshape(20, B, 8)
    E = 5
    lin_idx = np.zeros((E, t1), np.int32)
    lin_c = np.zeros((E, t1), dtype=object)
    for g, n in enumerate((15, 18, 19, 32, 2)):
        lin_idx[g, :n] = 1 + np.arange(n) % 20
        lin_c[g, :n] = p - 1
    mul_idx = np.array([[[3, 30]], [[0, 0]], [[31, 32]], [[0, 0]], [[33, 34]]], np.int32)
    mul_c = np.array([[p - 1], [0], [12345], [0], [p - 2]], dtype=object)
    num = dict(
        lin_idx=lin_idx, mul_idx=mul_idx,
        lin_coeff=fk.ints_to_limbs32(lin_c.reshape(-1)).reshape(E, t1, 8),
        mul_coeff=fk.ints_to_limbs32(mul_c.reshape(-1)).reshape(E, t2, 8),
        qc=fk.ints_to_limbs32([p - 1] * E),
    )
    desc = torch.from_numpy(fl.pack_level_desc(dict(num=num, u_idx=np.arange(40, 40 + E, dtype=np.int32))))
    want = fl.fused_level_plain(panel.clone(), desc, BN254_FR, t1, t2)
    got = fl.fused_level_call(panel.to(card), desc.to(card), BN254_FR, t1, t2)
    assert torch.equal(got.cpu(), want)
