"""The port's backend-targeting compiler and stdlib fallbacks against the JAX
package's, tolerance 0.

Each circuit is built by both packages from the same seed, compiled by both
``compile`` functions, and serialized: the port's bytes must equal the JAX
package's, and so must the transformation maps and the remapped assert
messages.  Covered: a small wide arithmetic circuit under ``PLONKCSat(3)``,
``PLONKCSat(4)`` and ``R1CS``; the three hash gadgets over 8 bytes with their
black boxes refused (the SHA-256, BLAKE2s and Keccak-256 fallbacks); an
AND / XOR / Range circuit with its black boxes refused (the logic
fallbacks); ``UnsupportedBlackBox`` raised alike.  Then one compiled BLAKE2s
fallback is solved by the port's ``BatchSolver`` on the CPU: its digests
equal hashlib's and its witnesses the port's sequential engine.
"""

import hashlib
import types

import numpy as np
import pytest

from acvm_tpu import acir as jacir
from acvm_tpu import compiler as jcompiler
from acvm_tpu import stdlib as jstdlib
from acvm_tpu.acir import opcodes as jops
from acvm_tpu.acir.serialization import serialize_circuit as jserialize
from acvm_tpu.fields import FieldElement as JFieldElement
from acvm_tpu.utils import bench_circuits as jbench

from acvm_tpu_torch import acir, compiler, stdlib
from acvm_tpu_torch.acir import opcodes as ops
from acvm_tpu_torch.acir.serialization import serialize_circuit
from acvm_tpu_torch.blackbox import GrumpkinSolver
from acvm_tpu_torch.config import EngineConfig
from acvm_tpu_torch.fields import FieldElement
from acvm_tpu_torch.gpu import BatchSolver, plan_circuit
from acvm_tpu_torch.pwg import ACVM, ACVMStatus
from acvm_tpu_torch.utils import bench_circuits as bench

PORT = types.SimpleNamespace(acir=acir, ops=ops, FieldElement=FieldElement, compiler=compiler,
                             bench=bench, serialize=serialize_circuit)
JAX = types.SimpleNamespace(acir=jacir, ops=jops, FieldElement=JFieldElement, compiler=jcompiler,
                            bench=jbench, serialize=jserialize)

HASH_CALLS = ("BBSha256", "BBBlake2s", "BBKeccak256", "BBKeccak256VariableLength",
              "BBHashToField128Security")


def refusing(lib, names):
    """is_opcode_supported refusing the black boxes of these classes."""
    refused = tuple(getattr(lib.ops, n) for n in names)
    return lambda op: not (isinstance(op, lib.ops.OpcodeBlackBoxFuncCall)
                           and isinstance(op.call, refused))


def logic_circuit(lib):
    """AND and XOR of two 32-bit and two 8-bit inputs, a Range of the AND,
    an arithmetic gate over both outputs with an assert message."""
    W, o = lib.acir.Witness, lib.ops
    opcodes = [
        o.OpcodeBlackBoxFuncCall(o.BBAnd(o.FunctionInput(W(1), 32), o.FunctionInput(W(2), 32), W(5))),
        o.OpcodeBlackBoxFuncCall(o.BBXor(o.FunctionInput(W(3), 8), o.FunctionInput(W(4), 8), W(6))),
        o.OpcodeBlackBoxFuncCall(o.BBRange(o.FunctionInput(W(5), 16))),
        o.OpcodeArithmetic(lib.acir.Expression.from_witness(W(5))
                           + lib.acir.Expression.from_witness(W(6))
                           - lib.acir.Expression.from_witness(W(7))),
    ]
    return lib.acir.Circuit(
        current_witness_index=7, opcodes=opcodes,
        private_parameters={W(i) for i in range(1, 5)},
        assert_messages=[(lib.acir.OpcodeLocation.acir(3), "sum of the logic outputs")])


def compiled_both(build, language, supported=None, **kw):
    out = []
    for lib in (PORT, JAX):
        is_supported = supported(lib) if supported else (lambda op: True)
        out.append(lib.compiler.compile(build(lib), language(lib), is_supported, **kw))
    return out


def assert_equal_compiles(port, jax):
    (c, cmap), (jc, jmap) = port, jax
    assert serialize_circuit(c) == jserialize(jc)
    assert cmap.acir_opcode_positions == jmap.acir_opcode_positions
    assert [(str(loc), m) for loc, m in c.assert_messages] == \
        [(str(loc), m) for loc, m in jc.assert_messages]


LANGUAGES = {
    "csat3": lambda lib: lib.compiler.PLONKCSat(3),
    "csat4": lambda lib: lib.compiler.PLONKCSat(4),
    "r1cs": lambda lib: lib.compiler.R1CS(),
}


@pytest.mark.parametrize("language", sorted(LANGUAGES))
def test_wide_circuit_compiles_as_the_jax_package_s(language):
    build = lambda lib: lib.bench.build_wide_arith_circuit(  # noqa: E731
        num_inputs=8, num_levels=2, gates_per_level=64, seed=5)
    assert_equal_compiles(*compiled_both(build, LANGUAGES[language]))


@pytest.mark.parametrize("kind", ["sha256", "blake2s", "keccak256"])
def test_hash_fallbacks_compile_as_the_jax_package_s(kind):
    port, jax = compiled_both(lambda lib: lib.bench.build_gadget_circuit(kind, 1, 8),
                              LANGUAGES["csat3"], lambda lib: refusing(lib, HASH_CALLS))
    assert len(port[0].opcodes) > 1000
    assert_equal_compiles(port, jax)


def test_logic_fallbacks_compile_as_the_jax_package_s():
    port, jax = compiled_both(logic_circuit, LANGUAGES["csat3"],
                              lambda lib: refusing(lib, ("BBAnd", "BBXor", "BBRange")))
    assert not any(isinstance(op, ops.OpcodeBlackBoxFuncCall) for op in port[0].opcodes)
    assert_equal_compiles(port, jax)


def test_unsupported_black_boxes_raise_alike():
    pedersen = lambda lib: lib.bench.build_gadget_circuit("pedersen", 1)  # noqa: E731
    for lib in (PORT, JAX):
        with pytest.raises(lib.compiler.UnsupportedBlackBox) as exc:
            lib.compiler.compile(pedersen(lib), lib.compiler.PLONKCSat(3),
                                 refusing(lib, ("BBPedersen",)))
        if lib is PORT:
            port_message = str(exc.value)
        else:
            assert str(exc.value) == port_message
    sha = lambda lib: lib.bench.build_gadget_circuit("sha256", 1, 8)  # noqa: E731
    for lib in (PORT, JAX):
        with pytest.raises(lib.compiler.UnsupportedBlackBox):
            lib.compiler.compile(sha(lib), lib.compiler.PLONKCSat(3), refusing(lib, HASH_CALLS),
                                 enable_hash_fallbacks=False)
    with pytest.raises(compiler.UnsupportedBlackBox):
        EngineConfig(enable_hash_fallbacks=False).compile(sha(PORT), refusing(PORT, HASH_CALLS))


def test_stdlib_exports_the_jax_package_s_names():
    assert stdlib.__all__ == jstdlib.__all__
    for name in ("and_", "xor", "range_"):
        assert getattr(stdlib, name).__name__ == getattr(jstdlib, name).__name__


def test_compiled_blake2s_fallback_solves_on_the_cpu():
    """The compiled BLAKE2s fallback over 8 bytes (16,777 opcodes: Brillig
    hints, Quotient and Range levels) by the port's BatchSolver on the CPU at
    B = 2: each instance's digest equals hashlib's, and its witness map the
    port's sequential engine's."""
    circuit = bench.build_gadget_circuit("blake2s", 1, 8)
    compiled, _ = EngineConfig(device="cpu").compile(circuit, refusing(PORT, HASH_CALLS))
    call = circuit.opcodes[0].call
    ins = [int(fi.witness) for fi in call.inputs]
    outs = [int(w) for w in call.outputs]
    msgs = np.random.default_rng(17).integers(0, 256, size=(2, 8))
    inputs = [{w: int(b) for w, b in zip(ins, m)} for m in msgs]
    res = BatchSolver(plan_circuit(compiled), device="cpu").solve(inputs)
    assert res.ok.all()
    digests = [res.witness_ints(w) for w in outs]
    for b, m in enumerate(msgs):
        assert bytes(d[b] for d in digests) == hashlib.blake2s(bytes(m.tolist())).digest()
        wm = acir.WitnessMap({acir.Witness(w): FieldElement(v) for w, v in inputs[b].items()})
        acvm = ACVM(GrumpkinSolver(), compiled.opcodes, wm)
        assert acvm.solve() == ACVMStatus.SOLVED
        want = {int(w): int(v) for w, v in acvm.finalize()}
        got = res.instance_ints(b)
        assert {w: got[w] for w in want} == want
