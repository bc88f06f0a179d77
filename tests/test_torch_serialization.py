"""The port's ACIR wire format against the reference's pinned bytes and the
JAX package's codec, tolerance 0.

Every golden circuit of ``golden_vectors.py`` (the reference's
gzip(bincode) vectors, acir/tests/test_program_serialization.rs) is read by
``acvm_tpu_torch.acir.serialization`` and written again: the bincode layer
must equal the reference's byte for byte, and the gzip the JAX package's
(both write gzip with mtime 0, so equal bincode gives equal files).  The
witness-map codec, the msgpack + deflate form and the refusal of trailing
bytes are held as ``tests/test_serialization.py`` holds the JAX package's.
"""

import gzip

import pytest

from acvm_tpu.acir import serialization as jser
from acvm_tpu.utils import build_wide_arith_circuit as jax_wide_circuit

from acvm_tpu_torch.acir import Circuit, Witness, WitnessMap
from acvm_tpu_torch.acir import serialization as ser
from acvm_tpu_torch.fields import FieldElement
from acvm_tpu_torch.utils import build_wide_arith_circuit

import golden_vectors as gv

GOLDENS = {
    "addition": gv.ADDITION_CIRCUIT,
    "fixed_base_scalar_mul": gv.FIXED_BASE_SCALAR_MUL_CIRCUIT,
    "pedersen": gv.PEDERSEN_CIRCUIT,
    "schnorr_verify": gv.SCHNORR_VERIFY_CIRCUIT,
    "simple_brillig_foreign_call": gv.SIMPLE_BRILLIG_FOREIGN_CALL,
    "complex_brillig_foreign_call": gv.COMPLEX_BRILLIG_FOREIGN_CALL,
    "memory_op": gv.MEMORY_OP_CIRCUIT,
}

# acvm_js/test/shared/witness_compression.ts: the reference's compressed
# witness map (gzip by flate2) of the solved witnesses below.
REFERENCE_WITNESS = bytes([
    31, 139, 8, 0, 0, 0, 0, 0, 2, 255, 173, 208, 187, 13, 128, 48, 12, 4,
    80, 190, 153, 199, 142, 237, 196, 238, 88, 133, 8, 103, 255, 17, 64,
    34, 5, 61, 62, 233, 164, 171, 94, 113, 105, 122, 51, 63, 61, 198, 134,
    127, 193, 37, 206, 202, 235, 199, 34, 40, 204, 94, 179, 35, 225, 9,
    217, 154, 10, 176, 180, 162, 168, 40, 42, 87, 86, 34, 87, 214, 106,
    205, 42, 24, 50, 57, 118, 49, 234, 3, 219, 2, 173, 61, 240, 175, 20,
    103, 209, 13, 151, 252, 77, 33, 208, 1, 0, 0,
])
MINUS_ONE = "0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000000"
REFERENCE_WITNESS_VALUES = {1: "0x01", 2: "0x02", 3: MINUS_ONE, 4: MINUS_ONE, 5: "0x01", 6: "0x03"}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_circuit_round_trips_byte_for_byte(name):
    golden = GOLDENS[name]
    circuit = ser.deserialize_circuit(golden)
    assert ser.circuit_to_bincode(circuit) == gzip.decompress(golden)
    data = ser.serialize_circuit(circuit)
    assert data == jser.serialize_circuit(jser.deserialize_circuit(golden))
    assert ser.circuit_to_bincode(ser.deserialize_circuit(data)) == gzip.decompress(golden)
    # Circuit.write / read are the same codec.
    assert circuit.write() == data
    assert ser.circuit_to_bincode(Circuit.read(data)) == gzip.decompress(golden)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_msgpack_round_trips_every_golden(name):
    circuit = ser.deserialize_circuit(GOLDENS[name])
    packed = ser.serialize_circuit_msgpack(circuit)
    assert packed == jser.serialize_circuit_msgpack(jser.deserialize_circuit(GOLDENS[name]))
    back = ser.deserialize_circuit_msgpack(packed)
    assert ser.serialize_circuit(back) == ser.serialize_circuit(circuit)
    assert packed != GOLDENS[name]


def test_witness_codec_round_trips_and_reads_the_reference():
    wm = WitnessMap()
    wm.insert(Witness(1), FieldElement(13))
    wm.insert(Witness(9), -FieldElement(1))
    wm.insert(Witness(4), FieldElement(0))
    data = ser.compress_witness(wm)
    assert ser.decompress_witness(data) == wm
    jwm = jser.decompress_witness(data)
    assert jser.compress_witness(jwm) == data
    want = WitnessMap()
    for index, value in REFERENCE_WITNESS_VALUES.items():
        want.insert(Witness(index), FieldElement.from_hex(value))
    assert ser.decompress_witness(REFERENCE_WITNESS) == want
    assert ser.decompress_witness(ser.compress_witness(want)) == want


def test_trailing_bytes_are_refused():
    data = ser.circuit_to_bincode(ser.deserialize_circuit(gv.ADDITION_CIRCUIT)) + b"\x00"
    with pytest.raises(ValueError):
        ser.circuit_from_bincode(data)
    with pytest.raises(ValueError):
        ser.deserialize_circuit(gzip.compress(data))


def test_wide_circuit_serializes_as_the_jax_package_s():
    kw = dict(num_levels=2, gates_per_level=64)
    data = ser.serialize_circuit(build_wide_arith_circuit(**kw))
    assert data == jser.serialize_circuit(jax_wide_circuit(**kw))
    assert ser.serialize_circuit(Circuit.read(data)) == data
