from .bench_circuits import (
    build_gadget_circuit,
    build_wide_arith_circuit,
    columnar_instance,
    gadget_inputs,
    gadget_inputs_columnar,
    random_inputs,
    with_repeated_constraints,
)

__all__ = [
    "build_gadget_circuit",
    "build_wide_arith_circuit",
    "columnar_instance",
    "gadget_inputs",
    "gadget_inputs_columnar",
    "random_inputs",
    "with_repeated_constraints",
]
