from .bench_circuits import build_wide_arith_circuit, random_inputs

__all__ = ["build_wide_arith_circuit", "random_inputs"]
