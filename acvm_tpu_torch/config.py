"""Engine configuration.

The reference's knobs are cargo features plus the (Language, width,
is_opcode_supported) triple fed to ``compiler::compile``.  Here they are one
explicit object covering field choice, compile target, the device, and
kernel/fallback policy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .fields.params import FieldParams, get_field


@dataclass
class EngineConfig:
    # Field: "bn254" (default) or "bls12_381", mirroring the cargo features.
    # Both run on the device; another name raises ValueError when used.
    field: str = "bn254"

    # Compile target: "plonk-csat" with `width`, or "r1cs" (passthrough).
    language: str = "plonk-csat"
    width: int = 3

    # The device the solver runs on: "cuda" (default) or "cpu", where each
    # kernel's plain PyTorch version runs.
    device: str = "cuda"

    # Mesh: axis sizes for (data,), instance data parallelism over several
    # distinct devices of this process (``make_mesh``); None = one device.
    # Multi-process jobs build their mesh with parallel.distributed.
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axis_names: Tuple[str, ...] = ("data",)

    # Kernel selection: allow disabling device gadget kernels (forcing the
    # host-stage path) for debugging/conformance bisection.
    device_hash_kernels: bool = True
    device_brillig_trace: bool = True

    # Fallback policy: expand unsupported black-box calls into gates at compile
    # time (the reference gates hash fallbacks behind `unstable-fallbacks`).
    enable_hash_fallbacks: bool = True

    # Pedersen generator escape hatch: an externally-supplied table of (x, y)
    # points for domain_separator 0 (docs/pedersen_compat.md: barretenberg's
    # derivation is sealed inside its WASM binary; deployments that hold the
    # real table inject it here and get bit-exact commitments).  Applied via
    # blackbox.grumpkin.set_external_generators the first time this config
    # builds a plan or solver.
    pedersen_generators: Optional[Tuple[Tuple[int, int], ...]] = None

    def field_params(self) -> FieldParams:
        return get_field(self.field)

    def language_object(self):
        from .compiler import PLONKCSat, R1CS

        if self.language == "r1cs":
            return R1CS()
        if self.language == "plonk-csat":
            return PLONKCSat(self.width)
        raise ValueError(f"unknown language {self.language!r}")

    # -- construction hub -----------------------------------------------------
    def compile(self, circuit, is_opcode_supported=None):
        """Run the backend-targeting compiler under this config (language,
        width, hash-fallback policy)."""
        from .compiler import compile as acvm_compile, default_is_opcode_supported

        language = self.language_object()
        if is_opcode_supported is None:
            is_opcode_supported = default_is_opcode_supported(language)
        return acvm_compile(
            circuit,
            language,
            is_opcode_supported,
            enable_hash_fallbacks=self.enable_hash_fallbacks,
        )

    def _apply_generators(self):
        # Config-installed tables are tracked so that using a config WITHOUT
        # an injected table clears a table a previous config installed (the
        # module-global external-generator store would otherwise leak across
        # EngineConfigs).  Tables installed directly through
        # blackbox.grumpkin.set_external_generators are left alone.
        global _GENERATORS_FROM_CONFIG
        from .blackbox.grumpkin import set_external_generators

        if self.pedersen_generators is not None:
            set_external_generators(self.pedersen_generators)
            _GENERATORS_FROM_CONFIG = True
        elif _GENERATORS_FROM_CONFIG:
            set_external_generators(())
            _GENERATORS_FROM_CONFIG = False

    def plan(self, circuit, input_witnesses=None):
        from .gpu.planner import plan_circuit

        self._apply_generators()
        return plan_circuit(circuit, input_witnesses, config=self)

    def make_mesh(self):
        """The :class:`~acvm_tpu_torch.parallel.Mesh` that ``mesh_shape``
        describes over this config's distinct visible devices (``cuda:0``,
        ``cuda:1``, ...; the CPU is one device), or None.  Raises
        ``ValueError`` where there are fewer devices than entries."""
        if self.mesh_shape is None:
            return None
        import math

        import torch

        from .parallel import make_mesh

        n = math.prod(self.mesh_shape)
        have = 1 if self.device == "cpu" else (
            torch.cuda.device_count() if torch.cuda.is_available() else 0)
        if n < 1 or n > have:
            raise ValueError(
                f"EngineConfig: mesh_shape={self.mesh_shape} needs {n} distinct "
                f"{self.device} devices, {have} visible")
        devices = ["cpu"] if self.device == "cpu" else [f"cuda:{i}" for i in range(n)]
        return make_mesh(devices, self.mesh_axis_names[0])

    def solver(self, plan, **kwargs):
        """A :class:`~acvm_tpu_torch.gpu.BatchSolver` for ``plan`` on this
        config's device and mesh; ``kwargs`` go to the solver (``backend``,
        ``foreign_call_handler``, ``max_batch_per_pass``, ``mesh``, ...)."""
        from .gpu.batch_solver import BatchSolver

        self._apply_generators()
        kwargs.setdefault("mesh", self.make_mesh())
        if kwargs["mesh"] is None:
            kwargs.setdefault("device", self.device)
        return BatchSolver(plan, **kwargs)


# True while the domain-0 external generator table was installed by an
# EngineConfig (vs a direct set_external_generators call).
_GENERATORS_FROM_CONFIG = False

DEFAULT_CONFIG = EngineConfig()
