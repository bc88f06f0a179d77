"""Command-line interface for the batched ACVM engine on PyTorch / CUDA.

Covers the reference's tooling surface (the acvm_js entry points, driven from a
shell):

  acvm-tpu-torch execute   --circuit c.acir.gz --witness w.gz [--output out.gz]
  acvm-tpu-torch solve     --circuit c.acir.gz --witness-json '{"1": "0x.."}' --batch N [--device cpu] [--mesh | --distributed]
  acvm-tpu-torch compile   --circuit c.acir.gz --width 3 --output compiled.gz
  acvm-tpu-torch info      --circuit c.acir.gz

(or ``python -m acvm_tpu_torch.cli ...``).  ``execute`` runs the sequential
bit-exact engine; ``solve`` runs the batched engine over N copies of the
provided inputs, on ``cuda`` unless ``--device cpu``; ``--mesh`` shards the
batch over every visible card (the CPU with ``--device cpu``), and
``--distributed`` over the ranks of a ``torch.distributed`` job, one rank a
process (run it under ``python -m acvm_tpu_torch.parallel.launcher`` or
torchrun; every rank prints the whole batch's count).  ``bench`` is not part of
this package yet (ROADMAP.md, queue 1 item 1: the port's benchmark).
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_circuit(path: str):
    from .acir.serialization import deserialize_circuit

    with open(path, "rb") as f:
        return deserialize_circuit(f.read())


def _witness_map_from_json(text: str):
    from .acir import Witness, WitnessMap
    from .fields import FieldElement

    data = json.loads(text)
    wm = WitnessMap()
    for k, v in data.items():
        if isinstance(v, str):
            value = FieldElement.from_hex(v)
            if value is None:
                raise SystemExit(f"invalid field hex for witness {k}: {v}")
        else:
            value = FieldElement(int(v))
        wm.insert(Witness(int(k)), value)
    return wm


def cmd_execute(args):
    from .acir.serialization import compress_witness, decompress_witness
    from .api import execute_circuit

    circuit = _load_circuit(args.circuit)
    if args.witness:
        with open(args.witness, "rb") as f:
            initial = decompress_witness(f.read())
    else:
        initial = _witness_map_from_json(args.witness_json or "{}")

    solved = execute_circuit(circuit, initial)
    if args.output:
        with open(args.output, "wb") as f:
            f.write(compress_witness(solved))
        print(f"wrote {args.output}")
    else:
        print(json.dumps({str(int(w)): "0x" + v.to_hex() for w, v in solved}))


def cmd_solve(args):
    from .config import EngineConfig

    mesh = None
    if args.distributed:
        from .parallel import distributed

        distributed.initialize()
        mesh = distributed.global_mesh()
    elif args.mesh:
        from .parallel import make_mesh

        mesh = make_mesh(["cpu"] if args.device == "cpu" else None)
    config = EngineConfig(
        field=args.field,
        device=args.device,
        device_hash_kernels=not args.no_device_hash,
        device_brillig_trace=not args.no_device_brillig,
    )
    circuit = _load_circuit(args.circuit)
    initial = _witness_map_from_json(args.witness_json or "{}")
    assignment = {int(w): int(v) for w, v in initial}

    plan = config.plan(circuit, input_witnesses=list(assignment))
    solver = config.solver(plan, mesh=mesh)
    result = solver.solve([assignment] * args.batch)
    ok = result.ok
    print(
        json.dumps(
            {
                "batch": args.batch,
                "satisfied": int(ok.sum()),
                "levels": len(plan.levels),
                "ops": plan.total_ops(),
                "device": str(solver.device),
                "shards": mesh.size if mesh is not None else 1,
            }
        )
    )
    if not bool(ok.all()):
        sys.exit(1)


def cmd_compile(args):
    from .acir.serialization import serialize_circuit
    from .config import EngineConfig

    config = EngineConfig(language=args.language, width=args.width)
    circuit = _load_circuit(args.circuit)
    compiled, _ = config.compile(circuit, lambda op: True)
    data = serialize_circuit(compiled)
    with open(args.output, "wb") as f:
        f.write(data)
    print(
        json.dumps(
            {
                "opcodes_in": len(circuit.opcodes),
                "opcodes_out": len(compiled.opcodes),
                "current_witness_index": compiled.current_witness_index,
                "output": args.output,
            }
        )
    )


def cmd_info(args):
    circuit = _load_circuit(args.circuit)
    kinds = {}
    for op in circuit.opcodes:
        kinds[op.name()] = kinds.get(op.name(), 0) + 1
    print(
        json.dumps(
            {
                "opcodes": len(circuit.opcodes),
                "current_witness_index": circuit.current_witness_index,
                "public_parameters": circuit.public_parameters.indices(),
                "return_values": circuit.return_values.indices(),
                "kinds": kinds,
            }
        )
    )


def cmd_bench(args):
    raise NotImplementedError(
        "acvm-tpu-torch bench: the port's benchmark is not written yet "
        "(ROADMAP.md, queue 1 item 1); python3 chip_smoke.py prints its rates"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(prog="acvm-tpu-torch")
    parser.add_argument(
        "--log-level",
        default="ERROR",
        help="OFF/ERROR/WARN/INFO/DEBUG/TRACE (acvm_js initLogLevel analogue)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("execute", help="sequential bit-exact witness generation")
    p.add_argument("--circuit", required=True)
    p.add_argument("--witness", help="gzip(bincode) witness map file")
    p.add_argument("--witness-json", help='{"index": value-or-hex} initial witness')
    p.add_argument("--output", help="write solved witness (gzip/bincode)")
    p.set_defaults(fn=cmd_execute)

    p = sub.add_parser("solve", help="batched solve on a device")
    p.add_argument("--circuit", required=True)
    p.add_argument("--witness-json", help="initial witness JSON")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument(
        "--mesh", action="store_true",
        help="shard the batch over all local devices",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="shard the batch over the ranks of a torch.distributed job "
             "(the launcher's or torchrun's environment)",
    )
    p.add_argument("--field", choices=["bn254", "bls12_381"], default="bn254")
    p.add_argument(
        "--no-device-hash", action="store_true",
        help="route hash gadgets through the host-stage path",
    )
    p.add_argument(
        "--no-device-brillig", action="store_true",
        help="route straight-line Brillig through the host VM",
    )
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("compile", help="run the backend-targeting compiler")
    p.add_argument("--circuit", required=True)
    p.add_argument("--language", choices=["plonk-csat", "r1cs"], default="plonk-csat")
    p.add_argument("--width", type=int, default=3)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_compile)

    p = sub.add_parser("info", help="describe a serialized circuit")
    p.add_argument("--circuit", required=True)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("bench", help="the benchmark (not part of this package yet: raises)")
    p.add_argument("--gates", type=int)
    p.add_argument("--batch", type=int)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    from .utils.logging import init_log_level

    init_log_level(args.log_level)
    args.fn(args)


if __name__ == "__main__":
    main()
