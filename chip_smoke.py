#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and prove it.

    python3 chip_smoke.py            # everything, as below
    python3 chip_smoke.py --ptxas    # also print ptxas' register/spill report
    python3 chip_smoke.py --profile  # also one profiled solve per path: device
                                     # time by kernel, device busy share (and
                                     # the SHA-256 path traced block by block;
                                     # path_host's and path_vm's solves with
                                     # their host stages; path_hash's and
                                     # path_ecdsa's solves)
    python3 chip_smoke.py --level-variants  # also the level kernel built with
                                     # its measurement switches: loads only,
                                     # products only, the other block order,
                                     # loads ahead, 64 instances a block
    python3 chip_smoke.py --fold-sweep      # also pow beside batch_inv folded
                                     # into 2-32 rows at 2^14-2^20 values, the
                                     # measurement behind mont_inv_grouped's
                                     # FOLD_LANES, and inv_wide beside
                                     # batch_inv_wide folded at 2^13-2^20
                                     # (FOLD_FROM_WIDE)
    python3 chip_smoke.py --step-peaks[=FILE]  # also each path's first
                                     # solve step by step: each step's peak
                                     # allocation against its work
                                     # (BatchSolver.step_units), the
                                     # measurement behind TEMP_ROWS_PER_UNIT
                                     # (every step to FILE as JSON)
    python3 chip_smoke.py --vm-variants [--parent=DIR]  # also brillig_vm
                                     # built with and without regrouping
                                     # (VM_REGROUP), its state on chip as
                                     # planned or all in device memory, on
                                     # path_vm's three blocks; with
                                     # --parent, the kernel of
                                     # the tree unpacked at DIR (the
                                     # earlier launcher: no launch plan) on
                                     # the same state
    python3 chip_smoke.py --hash-variants   # also sha256, blake2s and keccak
                                     # built with hash.cuh's measurement
                                     # switches (reads only, rounds only)
                                     # timed at every hash row's shape
    python3 chip_smoke.py --parent=DIR      # also mul, pow, batch_inv (and
                                     # their wide modes), pt_add, pt_ladder
                                     # (also at the Schnorr shape),
                                     # ecdsa_mul, sha256, keccak and blake2s
                                     # built from the tree unpacked at DIR
                                     # (git archive <commit>
                                     # acvm_tpu_torch/csrc | tar -x -C DIR)
                                     # beside this tree's, equal outputs
                                     # (ecdsa_mul's affine R; the hash kernels
                                     # at every hash row's shape), timed
                                     # parent, change, change, parent (one
                                     # call, queued and in a CUDA graph);
                                     # and the parent's pow_wide beside this
                                     # tree's inv_wide at the s^-1 shape

Needs one CUDA card and ``nvcc``; there is no CPU route: no card, a failed
build, a failed launch or a failed comparison raises and the exit code is not
0.  It prints one JSON object per line:

1. ``device``  card name and power limit (nvidia-smi), torch and CUDA versions;
2. ``build``   seconds to compile the kernels from ``acvm_tpu_torch/csrc``;
3. ``int32``   the multiply-add rate the bounds use, the rate a probe kernel
               reaches on this card, and the candidate Montgomery products of
               ``csrc/field.cuh`` side by side: products a second at N = 2^20
               with 1 and with 32 products a thread, and microseconds a product
               in one warp's chain of 256; the wide product in such a chain;
4. ``path_static``  the 2^16-gate BN254 circuit (8 levels x 8,192 gates) over
               2,048 instances through ``plan_circuit`` -> ``BatchSolver`` ->
               ``solve``: flags, two full witness maps against a Python-int
               evaluator, launch counts, timed solves;
5. ``path_dyn``  the dynamic-denominator circuit (4 x 4,096 gates, half of
               them with a runtime denominator), same checks, and one
               ``batch_inv`` launch a level; then a small hand-built circuit
               whose chosen instances must fail;
6. ``path_dyn_v1``  the dynamic-denominator circuit at 2 x 4,096 gates with 256
               quadratic constraints repeated as assert-zero checks, solved with
               ``dot_kernel="v1"`` (first-generation multiply and dot): equal to
               the default route's panel, two witness maps against the evaluator;
7. ``path_ec``  the Grumpkin gadget circuits through the same entry points with
               columnar inputs: ``pedersen`` 2 gadgets x 2,048 instances,
               ``fixed_base`` 4 x 4,096, ``schnorr`` 2 x 1,024 (32-byte
               messages); outputs of two instances against the host curve code,
               forged signatures and off-curve keys, out-of-range scalars; one
               ``pt_ladder`` launch a Schnorr gadget level;
8. ``path_int``  the u32 circuit (8 rounds x 1,024 units: multiply-add,
               Quotient by 2^32, its check, Range, AND, XOR, ToLeRadix into
               bytes; 98,432 opcodes) over 1,024 instances, one of them failing
               an input's Range: flags, first-failure indices and three full
               witness maps against the evaluator, one ``divmod`` launch a
               Quotient level and no plain division on the card, ``divmod``
               against its plain version on a Quotient level, an edge set at
               six widths, a grid of word lengths and 2^20 256-bit dividends
               over 128-bit divisors, timed solves;
9. ``path_sha``  the compiler's SHA-256 fallback (28,980 opcodes, 8,297 of them
               straight-line Brillig hints) over 4,096 random 32-byte messages:
               flags, two digests against hashlib and their full witness maps
               against the evaluator, one ``divmod`` launch a Quotient level
               (748) and no plain division on the card, timed solves; the same
               messages in the three ingest forms (host columns, the packed
               matrix, uint8 columns on the card) must give the same panel and
               flags, each timed through ``solve()`` and its ``_pack_host``
               apart from the upload and panel build;
10. ``path_mem``  runtime-indexed arrays (8 memory blocks of 1,024 entries, 32
               rounds of read, multiply-add and write each, the predicate and
               runtime-selector edges; 9,003 opcodes) over 1,024 instances, one
               of them failing at an index one past its block: flags,
               first-failure indices, three full witness maps against the
               evaluator, timed solves;
11. ``path_host``  a sorting program (``build_sort_circuit(64)``: 64 u32 keys
               range-checked, their sum, a PermutationSort into the 321 bits of
               the AS-Waksman network they drive, the sorted keys' gaps, the
               sum's decimal digits, an oracle's 3 x + 1 by a foreign call;
               1,171 opcodes) over 1,024 instances, one with a key of 2^32:
               device segments around three host stages; every instance's
               sorted keys, digits, answer and flags against Python ints, three
               witness maps against the sequential engine, ``host_batch=False``
               the same panel, ``level`` and ``dot`` against their plain
               versions, ``host_solves_per_sec`` and the ``SolveStats`` split;
12. ``path_vm``  a program with unconstrained loops (``build_brillig_vm_circuit(16)``:
               an insertion sort of 16 u32 keys into an array output, an
               integer square root by binary search, an inverse that traps
               where k_0 = k_1; 88 opcodes) over 8,192 instances, the sort's
               worst case, two traps and a key of 2^32 among them: three
               ``brillig_vm`` launches and no per-instance stage; every
               instance's sorted keys, root, inverse and flags against Python
               ints, three witness maps against the sequential engine,
               ``host_batch=False`` the same panel on 256 instances,
               ``vm_solves_per_sec``, the ``SolveStats`` split and the VM
               route's input, kernel and readback times with the steps an
               instance, a block at a time; ``brillig_vm`` against its plain
               version on each block at 8,192 instances and on the two state
               tiers the path does not reach (a binary search over 256 words,
               its memory in device memory; a register file of 300 rows) at
               8,191;
13. ``brillig_ops``  one Brillig block for each field op and each int op at
               1-256 bits over 2,048 instances of edge values, every witness
               against the evaluator;
14. ``brillig_vm_edges``  the JAX package's device-VM fixtures (a sum loop, a
               binary search over an array input, Call/Return with a
               conditional Trap) and a predicated loop over 2,048 instances
               against Python ints, one instance past the step budget
               rerunning its block instance by instance (one per-instance
               stage); every block of 13 through the VM equal to the trace's
               panel, the UnsignedDiv-by-zero instances trapping;
15. ``path_hash``  the hash gadgets: the JAX package's gadget circuits
               (``build_gadget_circuit`` sha256, blake2s, keccak256: 8 gadgets
               of 64 bytes) over 8,192 random messages as a uint8 matrix on the
               card, one launch of the kind's kernel a solve, every digest
               against hashlib (Keccak's against the host Keccak on 512
               instances), ``{kind}_solves_per_sec``; then the Merkle-membership
               program (``build_membership_circuit(16)``: 1,804 opcodes, 20 hash
               launches a solve) over 8,192 instances, a path bit of 2, a
               memo_len past the message and one of 2^128 + 100 among them:
               flags and first-failure indices, every instance's leaf, root and
               nullifier against hashlib, signal and binding against the host
               Keccak on 512, three witness maps against the sequential engine,
               the hashes as host stages the same on 256, no plain digest on the
               card, ``membership_solves_per_sec`` with the ``SolveStats`` split;
16. ``path_ecdsa``  ECDSA verification: the JAX package's gadget circuits
               (``build_gadget_circuit`` ecdsa_k1 and ecdsa_r1: 2 gadgets, 322
               witnesses) over 4,096 instances (8,192 verifications), a pool of
               256 signatures a gadget tiled over the batch, the planted edges
               of ``utils.ecdsa_planted`` first (tampered and high S, an
               off-curve key, r or s zero or n, z = n, z = 0, R at infinity,
               u1 G = u2 Q, x(R) >= n, a byte witness of 256 + b): every
               instance's valid bits, flag and first failure against its
               construction, 8 witness maps against the sequential engine, one
               ``ecdsa_mul`` launch a solve and no narrow kernel,
               ``ecdsa_k1_solves_per_sec`` / ``ecdsa_r1_solves_per_sec`` (device
               solve and through ``solve()``); ecdsa_k1 once more over 16,384
               instances (32,768 inversions of each kind: ``batch_inv_wide``
               where ``LimbContext.fold_rows`` folds them, else
               ``inv_wide``); the 4,096-instance solves' inversions (s^-1,
               Z^-1) by ``inv_wide``, the constant-time divsteps, two
               launches a solve and no ``pow_wide``;
               then ``mul_wide`` at 2^20, ``inv_wide`` at the s^-1 shape
               (8,192, both curves' n; on the four wide moduli with the edge
               lanes 0, R, M - 1, 1, 2, R^-1 and a long divstep run) against
               its plain version and ``pow_wide`` at e = M - 2, with
               ``pow_wide`` timed beside it and a lone warp's inversion as its
               latency floor, ``pow_wide`` on the schedule's edge exponents,
               ``batch_inv_wide`` at the 16,384-instance solve's 32,768 values
               in 2 rows, on both curves' p and n, and ``ecdsa_mul`` on
               each solve's own operands and the edge lanes of
               ``utils.ecdsa_mul_edges`` (X, Y and Z against its plain version,
               the affine R of 64 path lanes and of the edge lanes against the
               Python-int curve), with its bound (the products this kernel
               runs), the longest warp's chain of products and its floor,
               shared memory and blocks an SM, and its time and bound at
               32,768 lanes;
16b. ``path_api``  the product surface: (a) the JAX package's north-star
               shape (``bench.py:326-354``: the 2^16-gate circuit x 10,240
               instances) serialized, written, read back with
               ``Circuit.read`` and solved by ``api.execute_circuit_batched``
               under ``EngineConfig()`` in five passes of 2,048 and in one
               pass: the same flags, ``solve_chunks``' chunks 0 and 4 equal
               to the one-pass panel's columns, ``b10k_solves_per_sec``
               (gates x instances / wall of one ``solve()``, packing
               included) with the ``SolveStats`` split over the passes and
               the device's busy share; (b) the same circuit compiled to
               width 3 (``EngineConfig().compile``), serialized, read and
               solved at 10,240 in one pass: three instances' original
               witnesses against the evaluator and (a), the level kernel's
               instantiation on each compiled level and its time on the
               widest; (c) the CLI's ``solve`` (4,096 instances, all
               satisfied), ``execute``, ``info`` and ``compile`` on the
               acvm_js addition fixture; (d) the compiled BLAKE2s and
               Keccak-256 fallbacks (the hash black boxes refused) over
               4,096 random 32-byte messages: every digest against hashlib /
               the host Keccak; each drive's launches; and every path's
               first solve's peak device allocation over its state and over
               the solver's estimate of a pass (``pass_peaks``: it fails if
               a peak passes ``PASS_PEAK_OVER_ESTIMATE`` x ``pass_bytes``);
16c. ``native``  the host Grumpkin library: its g++ build timed, held against
               the pure-Python curve (scalar multiples at the edges, additions
               through infinity, an MSM, two window tables, the three host
               black boxes), one 64-window table and each gadget solver's
               plan and tables (fixed_base, pedersen, schnorr) native and
               plain, in turns; ``dot_mxu`` against its plain version at
               every term count 1-8 on edge values and against the v2 dot,
               timed beside it at row 4's shape without scale (E = B = 2,048,
               T = 3) and on the wide panels (T = 4 and 8, E = 8,192, B =
               2,048); ``path_dyn_mxu``: path_dyn's circuit under
               ``dot_kernel="mxu"``, flags and panel equal to the v2 solve's,
               device solves v2, mxu, mxu, v2; ``path_mesh``: (a) the
               2^16-gate circuit at B = 8,192 over four entries of the card
               against one solve (flags, the last witness row, two witness
               maps a shard; ``solve()`` seconds of each), (b)
               ``pedersen_msm_sharded`` of 64 generators x 2,048 over four
               entries against ``msm_fixed_tables`` and the host library,
               (c) ``launch_local``: two ranks on the card over gloo and one
               NCCL rank, each solving its slice of B = 4,096, every rank's
               gathered result equal to the one solve's;
17. ``kernels`` every kernel against its plain PyTorch version at the main
               path's shapes (tolerance 0: integers), its time, the plain
               version's time over the same whole shape, its bound and its
               launches on each path; the hash kernels on path_hash's groups
               (a panel's row, limb and shift tables; the membership's
               second Keccak, of 64 bytes, among them) and ``blake2s`` on
               Schnorr's (2,048, 64) byte matrix, each shape with its
               registers, spills, blocks and shared memory a block, and
               the time of its rounds alone (``rounds_only_ms``, a build
               with HASH_ROUNDS_ONLY, the row's latency floor); the kernels
               no path launches since another took their place (``pow_wide``,
               and ``batch_inv_wide`` below its fold threshold) are listed
               with 0 launches and ``on_path`` false; ``batch_inv`` with its plan
               (``fields/kernels.py::batch_inv_plan``: chunk, lanes a block,
               chains), with its plan and with 32 lanes forced on the edge
               cases, at four chunk sizes and four tile widths on the dyn
               path's (2,048, 2,048) panel, and at four tile widths on 65,536
               values in 2 rows; ``pt_ladder`` also on batches of 1, 3 and
               33 and at the Schnorr path's own shape (affine keys, scalars
               below n), with the rounds of its longest warp and their
               floor; ``brillig_vm`` on the sort
               block of 12 over all 8,192 instances, with the opcodes executed
               by kind that its bound counts, and the isqrt and inverse blocks
               as shapes of it (their divisions counted from their operands,
               the inverse's Fermat chain's latency beside its bound);
18. the raw ``nvidia-smi`` name and power limit;
19. ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Data sheet of the H100 SXM: 3.35 TB/s of device memory; 132 SMs x 64 int32
# lanes x 1.98 GHz boost = one multiply-add per lane per clock at best.
MEM_BYTES_PER_S = 3.35e12
INT32_MADDS_PER_S = 132 * 64 * 1.98e9
MADDS_PER_MONT_MUL = 136  # 8x8 a*b + 8x8 m*p + 8 m = t0*n0
U8_OPS_PER_S = 1.979e15  # data sheet: dense int8 tensor-core operations


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# Each path's first solve: its peak device allocation over one pass's state
# and over the solver's estimate of a pass (``BatchSolver.pass_bytes``); with
# --step-peaks, each step of that solve alone (``STEP_PEAKS``).
PASS_PEAKS: dict = {}
STEP_PEAKS: dict = {}


def peak_of(fn):
    """(fn(), the device's peak allocation during it over the bytes it
    started with)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def pass_peak(label, fn, instances, solver=None, inputs=None):
    """fn() with its peak allocation over the state of one pass of
    ``instances`` (``panel_bytes``) and over the solver's estimate of the
    pass (``pass_bytes``) of ``solver`` (default the solver of fn's
    result), kept in :data:`PASS_PEAKS`; with --step-peaks and ``inputs``,
    the solve of ``inputs`` step by step (:func:`step_peaks`)."""
    out, peak = peak_of(fn)
    solver = solver or out.solver
    panel, estimate = solver.panel_bytes(instances), solver.pass_bytes(instances)
    PASS_PEAKS[label] = {"pass_instances": instances, "panel_bytes": panel, "peak_bytes": peak,
                         "estimate_bytes": estimate, "peak_over_panel": peak / panel,
                         "peak_over_estimate": peak / estimate,
                         "panel_rows": panel // (32 * instances),
                         "temp_rows_estimate": solver.temp_rows(),
                         "peak_rows": peak / (32 * instances)}
    if inputs is not None and any(a.startswith("--step-peaks") for a in sys.argv):
        from acvm_tpu_torch import build

        counts = dict(build.LAUNCHES)  # the path's own launches, not these
        STEP_PEAKS[label] = step_peaks(solver, inputs)
        build.LAUNCHES.update(counts)
    return out


def step_peaks(solver, inputs):
    """One solve of ``inputs`` run step by step, as ``solve`` runs it (the
    inputs' upload, then each segment's device levels and its host stages):
    each step's work (``BatchSolver.step_units``) and its peak allocation
    beyond the bytes it started with and the state it made, in rows of 32
    bytes an instance."""
    B = solver._batch_len(inputs)
    units = iter(solver.step_units())
    (W, ok, fail, mem), peak = peak_of(lambda: solver.initial_state(inputs))
    state = solver.panel_bytes(B) + ok.numel() * ok.element_size() + fail.numel() * fail.element_size()
    steps = [{"units": dict(next(units)), "rows": (peak - state) / (32 * B)}]
    for segment in solver.segments:
        for packed in segment.levels:
            (W, ok, fail), peak = peak_of(lambda: solver._run_level(W, ok, fail, mem, packed))
            steps.append({"units": dict(next(units)), "rows": peak / (32 * B)})
        if segment.host_stages:
            (W, ok, fail), peak = peak_of(
                lambda: solver._run_host_stages(W, ok, fail, segment.host_stages))
            steps.append({"units": dict(next(units)), "rows": peak / (32 * B)})
    return steps


def step_peak_summary(steps_by_label):
    """Over every path's steps: for each kind, the most rows a unit took in
    a step of that kind alone; and the steps whose rows pass the solver's
    estimate (``TEMP_ROWS_PER_UNIT``)."""
    from acvm_tpu_torch.gpu.batch_solver import STEP_BASE_ROWS, TEMP_ROWS_PER_UNIT

    per_unit, over = {}, []
    for label, steps in steps_by_label.items():
        for i, step in enumerate(steps):
            units = step["units"]
            if len(units) == 1:
                (kind, n), = units.items()
                best = per_unit.get(kind, {"rows_per_unit": -1.0})
                if step["rows"] / n > best["rows_per_unit"]:
                    per_unit[kind] = {"rows_per_unit": step["rows"] / n, "path": label,
                                      "step": i, "units": n}
            model = STEP_BASE_ROWS + sum(TEMP_ROWS_PER_UNIT[k] * n for k, n in units.items())
            if step["rows"] > model:
                over.append({"path": label, "step": i, "units": units, "rows": step["rows"],
                             "estimate": model})
    return {"rows_per_unit_alone": per_unit, "steps_over_estimate": over}


def brillig_int_op(op, a, b, bits, p):
    """A Brillig int op on field values (brillig_vm/src/arithmetic.rs): mod
    2^bits, the result stored as a field element (so reduced mod p);
    SignedDiv reads each register as it is in two's complement and truncates
    toward zero; UnsignedDiv by zero gives 0 (the VM raises there)."""
    from acvm_tpu_torch import brillig as br

    mod, O = 1 << bits, br.BinaryIntOp
    if op == O.SignedDiv:
        sa, sb = (x if x < mod >> 1 else x - mod for x in (a, b))
        r = abs(sa) // abs(sb) if sb else 0
        r = -r if (sa < 0) != (sb < 0) else r
    elif op == O.UnsignedDiv:
        r = (a % mod) // (b % mod) if b % mod else 0
    elif op == O.Shl:
        r = a << b if b < bits else 0
    else:
        r = {O.Add: a + b, O.Sub: a - b, O.Mul: a * b, O.Equals: int(a % mod == b % mod),
             O.LessThan: int(a % mod < b % mod), O.LessThanEquals: int(a % mod <= b % mod),
             O.And: a & b, O.Or: a | b, O.Xor: a ^ b, O.Shr: a >> b}[op]
    return r % mod % p


def brillig_field_op(op, a, b, p):
    from acvm_tpu_torch import brillig as br

    O = br.BinaryFieldOp
    if op == O.Div:
        return a * pow(b, -1, p) % p if b else 0
    return {O.Add: a + b, O.Sub: a - b, O.Mul: a * b, O.Equals: int(a == b)}[op] % p


def evaluate(circuit, inputs, p):
    """Sequential Python-int solve: walk the opcodes in order.  An arithmetic
    gate solves its one unknown or checks; Range, AND, XOR, Quotient and
    ToLeRadix follow the sequential engine's rules (a Range fails above its
    bits, AND/XOR mask both operands to their bits, a zero divisor or
    predicate gives q = r = 0, a radix value that does not fit its digits
    fails); a straight-line Brillig block runs its registers with the VM's
    rules (zero outputs under a zero predicate); a memory opcode reads or
    writes its block (index 2^64 or more fails, one past the block fails where
    the predicate holds, an inactive read gives 0, a read into a known
    witness fails).  Every later opcode is still evaluated, as the batched
    levels do (a ToLeRadix that fails writes its low digits, a read that fails
    gives 0).  Returns the witness dict and the index of the first opcode that
    cannot be satisfied (None)."""
    from acvm_tpu_torch import brillig as br
    from acvm_tpu_torch.acir import opcodes as ops

    w = dict(inputs)
    mem = {}
    failed = None

    def value(e):  # an expression over known witnesses
        v = e.q_c.value + sum(c.value * w[int(x)] for c, x in e.linear_combinations)
        return (v + sum(c.value * w[int(a)] * w[int(b)] for c, a, b in e.mul_terms)) % p

    for index, op in enumerate(circuit.opcodes):
        bad = False
        if isinstance(op, ops.OpcodeBrillig):
            block = op.brillig
            regs = {i: value(inp.expr) for i, inp in enumerate(block.inputs)}
            for code in block.bytecode:
                if isinstance(code, br.OpStop):
                    break
                if isinstance(code, br.OpConst):
                    regs[code.destination] = code.value.inner.value % p
                elif isinstance(code, br.OpMov):
                    regs[code.destination] = regs.get(code.source, 0)
                elif isinstance(code, br.OpBinaryFieldOp):
                    regs[code.destination] = brillig_field_op(
                        code.op, regs.get(code.lhs, 0), regs.get(code.rhs, 0), p)
                elif isinstance(code, br.OpBinaryIntOp):
                    regs[code.destination] = brillig_int_op(
                        code.op, regs.get(code.lhs, 0), regs.get(code.rhs, 0), code.bit_size, p)
                else:
                    raise NotImplementedError(type(code).__name__)
            active = block.predicate is None or value(block.predicate)
            for i, out in enumerate(block.outputs):
                w[int(out.witness)] = regs.get(i, 0) if active else 0
            continue
        if isinstance(op, ops.OpcodeMemoryInit):
            mem[op.block_id.id] = [w[int(x)] for x in op.init]
            continue
        if isinstance(op, ops.OpcodeMemoryOp):
            block, m = mem[op.block_id.id], op.op
            idx = value(m.index)
            active = op.predicate is None or value(op.predicate) != 0
            in_bounds = idx < len(block)
            bad = idx >= 1 << 64 or (active and not in_bounds)
            lin = m.value.linear_combinations
            target = lin[0][1] if (len(lin) == 1 and lin[0][0].value == 1 and not m.value.mul_terms
                                   and not m.value.q_c.value) else None
            if value(m.operation) == 0:
                if target is None or int(target) in w:
                    bad = True  # a read must assign a witness
                else:
                    w[int(target)] = block[idx] if active and in_bounds else 0
            elif active:
                known = target is None or int(target) in w
                bad = bad or not known
                if in_bounds:
                    block[idx] = value(m.value) if known else 0
            if bad and failed is None:
                failed = index
            continue
        if isinstance(op, ops.OpcodeBlackBoxFuncCall):
            call = op.call
            if isinstance(call, ops.BBRange):
                bad = w[int(call.input.witness)].bit_length() > call.input.num_bits
            elif isinstance(call, (ops.BBAnd, ops.BBXor)):
                m = (1 << call.lhs.num_bits) - 1
                x, y = w[int(call.lhs.witness)] & m, w[int(call.rhs.witness)] & m
                w[int(call.output)] = (x & y if isinstance(call, ops.BBAnd) else x ^ y) % p
            else:
                raise NotImplementedError(type(call).__name__)
        elif isinstance(op, ops.OpcodeDirective):
            d = op.directive
            if isinstance(d, ops.DirQuotient):
                qd = d.quotient
                a, b = value(qd.a), value(qd.b)
                pred = 1 if qd.predicate is None else value(qd.predicate)
                w[int(qd.q)], w[int(qd.r)] = divmod(a, b) if pred and b else (0, 0)
            elif isinstance(d, ops.DirToLeRadix):
                v = value(d.a)
                bad = v >= d.radix ** len(d.b)
                for i, x in enumerate(d.b):
                    w[int(x)] = v // d.radix ** i % d.radix
            else:
                raise NotImplementedError(type(d).__name__)
        if bad and failed is None:
            failed = index
        if not isinstance(op, ops.OpcodeArithmetic):
            continue
        e = op.expr
        num, den, unknown = e.q_c.value, 0, None
        for c, x in e.linear_combinations:
            if int(x) in w:
                num += c.value * w[int(x)]
            else:
                unknown, den = int(x), den + c.value
        for c, a, b in e.mul_terms:
            a, b = int(a), int(b)
            if a in w and b in w:
                num += c.value * w[a] * w[b]
            elif a in w:
                unknown, den = b, den + c.value * w[a]
            else:
                unknown, den = a, den + c.value * w[b]
        num, den = num % p, den % p
        if unknown is None:
            if num and failed is None:
                failed = index
        elif den:
            w[unknown] = (-num * pow(den, -1, p)) % p
        else:
            w[unknown] = 0
            if num and failed is None:
                failed = index
    return w, failed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU route", file=sys.stderr)
        return 1

    import numpy as np

    from acvm_tpu_torch import brillig as br
    from acvm_tpu_torch import build
    from acvm_tpu_torch.acir import Circuit, Expression, Witness
    from acvm_tpu_torch.acir import opcodes as ops
    from acvm_tpu_torch.fields import kernels as fk
    from acvm_tpu_torch.fields.field import FieldElement
    from acvm_tpu_torch.fields.params import BLS12_381_FR, BN254_FR
    from acvm_tpu_torch.gpu import FAIL_NONE, BatchSolver, plan_circuit
    from acvm_tpu_torch.gpu.fused_level import fused_level_call, fused_level_plain
    from acvm_tpu_torch.blackbox import grumpkin as host_gk
    from acvm_tpu_torch.gpu import ec, ec_fused
    from acvm_tpu_torch.fields.torch_ops import LimbContext
    from acvm_tpu_torch.gpu import intops
    from acvm_tpu_torch.utils import (
        array_inputs, brillig_ops_inputs, build_array_circuit, build_brillig_ops_circuit,
        build_gadget_circuit, build_membership_circuit, build_sha256_circuit, build_u32_circuit,
        build_wide_arith_circuit, membership_circuit_roles, membership_inputs, membership_outputs,
        build_sort_circuit, columnar_instance, divmod_edge_operands, divmod_word_grid,
        brillig_vm_circuit_roles, brillig_vm_edge_inputs, brillig_vm_inputs,
        build_brillig_vm_circuit, build_brillig_vm_edges_circuit,
        build_brillig_vm_wide_registers_circuit,
        gadget_inputs_columnar, oracle_affine, random_inputs, sha256_inputs, sort_circuit_roles,
        sort_inputs, u32_inputs, with_repeated_constraints,
    )
    from acvm_tpu_torch.utils.profiling import SolveStats
    from acvm_tpu_torch.utils.ec_points import exceptional_panel

    dev = torch.device("cuda")
    P = BN254_FR.modulus
    N_ORDER = host_gk.grumpkin.params.n

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # -- 2. build -------------------------------------------------------------
    built = build.build(build.KERNELS + build.PROBES, extra_flags=["-Xptxas", "-v"])
    if "--ptxas" in sys.argv:
        for name, text in built["log"].items():
            print(f"--- ptxas {name}\n{text}", flush=True)
    for name in built["built"]:
        build.load(name)
    # ptxas' report per kernel: the most registers and spill bytes of its entry functions.
    ptxas = {}
    for name, text in built["log"].items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = [int(a) + int(b) for a, b in
                  re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
        stack = [int(n) for n in re.findall(r"(\d+) bytes stack frame", text)]
        assert regs, f"no ptxas report for {name}"
        ptxas[name] = {"registers": max(regs), "spill_bytes": max(spills), "stack_bytes": max(stack)}
    emit({"build": {"seconds": built["seconds"], "built": built["built"], "ptxas": ptxas}})

    def time_ms(fn, reps=7, calls=1, warmup=2):
        """Median CUDA-event time of one fn() in ms, after ``warmup`` calls.
        With calls = 1 the events bracket a single call, host gap between the
        event and the launch included (tens of microseconds, which is most of
        what a kernel under 0.1 ms reads); with more, that many calls are
        queued back to back between the events and the time is divided."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / calls)
        return statistics.median(times)

    def graph_ms(fn, launches=20, reps=7):
        """Device time of one fn() with the host's launch cost taken out:
        ``launches`` calls captured in one CUDA graph, the replay timed as
        time_ms times it, divided.  For kernels shorter than the ~15-20 us a
        launch takes the host through ctypes, where ``ms_queued`` reads the
        host.  fn must not synchronise."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        ms = time_ms(graph.replay, reps=reps) / launches
        del graph
        return ms

    def bound(bytes_moved, madds):
        t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
        t_ops = madds / INT32_MADDS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def max_abs_err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    def random_elements(shape, params, seed, zeros=0):
        """Uniform canonical field elements as (..., 8) int32 on the card."""
        rng = np.random.default_rng(seed)
        n = int(np.prod(shape))
        raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        top = (params.modulus >> 224) - 1  # top limb below p's: value < p
        raw[:, 7] %= np.uint32(top)
        raw[:zeros] = 0
        return torch.from_numpy(raw.view(np.int32)).reshape(*shape, 8).to(dev)

    # -- 3. the integer rate ----------------------------------------------------
    blocks, threads, iters = 132 * 16, 256, 4096
    probe_out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    probe_ms = time_ms(lambda: build.launch(
        "imad_rate", probe_out.data_ptr(), blocks, threads, iters,
        torch.cuda.current_stream().cuda_stream))
    # The candidate products: throughput at the shape of mul (N = 2^20, one
    # product a thread) and latency in one warp's chain of 256 dependent products.
    n_mul, chain = 1 << 20, 256
    pa = random_elements((n_mul,), BN254_FR, 1)
    pb = random_elements((n_mul,), BN254_FR, 2)
    words = fk._host_ptr(fk.field_words(BN254_FR))

    def mont_probe(variant, n, chain_len, threads_per_block):
        out = torch.empty((n, 8), dtype=torch.int32, device=dev)
        run = lambda: build.launch(  # noqa: E731
            "mont_probe", pa.data_ptr(), pb.data_ptr(), out.data_ptr(), n, chain_len, variant,
            threads_per_block, words, torch.cuda.current_stream().cuda_stream)
        return out, time_ms(run, calls=10)

    want_one = torch.cat([fk.mont_mul_plain(pa[i : i + (1 << 18)], pb[i : i + (1 << 18)], BN254_FR)
                          for i in range(0, n_mul, 1 << 18)])
    want_chain = pa[:32]
    for _ in range(chain):
        want_chain = fk.mont_mul_plain(want_chain, pb[:32], BN254_FR)
    candidates = {}
    for variant, name in enumerate(("c_64bit_sums", "carry_flag_even_odd", "wide_then_one_reduction")):
        got_one, one_ms = mont_probe(variant, n_mul, 1, 128)
        got_chain, chain_ms = mont_probe(variant, 32, chain, 32)
        _, busy_ms = mont_probe(variant, n_mul, 32, 128)  # 32 products a thread: the pipes, not memory
        torch.cuda.synchronize()
        err = max(max_abs_err(got_one, want_one), max_abs_err(got_chain, want_chain))
        assert err == 0, (name, err)
        candidates[name] = {"max_abs_err": err, "ms_n_2_20": one_ms,
                            "products_per_s": n_mul / (one_ms * 1e-3),
                            "ms_n_2_20_chain_32": busy_ms,
                            "products_per_s_chain_32": 32 * n_mul / (busy_ms * 1e-3),
                            "chain_256_ms": chain_ms, "us_per_product_in_chain": chain_ms * 1e3 / chain}
    del pa, pb, want_one, got_one
    # The wide product (secp256k1's p) in one warp's chain of 256 a thread:
    # the time of a product in ecdsa_mul's chains (its latency floor).
    from acvm_tpu_torch.gpu.ecdsa import curve_fields

    k1_field = curve_fields("secp256k1")[0]
    wa = random_elements((32,), k1_field, 3)
    wb = random_elements((32,), k1_field, 4)
    wide_out = torch.empty_like(wa)
    wide_ms = time_ms(lambda: build.launch(
        "mont_probe", wa.data_ptr(), wb.data_ptr(), wide_out.data_ptr(), 32, chain, 3, 32,
        fk._host_ptr(fk.field_words(k1_field)), torch.cuda.current_stream().cuda_stream), calls=10)
    want_x = wa
    for _ in range(chain):
        want_x = fk.mont_mul_plain(want_x, wb, k1_field)
    wide_chain = {"field": k1_field.name, "max_abs_err": max_abs_err(wide_out, want_x), "chain": chain,
                  "chain_ms": wide_ms, "us_per_product_in_chain": wide_ms * 1e3 / chain}
    assert wide_chain["max_abs_err"] == 0, wide_chain
    del wa, wb, wide_out, want_x
    emit({"int32": {"bound_madds_per_s": INT32_MADDS_PER_S,
                    "bound_from": "data sheet: 132 SMs x 64 int32 lanes x 1.98 GHz",
                    "probe_madds_per_s": blocks * threads * iters * 8 / (probe_ms * 1e-3),
                    "probe": "acvm_tpu_torch/csrc/imad_rate.cu",
                    "mont_mul_candidates": candidates,
                    "wide_mont_mul_chain": wide_chain,
                    "candidates_probe": "acvm_tpu_torch/csrc/mont_probe.cu",
                    "field_cuh_mont_mul_is": "carry_flag_even_odd"}})

    kernels = {}

    # -- 6a. mul ----------------------------------------------------------------
    n_mul = 1 << 20
    errs = []
    for params in (BN254_FR, BLS12_381_FR):
        a = random_elements((n_mul,), params, 1)
        b = random_elements((n_mul,), params, 2)
        for reduce in (True, False):
            got = fk.mont_mul(a, b, params, reduce=reduce)
            want = torch.cat([
                fk.mont_mul_plain(a[i : i + (1 << 18)], b[i : i + (1 << 18)], params, reduce)
                for i in range(0, n_mul, 1 << 18)])
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, want))
        one = torch.from_numpy(fk.int_to_limbs32(params.r2).copy()).to(dev)
        errs.append(max_abs_err(fk.mont_mul(a, one, params),
                                fk.mont_mul(a, one.expand_as(a).contiguous(), params)))
    a = random_elements((n_mul,), BN254_FR, 1)
    b = random_elements((n_mul,), BN254_FR, 2)
    out = torch.empty_like(a)
    b_ms, b_by = bound(96 * n_mul, MADDS_PER_MONT_MUL * n_mul)
    kernels["mul"] = dict(
        name="mul", route="cuda", source="acvm_tpu_torch/csrc/mul.cu",
        replaces="acvm_tpu/fields/pallas_mul_v2.py:241", shape=f"N={n_mul}",
        max_abs_err=max(errs),
        ms=time_ms(lambda: fk.mont_mul(a, b, BN254_FR, out=out)),
        ms_queued=time_ms(lambda: fk.mont_mul(a, b, BN254_FR, out=out), calls=10),
        plain_ms=time_ms(lambda: [fk.mont_mul_plain(a[i : i + (1 << 18)], b[i : i + (1 << 18)], BN254_FR)
                                  for i in range(0, n_mul, 1 << 18)], 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del a, b, out, got, want

    # -- 6b. pow ----------------------------------------------------------------
    # Every exponent the window schedule treats apart against the plain version
    # on both fields (4,096 elements, five of them zero, one p - 1); timed at
    # N = 2^16 and at the gadget paths' 4,096.
    n_pow, n_small = 1 << 16, 4096
    rng_e = np.random.default_rng(12)
    errs = []
    for params in (BN254_FR, BLS12_381_FR):
        a = random_elements((n_small,), params, 3, zeros=5)
        a[5] = torch.from_numpy(fk.int_to_limbs32(params.modulus - 1).copy()).to(dev)
        for e in (0, 1, 2, 15, 16, params.modulus - 2, (1 << 256) - 1,
                  int.from_bytes(rng_e.bytes(32), "little")):
            errs.append(max_abs_err(fk.mont_pow(a, e, params), fk.mont_pow_plain(a, e, params)))
    a = random_elements((n_pow,), BN254_FR, 3, zeros=5)
    got = fk.mont_pow(a, P - 2, BN254_FR)
    want = fk.mont_pow_plain(a, P - 2, BN254_FR)
    torch.cuda.synchronize()
    errs += [max_abs_err(got, want), max_abs_err(got[:5], torch.zeros_like(got[:5]))]
    # a * a^-1 = 1: the product of the Montgomery forms is R.
    r_one = torch.from_numpy(fk.int_to_limbs32(BN254_FR.r).copy()).to(dev)
    errs.append(max_abs_err(fk.mont_mul(a[5:], got[5:], BN254_FR), r_one.expand_as(a[5:])))
    chain = fk.pow_chain_products(P - 2)
    b_ms, b_by = bound(64 * n_pow, chain * MADDS_PER_MONT_MUL * n_pow)
    a_small = a[:n_small].clone()
    kernels["pow"] = dict(
        name="pow", route="cuda", source="acvm_tpu_torch/csrc/pow.cu",
        replaces="acvm_tpu/fields/pallas_mul.py:175",
        shape=f"N={n_pow}, e=p-2, {chain} products a chain", max_abs_err=max(errs),
        ms=time_ms(lambda: fk.mont_pow(a, P - 2, BN254_FR)),
        ms_queued=time_ms(lambda: fk.mont_pow(a, P - 2, BN254_FR), calls=10),
        ms_n_4096=time_ms(lambda: fk.mont_pow(a_small, P - 2, BN254_FR)),
        ms_n_4096_queued=time_ms(lambda: fk.mont_pow(a_small, P - 2, BN254_FR), calls=10),
        bound_ms_n_4096=bound(64 * n_small, chain * MADDS_PER_MONT_MUL * n_small)[0],
        plain_ms=time_ms(lambda: fk.mont_pow_plain(a, P - 2, BN254_FR), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del a, a_small, got, want

    # -- 6b'. batch_inv ---------------------------------------------------------
    # Against the plain version on both fields, through the plan and with 32
    # lanes a block forced: zeros at the first and last row of a chunk, a
    # chunk and a whole tile of zeros, columns of p - 1, G not a multiple of
    # the chunk and L of the tile, G = 1 and 2, axes other than 0; the result
    # times the input is R.  Then the dyn path's panel (2,048 gates x 2,048
    # instances) at the solver's chunk, timed at four chunk sizes through the
    # plan and at four tile widths; and 65,536 values in 2 rows
    # (mont_inv_grouped's fold) at four tile widths.
    from acvm_tpu_torch.gpu.batch_solver import _DYN_INV_CHUNK
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = []
    for params in (BN254_FR, BLS12_381_FR):
        pm1 = torch.from_numpy(fk.int_to_limbs32(params.modulus - 1).copy()).to(dev)
        r_p = torch.from_numpy(fk.int_to_limbs32(params.r).copy()).to(dev)
        a = random_elements((300, 100), params, 51)   # chunks of 32: the last holds 12
        a[0, 0] = a[31, 1] = a[32, 1] = a[299, 3] = a[288, 6] = 0
        a[64:96, 2] = 0
        a[96:128, 32:64] = 0                           # a tile of 32 lanes, all zero
        a[:, 4] = pm1
        a[100:140, 5] = pm1
        for g in (32, 7, 300, 1):
            want = fk.mont_batch_inv_plain(a, params, 0, g)
            got = fk.mont_batch_inv(a, params, 0, g)
            errs.append(max_abs_err(got, want))
            forced = fk.batch_inv_plan(300, 100, g, sms)._replace(lanes=32)
            errs.append(max_abs_err(fk.batch_inv_launch(a, params, forced), want))
        zero = (a == 0).all(-1)
        errs.append(max_abs_err(got[zero], torch.zeros_like(got[zero])))
        errs.append(max_abs_err(fk.mont_mul(a[~zero], got[~zero], params),
                                r_p.expand_as(a[~zero])))
        for G in (1, 2):
            errs.append(max_abs_err(fk.mont_batch_inv(a[:G], params, 0, 32),
                                    fk.mont_batch_inv_plain(a[:G], params, 0, 32)))
        errs.append(max_abs_err(fk.mont_batch_inv(a[:, :1], params, 0, 32),
                                fk.mont_batch_inv_plain(a[:, :1], params, 0, 32)))   # L = 1
        at = a.transpose(0, 1)  # (100, 300, 8), a strided view, along axis 1
        errs.append(max_abs_err(fk.mont_batch_inv(at, params, 1, 32),
                                fk.mont_batch_inv_plain(at, params, 1, 32)))
        a4 = a.reshape(300, 4, 25, 8).permute(1, 0, 2, 3)  # (4, 300, 25, 8) along axis -3
        errs.append(max_abs_err(fk.mont_batch_inv(a4, params, -3, 32),
                                fk.mont_batch_inv_plain(a4, params, -3, 32)))
    assert max(errs) == 0, errs
    G_inv = L_inv = 2048
    a = random_elements((G_inv, L_inv), BN254_FR, 52)
    a[0, 0] = a[G_inv - 1, 1] = a[_DYN_INV_CHUNK, 2] = 0
    got = fk.mont_batch_inv(a, BN254_FR, 0, _DYN_INV_CHUNK)
    by_chunk, plans = {}, {}
    for g in sorted({32, 64, 128, 256, _DYN_INV_CHUNK}):
        other = fk.mont_batch_inv(a, BN254_FR, 0, g)
        errs.append(max_abs_err(other, got))
        by_chunk[g] = time_ms(lambda g=g: fk.mont_batch_inv(a, BN254_FR, 0, g), calls=10)
        plans[g] = fk.batch_inv_plan(G_inv, L_inv, g, sms)._asdict()
    plan = fk.batch_inv_plan(G_inv, L_inv, _DYN_INV_CHUNK, sms)
    by_lanes = {}
    for lanes in (32, 64, 128, 256):
        p_l = plan._replace(lanes=lanes)
        errs.append(max_abs_err(fk.batch_inv_launch(a, BN254_FR, p_l), got))
        by_lanes[lanes] = time_ms(lambda p_l=p_l: fk.batch_inv_launch(a, BN254_FR, p_l), calls=10)
    del other
    # The plain version on the whole panel: its widened products hold ~45 GB
    # at the end, one at a time.
    errs.append(max_abs_err(got, fk.mont_batch_inv_plain(a, BN254_FR, 0, _DYN_INV_CHUNK)))
    inv_plain_ms = time_ms(
        lambda: fk.mont_batch_inv_plain(a, BN254_FR, 0, _DYN_INV_CHUNK), 3, warmup=0)
    fold_x = random_elements((2, 32768), BN254_FR, 54)
    fold_want = fk.mont_batch_inv(fold_x, BN254_FR, 0, 2)
    fold_by_lanes = {}
    for lanes in (32, 64, 128, 256):
        p_l = fk.batch_inv_plan(2, 32768, 2, sms)._replace(lanes=lanes)
        errs.append(max_abs_err(fk.batch_inv_launch(fold_x, BN254_FR, p_l), fold_want))
        fold_by_lanes[lanes] = time_ms(lambda p_l=p_l: fk.batch_inv_launch(fold_x, BN254_FR, p_l), calls=10)
    del fold_x, fold_want

    def batch_inv_products(x):
        """Montgomery products that batch inversion along axis 0 of x needs,
        however it is chunked: one Fermat chain for each column that holds a
        non-zero value, and three products (prefix, inverse, running inverse)
        for each non-zero value after its column's first."""
        per_column = (~(x == 0).all(-1)).sum(0)
        live = per_column > 0
        return int(live.sum().item()) * chain + 3 * int((per_column[live] - 1).sum().item())

    def batch_inv_design_products(x, plan):
        """Products the kernel runs under `plan`: a lane's row after its
        chunk's first costs one (backward) and two more where it is not zero
        (forward, backward); every thread of a block five rounds of two scan
        products, the warp's other totals, the other warps' totals
        (nw - 2 and one), its inverse; a block one chain and its grand total."""
        G, L = x.shape[0], x.shape[1]
        later = torch.ones(G, dtype=torch.bool, device=x.device)
        later[::plan.g] = False
        nonzero_later = int((~(x[later] == 0).all(-1)).sum().item())
        chunks = -(-G // plan.g)
        nw = plan.lanes // 32
        per_thread = 12 + (nw - 1 if nw > 1 else 0)
        return ((G - chunks) * L + 2 * nonzero_later + plan.blocks * plan.lanes * per_thread
                + plan.blocks * (chain + (nw > 1)))

    def batch_inv_depth(plan):
        """Dependent products on a block's path: forward, the scans (prefix
        and suffix side by side), the other totals, the chain's depth, the
        lane's inverse, backward."""
        nw = plan.lanes // 32
        return 2 * (plan.g - 1) + 5 + 1 + max(nw - 1, 0) + chain_depth + 1

    sched_first, sched_steps, sched_tail = fk.pow_schedule(P - 2)
    chain_depth = 4 + sum(sq + 1 for sq, _ in sched_steps) + sched_tail  # the table's tree is 4 deep
    needed = batch_inv_products(a)
    b_ms, b_by = bound(64 * G_inv * L_inv, needed * MADDS_PER_MONT_MUL)
    us_chain = candidates["carry_flag_even_odd"]["us_per_product_in_chain"]
    kernels["batch_inv"] = dict(
        name="batch_inv", route="cuda", source="acvm_tpu_torch/csrc/batch_inv.cu",
        replaces="acvm_tpu/fields/jnp_ops.py:259",
        shape=f"G={G_inv}, L={L_inv}, chunk={_DYN_INV_CHUNK} (the dyn path's level)",
        plan=plan._asdict(), chains=plan.blocks,
        max_abs_err=max(errs), edge_cases=len(errs),
        ms=time_ms(lambda: fk.mont_batch_inv(a, BN254_FR, 0, _DYN_INV_CHUNK)),
        ms_queued=by_chunk[_DYN_INV_CHUNK],
        ms_graph=graph_ms(lambda: fk.mont_batch_inv(a, BN254_FR, 0, _DYN_INV_CHUNK)),
        ms_by_chunk=by_chunk, plan_by_chunk=plans, ms_by_lanes=by_lanes,
        fold_2x32768_ms_by_lanes=fold_by_lanes,
        products_needed=needed, products_design=batch_inv_design_products(a, plan),
        products_by_chunk={g: batch_inv_design_products(a, fk.batch_inv_plan(G_inv, L_inv, g, sms)) for g in by_chunk},
        latency_floor_ms=batch_inv_depth(plan) * us_chain * 1e-3,
        latency_floor_from="dependent products on a block's path x int32.mont_mul_candidates"
                           ".carry_flag_even_odd.us_per_product_in_chain",
        plain_ms=inv_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del a, got
    torch.cuda.empty_cache()
    if "--fold-sweep" in sys.argv:
        # mont_inv_grouped's choice: n values as one pow launch, or folded into
        # g rows of n / g columns and one batch_inv launch.
        fold = {}
        for n in (16384, 65536, 262144, 1048576):
            x = random_elements((n,), BN254_FR, 53)
            row = {"pow": time_ms(lambda: fk.mont_pow(x, P - 2, BN254_FR))}
            for g in (2, 4, 8, 16, 32):
                xg = x.reshape(g, n // g, 8)
                row[f"batch_inv_g{g}"] = time_ms(lambda: fk.mont_batch_inv(xg, BN254_FR, 0, g))
            fold[n] = row
        emit({"fold_sweep": {"ms": fold}})
        del x, xg

    # -- 6c. dot ----------------------------------------------------------------
    E = B = 2048
    T1, T2 = 2, 1
    lv = random_elements((E, T1, B), BN254_FR, 4)
    m1 = random_elements((E, T2, B), BN254_FR, 5)
    m2 = random_elements((E, T2, B), BN254_FR, 6)
    lc = random_elements((E, T1), BN254_FR, 7)
    mc = random_elements((E, T2), BN254_FR, 8)
    qc = random_elements((E,), BN254_FR, 9)
    sc = random_elements((E,), BN254_FR, 10)
    errs = []
    step = 256  # the plain version widens every operand eightfold
    for scale in (None, sc):
        got = fk.mont_dot(lv, lc, m1, m2, mc, qc, scale, BN254_FR)
        for lo in range(0, E, step):
            s = slice(lo, lo + step)
            want = fk.mont_dot_plain(lv[s], lc[s], m1[s], m2[s], mc[s], qc[s],
                                     None if scale is None else scale[s], BN254_FR)
            errs.append(max_abs_err(got[s], want))
    errs.append(max_abs_err(fk.mont_dot(lv, lc, None, None, None, qc, None, BN254_FR)[:step],
                            fk.mont_dot_plain(lv[:step], lc[:step], None, None, None,
                                              qc[:step], None, BN254_FR)))
    errs.append(max_abs_err(fk.mont_dot(None, None, m1, m2, mc, qc, sc, BN254_FR)[:step],
                            fk.mont_dot_plain(None, None, m1[:step], m2[:step], mc[:step],
                                              qc[:step], sc[:step], BN254_FR)))
    dot_bytes = 32 * E * B * (T1 + 2 * T2 + 1) + 32 * E * (T1 + T2 + 1)
    b_ms, b_by = bound(dot_bytes, (T1 + 2 * T2) * MADDS_PER_MONT_MUL * E * B)
    sb_ms, _ = bound(dot_bytes + 32 * E, (T1 + 2 * T2 + 1) * MADDS_PER_MONT_MUL * E * B)
    kernels["dot"] = dict(
        name="dot", route="cuda", source="acvm_tpu_torch/csrc/dot.cu",
        replaces="acvm_tpu/fields/pallas_mul_v2.py:353",
        shape=f"E={E}, B={B}, T1={T1}, T2={T2}", max_abs_err=max(errs),
        ms=time_ms(lambda: fk.mont_dot(lv, lc, m1, m2, mc, qc, None, BN254_FR)),
        ms_queued=time_ms(lambda: fk.mont_dot(lv, lc, m1, m2, mc, qc, None, BN254_FR), calls=10),
        ms_with_scale=time_ms(lambda: fk.mont_dot(lv, lc, m1, m2, mc, qc, sc, BN254_FR)),
        plain_ms=time_ms(lambda: [fk.mont_dot_plain(
            lv[lo : lo + step], lc[lo : lo + step], m1[lo : lo + step], m2[lo : lo + step],
            mc[lo : lo + step], qc[lo : lo + step], None, BN254_FR) for lo in range(0, E, step)], 3),
        bound_ms=b_ms, bound_ms_with_scale=sb_ms, bound_by=b_by, library_ms=None)
    del lv, m1, m2, lc, mc, qc, sc, got, want
    torch.cuda.empty_cache()

    # -- 6d. mul_v1 (at the shape of mul) -----------------------------------------
    a = random_elements((n_mul,), BN254_FR, 1)
    b = random_elements((n_mul,), BN254_FR, 2)
    got = fk.mont_mul_v1(a, b)
    want = torch.cat([
        fk.mont_mul_v1_plain(a[i : i + (1 << 18)], b[i : i + (1 << 18)])
        for i in range(0, n_mul, 1 << 18)])
    torch.cuda.synchronize()
    errs = [max_abs_err(got, want),
            max_abs_err(fk.mont_mul_v1(a[:4096].reshape(64, 64, 8), b[7]),   # a broadcast operand
                        fk.mont_mul_v1_plain(a[:4096].reshape(64, 64, 8), b[7]))]
    b_ms, b_by = bound(96 * n_mul, MADDS_PER_MONT_MUL * n_mul)
    kernels["mul_v1"] = dict(
        name="mul_v1", route="cuda", source="acvm_tpu_torch/csrc/mul_v1.cu",
        replaces="acvm_tpu/fields/pallas_mul.py:359", shape=f"N={n_mul}",
        max_abs_err=max(errs),
        ms=time_ms(lambda: fk.mont_mul_v1(a, b)),
        ms_queued=time_ms(lambda: fk.mont_mul_v1(a, b), calls=10),
        plain_ms=time_ms(lambda: [fk.mont_mul_v1_plain(a[i : i + (1 << 18)], b[i : i + (1 << 18)])
                                  for i in range(0, n_mul, 1 << 18)], 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del a, b, got, want

    # -- 6e. dot_v1 (at the shape of dot: its 2 linear terms and 1 product) -------
    T = T1 + T2
    vals = random_elements((E, T, B), BN254_FR, 4)
    coeff = random_elements((E, T), BN254_FR, 7)
    qc = random_elements((E,), BN254_FR, 9)
    sc = random_elements((E,), BN254_FR, 10)
    errs = []
    for scale in (None, sc):
        got = fk.mont_dot_v1(vals, coeff, qc, scale, BN254_FR)
        for lo in range(0, E, step):
            s = slice(lo, lo + step)
            want = fk.mont_dot_v1_plain(vals[s], coeff[s], qc[s],
                                        None if scale is None else scale[s], BN254_FR)
            errs.append(max_abs_err(got[s], want))
    b_ms, b_by = bound(32 * E * B * (T + 1) + 32 * E * (T + 1), T * MADDS_PER_MONT_MUL * E * B)
    kernels["dot_v1"] = dict(
        name="dot_v1", route="cuda", source="acvm_tpu_torch/csrc/dot_v1.cu",
        replaces="acvm_tpu/fields/pallas_mul.py:331",
        shape=f"E={E}, B={B}, T={T}", max_abs_err=max(errs),
        ms=time_ms(lambda: fk.mont_dot_v1(vals, coeff, qc, None, BN254_FR)),
        ms_queued=time_ms(lambda: fk.mont_dot_v1(vals, coeff, qc, None, BN254_FR), calls=10),
        ms_with_scale=time_ms(lambda: fk.mont_dot_v1(vals, coeff, qc, sc, BN254_FR)),
        plain_ms=time_ms(lambda: [fk.mont_dot_v1_plain(
            vals[lo : lo + step], coeff[lo : lo + step], qc[lo : lo + step], None, BN254_FR)
            for lo in range(0, E, step)], 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del vals, coeff, qc, sc, got, want
    torch.cuda.empty_cache()

    # -- 6f. pt_add: the first round of one Pedersen tree ---------------------------
    # 2 generators x 64 windows = 128 points x 2,048 instances, gathered from
    # the generators' window tables as the solver gathers them (a permuted view,
    # one entry in 16 at infinity); points 0 and 1 carry the exceptional pairs
    # (P = Q, P = -Q at equal and at different Z, either or both at infinity,
    # generic pairs at random Z) in every lane.  The second round's operands
    # (general Z everywhere) are held against the plain version too.
    ec_ctx = LimbContext(BN254_FR, dev)
    ec_B = 2048
    tables = torch.stack([ec.window_table(host_gk.derive_generator(0, i), device=dev)
                          for i in range(2)])
    digits = torch.from_numpy(np.random.default_rng(21).integers(
        0, 16, size=(2 * ec.NUM_WINDOWS, ec_B))).to(dev)
    pts = ec._gather_window_entries(tables.reshape(2 * ec.NUM_WINDOWS, 16, 3, 8), digits)
    assert not pts.is_contiguous() and tuple(pts.shape) == (128, 3, ec_B, 8)
    pts[:2] = torch.from_numpy(exceptional_panel(ec_B)).to(dev)
    round1 = ec_fused.pt_add_pairs(pts)
    round2 = ec_fused.pt_add_pairs(round1)
    errs = [max_abs_err(round1, ec_fused.pt_add_pairs_plain(pts)),
            max_abs_err(round2, ec_fused.pt_add_pairs_plain(round1))]
    # In place over an operand (the ladder's acc + acc), against a fresh output.
    acc = round1.clone()
    ec_fused.pt_add_panels(acc, acc, out=acc)
    errs.append(max_abs_err(acc, ec_fused.pt_add_panels_plain(round1, round1)))
    torch.cuda.synchronize()

    def pt_add_products(Pp, Qp):
        """Montgomery products the complete addition needs on these pairs: none
        where either point is at infinity, else 8 to find H and r, then 7 for
        the doubling (H = r = 0) or 8 for the addition."""
        c = ec_ctx
        x1, y1, z1 = Pp[:, 0].contiguous(), Pp[:, 1].contiguous(), Pp[:, 2].contiguous()
        x2, y2, z2 = Qp[:, 0].contiguous(), Qp[:, 1].contiguous(), Qp[:, 2].contiguous()
        zz1, zz2 = c.mont_mul(z1, z1), c.mont_mul(z2, z2)
        h_zero = c.eq(c.mont_mul(x2, zz1), c.mont_mul(x1, zz2))
        r_zero = c.eq(c.mont_mul(c.mont_mul(y2, z1), zz1), c.mont_mul(c.mont_mul(y1, z2), zz2))
        inf = c.is_zero(z1) | c.is_zero(z2)
        per_pair = torch.where(inf, 0, torch.where(h_zero & r_zero, 15, 16))
        return int(per_pair.sum().item()), int(inf.sum().item()), int((~inf & h_zero & r_zero).sum().item())

    products, n_inf, n_dbl = pt_add_products(pts[0::2], pts[1::2])
    pts_c = pts.contiguous()
    pairs = 64 * ec_B
    b_ms, b_by = bound(288 * pairs, products * MADDS_PER_MONT_MUL)
    kernels["pt_add"] = dict(
        name="pt_add", route="cuda", source="acvm_tpu_torch/csrc/pt_add.cu",
        replaces="acvm_tpu/tpu/ec_pallas.py:167",
        shape=f"N=128 points (64 pairs), B={ec_B}", max_abs_err=max(errs),
        products_per_pair=products / pairs, pairs_with_infinity=n_inf, pairs_doubling=n_dbl,
        ms=time_ms(lambda: ec_fused.pt_add_pairs(pts)),
        ms_queued=time_ms(lambda: ec_fused.pt_add_pairs(pts), calls=10),
        ms_contiguous_panel=time_ms(lambda: ec_fused.pt_add_pairs(pts_c)),
        plain_ms=time_ms(lambda: ec_fused.pt_add_pairs_plain(pts), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del pts_c, round2, acc, tables, digits

    # -- 6g. pt_ladder: 2,048 lanes, one launch -----------------------------------
    # The edge scalars 0, 1, 2, n-1, n (the last addition meets P = -Q), n+1
    # (the last addition meets P = Q at another Z), 2^256-1 (the ladder does
    # not reduce) and (n+1)/2 each meet a base with Z = 1, a base with a random
    # Z, a base at infinity with junk in X and Y, and a first-round sum of the
    # tree above; every other lane has a random 256-bit scalar (half of them
    # with 28 leading zero bits) on the exceptional panel's points or such sums.
    lad_B = 2048
    edge = [0, 1, 2, N_ORDER - 1, N_ORDER, N_ORDER + 1, (1 << 256) - 1, (N_ORDER + 1) // 2]
    rng = np.random.default_rng(31)
    raw = rng.integers(0, 1 << 32, size=(lad_B, 8), dtype=np.uint64).astype(np.uint32)
    raw[1024:] &= np.uint32(0x0FFFFFFF)  # half the lanes: 28 leading zero bits
    scalars = torch.from_numpy(raw.view(np.int32)).to(dev)
    ex = torch.from_numpy(exceptional_panel(lad_B)).to(dev)
    base = torch.cat([ex[0, :, :512], ex[1, :, :512], round1[0, :, :1024]], dim=1).contiguous()
    edge_limbs = torch.from_numpy(fk.ints_to_limbs32(edge).copy()).to(dev)
    for case in (0, 1, 6):  # lane % 9 of the exceptional panel: generic, generic_z, p_infinity
        scalars[case : case + 9 * len(edge) : 9] = edge_limbs
    scalars[1024 : 1024 + len(edge)] = edge_limbs
    lad_point = (base[0], base[1], base[2])
    got = ec_fused.scalar_mul_fused(ec_ctx, lad_point, scalars)
    want = ec_fused.scalar_mul_fused_plain(ec_ctx, lad_point, scalars)
    torch.cuda.synchronize()
    errs = [max_abs_err(g, w) for g, w in zip(got, want)]
    base_inf, got_inf = ec.pt_is_inf(lad_point).tolist(), ec.pt_is_inf(got).tolist()
    assert base_inf[6] and not base_inf[0] and not base_inf[1]
    # 0 * P and n * P are infinity, (n + 1) * P is not; anything times infinity is.
    assert got_inf[0] and got_inf[9 * 4] and not got_inf[9 * 5] and all(got_inf[6 : 6 + 72 : 9])

    def ladder_work(point, k):
        """Montgomery products this ladder needs on these lanes, step by step
        with the accumulator the ladder really holds: a doubling 7 (none at
        infinity), an addition for a set bit 16, or 8 + 7 where it meets P = Q,
        none where either point is at infinity.  And the rounds each warp of
        the kernel runs (ec_fused.ladder_geometry: eight instances a warp): a
        step's doubling three where any of its instances is finite, the
        addition three more where any adds to a finite point, and three where
        any meets P = Q.  Returns (products, rounds of the longest warp)."""
        c = ec_ctx
        B_k = k.shape[0]
        warps = ec_fused.ladder_geometry(B_k)[0]
        base_inf = ec.pt_is_inf(point)
        acc = torch.zeros((1, 3, B_k, 8), dtype=torch.int32, device=dev)
        panel = ec.panel_of(point)[None]
        bits = ec.scalar_bits(k)
        rounds = torch.zeros(warps, dtype=torch.int64, device=dev)

        def any_in_warp(flags):
            padded = torch.zeros(warps * ec_fused.LADDER_TEAMS, dtype=torch.bool, device=dev)
            padded[:B_k] = flags
            return padded.reshape(warps, ec_fused.LADDER_TEAMS).any(1).to(torch.int64)

        total = 0
        for i in range(255, -1, -1):
            finite = ~c.is_zero(acc[0, 2])
            total += 7 * int(finite.sum().item())
            rounds += 3 * any_in_warp(finite)
            ec_fused.pt_add_panels(acc, acc, out=acc)
            live = bits[i] & ~base_inf & ~c.is_zero(acc[0, 2])
            if live.any():
                x1, y1, z1 = acc[0, 0], acc[0, 1], acc[0, 2]
                zz1, zz2 = c.mont_mul(z1, z1), c.mont_mul(point[2], point[2])
                same = live & (c.eq(c.mont_mul(point[0], zz1), c.mont_mul(x1, zz2))
                               & c.eq(c.mont_mul(c.mont_mul(point[1], z1), zz1),
                                      c.mont_mul(c.mont_mul(y1, point[2]), zz2)))
                total += int(torch.where(live, torch.where(same, 15, 16), 0).sum().item())
                rounds += 3 * any_in_warp(live) + 3 * any_in_warp(same)
            added = ec_fused.pt_add_panels(acc, panel)
            acc = torch.where(bits[i][None, None, :, None], added, acc)
        return total, int(rounds.max().item())

    # Batches of 1, 3 and 33: a lone team, a ragged team of a lone warp, a
    # ragged second warp.
    for B_small in (1, 3, 33):
        pt_small = tuple(c[:B_small].contiguous() for c in lad_point)
        errs += [max_abs_err(g, w) for g, w in zip(
            ec_fused.scalar_mul_fused(ec_ctx, pt_small, scalars[:B_small]),
            ec_fused.scalar_mul_fused_plain(ec_ctx, pt_small, scalars[:B_small]))]
    # The Schnorr path's own shape (gpu/ec.py's schnorr_verify): 2,048 public
    # keys k G in affine form (Z = R), scalars uniform below n.
    rng_k = np.random.default_rng(32)

    def below_n(count):
        vals = [int.from_bytes(rng_k.bytes(40), "little") % N_ORDER for _ in range(count)]
        return torch.from_numpy(fk.ints_to_limbs32(vals).copy()).to(dev)

    gen = host_gk.grumpkin.generator()
    g_panel = torch.from_numpy(np.stack([fk.int_to_limbs32(v * BN254_FR.r % P)
                                         for v in (gen[0], gen[1], 1)])).to(dev)
    keys = ec_fused.scalar_mul_fused_plain(
        ec_ctx, tuple(c[None].expand(lad_B, 8).contiguous() for c in g_panel), below_n(lad_B))
    kx, ky = ec.pt_to_affine(ec_ctx, keys)  # standard form, as the path's public keys arrive
    sch_point = (ec_ctx.to_mont(kx), ec_ctx.to_mont(ky), ec_ctx.r_limbs.expand_as(kx).contiguous())
    sch_k = below_n(lad_B)
    sch_got = ec_fused.scalar_mul_fused(ec_ctx, sch_point, sch_k)
    errs += [max_abs_err(g, w) for g, w in
             zip(sch_got, ec_fused.scalar_mul_fused_plain(ec_ctx, sch_point, sch_k))]
    assert not ec.pt_is_inf(sch_point).any() and not ec.pt_is_inf(sch_got).any()

    products, warp_rounds = ladder_work(lad_point, scalars)
    sch_products, sch_rounds = ladder_work(sch_point, sch_k)
    b_ms, b_by = bound((96 + 32 + 96) * lad_B, products * MADDS_PER_MONT_MUL)
    kernels["pt_ladder"] = dict(
        name="pt_ladder", route="cuda", source="acvm_tpu_torch/csrc/pt_ladder.cu",
        replaces="acvm_tpu/tpu/ec_pallas.py:179",
        shape=f"B={lad_B}, 256 bits, half the lanes with 28 leading zero bits",
        geometry=dict(zip(("blocks", "threads", "masked_teams"), ec_fused.ladder_geometry(lad_B))),
        max_abs_err=max(errs), products_per_lane=products / lad_B,
        ms=time_ms(lambda: ec_fused.scalar_mul_fused(ec_ctx, lad_point, scalars)),
        ms_queued=time_ms(lambda: ec_fused.scalar_mul_fused(ec_ctx, lad_point, scalars), calls=10),
        ms_graph=graph_ms(lambda: ec_fused.scalar_mul_fused(ec_ctx, lad_point, scalars), launches=5),
        warp_rounds=warp_rounds,
        latency_floor_ms=warp_rounds * us_chain * 1e-3,
        latency_floor_from="rounds of the longest warp x int32.mont_mul_candidates"
                           ".carry_flag_even_odd.us_per_product_in_chain",
        schnorr_shape=dict(
            shape=f"B={lad_B}, affine keys (Z = R), scalars uniform below n",
            products_per_lane=sch_products / lad_B, warp_rounds=sch_rounds,
            ms_queued=time_ms(lambda: ec_fused.scalar_mul_fused(ec_ctx, sch_point, sch_k), calls=10),
            ms_graph=graph_ms(lambda: ec_fused.scalar_mul_fused(ec_ctx, sch_point, sch_k), launches=5),
            latency_floor_ms=sch_rounds * us_chain * 1e-3,
            bound_ms=bound((96 + 32 + 96) * lad_B, sch_products * MADDS_PER_MONT_MUL)[0]),
        plain_ms=time_ms(lambda: ec_fused.scalar_mul_fused_plain(ec_ctx, lad_point, scalars), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    sch_panel = ec.panel_of(sch_point)  # kept for --parent's Schnorr-shaped pair
    del pts, round1, ex, base, scalars, got, want, lad_point, keys, sch_point, sch_got
    torch.cuda.empty_cache()

    # -- 6h. level at wide gates ------------------------------------------------------
    # Gates of 1-32 linear terms with every coefficient and operand p - 1 (where
    # a lazy one-chain sum would overflow), with product terms, padding terms
    # and a ragged batch; then the unrolled shape (2 linear terms, 1 product),
    # whose three products BN254 sums unreduced, with a gate at p - 1 throughout
    # and rows that start off a 16-byte boundary.
    from acvm_tpu_torch.gpu.fused_level import pack_level_desc

    def level_err(params, panel, num, u_idx, t1, t2, skip=0):
        desc = torch.from_numpy(pack_level_desc(dict(num=num, u_idx=u_idx))).to(dev)[skip:]
        want = fused_level_plain(panel.clone(), desc, params, t1, t2)
        got = fused_level_call(panel.clone(), desc, params, t1, t2)
        torch.cuda.synchronize()
        return max_abs_err(got, want)

    wide_errs = []
    for params in (BN254_FR, BLS12_381_FR):
        p_minus_1 = fk.int_to_limbs32(params.modulus - 1)
        wide_NW, wide_B = 64, 200
        panel = random_elements((wide_NW, wide_B), params, 41)
        panel[1:21] = torch.from_numpy(p_minus_1.copy()).to(dev)
        counts = (15, 18, 19, 32, 1, 2, 3, 4, 5, 6, 10, 11)
        n_wide, wt1, wt2 = len(counts), 32, 1
        lin_idx = np.zeros((n_wide, wt1), np.int32)
        lin_c = np.zeros((n_wide, wt1, 8), np.int32)
        for g, n in enumerate(counts):
            lin_idx[g, :n] = 1 + np.arange(n) % 20
            lin_c[g, :n] = p_minus_1
        mul_c = np.zeros((n_wide, wt2, 8), np.int32)
        mul_c[0::2, 0] = p_minus_1  # every other gate has its product term, the rest padding
        num = dict(lin_idx=lin_idx, mul_idx=np.tile(np.array([[[3, 30]]], np.int32), (n_wide, 1, 1)),
                   lin_coeff=lin_c, mul_coeff=mul_c, qc=np.tile(p_minus_1, (n_wide, 1)))
        wide_errs.append(level_err(params, panel, num, np.arange(40, 40 + n_wide, dtype=np.int32), wt1, wt2))
        rng = np.random.default_rng(43)
        n_small = 37
        lc = random_elements((n_small, 2), params, 44).cpu().numpy()
        mc = random_elements((n_small, 1), params, 45).cpu().numpy()
        lc[3, 1] = 0
        lc[4] = 0
        mc[4] = mc[5] = 0
        lc[1:3], mc[1:3] = p_minus_1, p_minus_1
        small_lin = rng.integers(0, 25, size=(n_small, 2)).astype(np.int32)
        small_mul = rng.integers(0, 25, size=(n_small, 1, 2)).astype(np.int32)
        small_lin[1:3], small_mul[1:3] = [1, 2], [3, 4]  # rows of p - 1
        num = dict(lin_idx=small_lin, mul_idx=small_mul,
                   lin_coeff=lc, mul_coeff=mc, qc=random_elements((n_small,), params, 46).cpu().numpy())
        for skip in (0, 1):
            wide_errs.append(level_err(params, panel, num, np.arange(25, 25 + n_small, dtype=np.int32), 2, 1, skip))
    assert max(wide_errs) == 0, wide_errs

    def check_instances(circuit, inputs, res, instances):
        """Full witness maps of the given instances against the evaluator."""
        for b in instances:
            want, failed = evaluate(circuit, inputs[b], P)
            assert failed is None, (b, failed)
            got = res.instance_ints(b)
            bad = [k for k, v in want.items() if got[k] != v]
            assert not bad, f"instance {b}: {len(bad)} witnesses differ, first {bad[:3]}"
            assert len(want) == circuit.num_vars() - 1  # every witness but index 0

    def dot_check(W, pack, params):
        """mont_dot against its plain version on the operands eval_exprs
        gathers from the panel W for a packed expression panel."""
        E, B = pack["qc"].shape[0], W.shape[1]
        n, m = pack["lin_idx"].shape[1], pack["mul_idx"].shape[1]

        def take(idx, t):
            return W.index_select(0, idx.reshape(-1)).reshape(E, t, B, 8) if t else None

        args = (take(pack["lin_idx"], n), pack["lin_coeff"] if n else None,
                take(pack["mul_idx"][:, :, 0], m), take(pack["mul_idx"][:, :, 1], m),
                pack["mul_coeff"] if m else None, pack["qc"], None, params)
        err = max_abs_err(fk.mont_dot(*args), fk.mont_dot_plain(*args))
        return dict(shape=f"E={E}, T1={n}, T2={m}, B={B}", max_abs_err=err)

    def level_check(W, buf, params):
        """The level kernel against its plain version on a solved panel: the
        level's gates read only earlier witnesses, so both solve them again."""
        t1, t2 = buf["t1"], buf["t2"]
        got = fused_level_call(W.clone(), buf["desc"], params, t1, t2)
        want = fused_level_plain(W.clone(), buf["desc"], params, t1, t2, gate_chunk=512)
        err = max_abs_err(got, want)
        return dict(shape=f"E={buf['desc'].shape[0]}, T1={t1}, T2={t2}, NW={W.shape[0]}, B={W.shape[1]}",
                    max_abs_err=err)

    def timed_rate(fn, work, reps=5):
        """work / median wall seconds of fn(), which must end synchronized."""
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return work / statistics.median(times), statistics.median(times)

    def profile(run, wall_seconds):
        """One run() under torch.profiler: device time by kernel (the top 8, and
        every kernel of the port's own, whatever its rank) and the share of the
        timed wall clock the device was busy.  Warm-up runs go first under the
        profiler, their events discarded, for at least 0.1 s: a trace misses
        the launches of its first milliseconds (with none, a one-launch solve
        traced nothing and a 36-level solve lost its first 5 levels; with one
        warm-up run, the one-launch solve still nothing)."""
        from torch.profiler import ProfilerActivity, profile as torch_profile, schedule

        warmup = max(1, min(1000, math.ceil(0.1 / max(wall_seconds, 1e-6))))
        traced = []
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           schedule=schedule(wait=0, warmup=warmup, active=1),
                           on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
            for _ in range(warmup + 1):
                run()
                prof.step()
        from torch.autograd import DeviceType

        # Kernel rows only: an operator's row repeats its kernels' device time,
        # and the step's own annotation spans the whole step.
        rows = [(e.key, e.device_time_total / 1e3, e.count) for e in traced[0]
                if e.device_type == DeviceType.CUDA and e.device_time_total > 0
                and not e.key.startswith("ProfilerStep")]
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        return {"device_busy_ms": busy_ms, "wall_ms": wall_seconds * 1e3,
                "device_busy_share": busy_ms / (wall_seconds * 1e3),
                "kernel_launches": sum(r[2] for r in rows),
                "top": [{"kernel": k[:60], "ms": ms, "calls": n} for k, ms, n in rows[:8]],
                "port_kernels": [{"kernel": k[:60], "ms": ms, "calls": n} for k, ms, n in rows
                                 if port_kernel.search(k)]}

    want_profile = "--profile" in sys.argv
    parent_tree = next((a.split("=", 1)[1] for a in sys.argv if a.startswith("--parent=")), None)
    # The port's own kernels, by their symbols in the sources of build.KERNELS.
    port_kernel = re.compile(r"\b(%s)\b" % "|".join(sorted({sym for name in build.KERNELS for sym in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", build.source_path(name).read_text())})))

    # -- 4. path_static -----------------------------------------------------------
    batch = 2048
    circuit = build_wide_arith_circuit(num_inputs=128, num_levels=8, gates_per_level=8192,
                                       seed=1234)
    t0 = time.perf_counter()
    solver = BatchSolver(plan_circuit(circuit))
    plan_seconds = time.perf_counter() - t0
    inputs = random_inputs(circuit, batch)
    build.reset_launches()
    res = pass_peak("static", lambda: solver.solve(inputs), batch, inputs=inputs)
    torch.cuda.synchronize()
    static_launches = dict(build.LAUNCHES)
    assert res.ok.all() and (res.fail == FAIL_NONE).all()
    assert static_launches["level"] == 8, static_launches
    check_instances(circuit, inputs, res, (0, batch - 1))
    gates = len(circuit.opcodes)

    # The level kernel against its plain version on a real level of this
    # circuit: the one with the most gates (the planner levelizes by
    # dependency, so its levels are not the generator's 8 x 8,192).
    static_levels = [lv["arith_static"] for seg in solver.segments for lv in seg.levels]
    level_gates = [int(lv["desc"].shape[0]) for lv in static_levels]
    widest = static_levels[level_gates.index(max(level_gates))]
    desc, t1, t2 = widest["desc"], widest["t1"], widest["t2"]
    assert desc.shape[0] >= 1024, level_gates
    W = res.panel
    n_cmp = 1024
    out_rows = desc[:n_cmp, t1 + 2 * t2].to(torch.int64)
    solved = W.index_select(0, out_rows)
    W.index_fill_(0, desc[:, t1 + 2 * t2].to(torch.int64), 0)  # unsolve the level
    fused_level_plain(W, desc[:n_cmp], BN254_FR, t1, t2, gate_chunk=128)
    want = W.index_select(0, out_rows)
    W.index_fill_(0, out_rows, 0)
    level_ms = time_ms(lambda: fused_level_call(W, desc, BN254_FR, t1, t2))
    level_ms_queued = time_ms(lambda: fused_level_call(W, desc, BN254_FR, t1, t2), calls=10)
    got = W.index_select(0, out_rows)
    plain_level_ms = time_ms(
        lambda: fused_level_plain(W, desc, BN254_FR, t1, t2, gate_chunk=512), 3, warmup=0)
    # What this level's data needs: a term with a zero coefficient is padding
    # (gates are packed to the widest) and costs neither operand rows nor
    # products; an operand row shared by several gates is read once.
    level_E = desc.shape[0]
    o = t1 + 2 * t2 + 1
    lin_live = (desc[:, o : o + 8 * t1].reshape(level_E, t1, 8) != 0).any(-1)
    mul_live = (desc[:, o + 8 * t1 : o + 8 * (t1 + t2)].reshape(level_E, t2, 8) != 0).any(-1)
    read_rows = torch.unique(torch.cat([
        desc[:, :t1][lin_live], desc[:, t1 : t1 + 2 * t2].reshape(level_E, t2, 2)[mul_live].reshape(-1),
    ])).numel()
    products = int(lin_live.sum() + 2 * mul_live.sum())
    b_ms, b_by = bound(32 * batch * (read_rows + level_E) + desc.numel() * 4,
                       products * MADDS_PER_MONT_MUL * batch)
    kernels["level"] = dict(
        name="level", route="cuda", source="acvm_tpu_torch/csrc/level.cu",
        replaces="acvm_tpu/tpu/fused_level.py:177",
        shape=f"NW={W.shape[0]}, B={batch}, E={level_E}, t1={t1}, t2={t2}",
        products_per_gate=products / level_E, operand_rows=read_rows,
        max_abs_err=max(max_abs_err(got, want), max_abs_err(got, solved), *wide_errs),
        wide_gate_cases=len(wide_errs), ms=level_ms, ms_queued=level_ms_queued, plain_ms=plain_level_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    if "--level-variants" in sys.argv:
        # The level kernel rebuilt with its measurement switches, at the timed
        # shape.  The variants write wrong values or none: the panel is not
        # read again after this.
        words = fk._host_ptr(fk.field_words(BN254_FR))
        variants = {"as_built": None, "loads_and_store_only": ["ACVM_LEVEL_NO_PRODUCTS"],
                    "products_only_cached_operands": ["ACVM_LEVEL_CACHED_OPERANDS"],
                    "gates_fastest_block_order": ["ACVM_LEVEL_GATES_FASTEST"],
                    "loads_ahead": ["ACVM_LEVEL_PREFETCH=1"],
                    "64_instances_a_block": ["ACVM_LEVEL_THREADS=64"],
                    "64_instances_gates_fastest": ["ACVM_LEVEL_THREADS=64", "ACVM_LEVEL_GATES_FASTEST"],
                    "64_instances_gates_fastest_loads_only": [
                        "ACVM_LEVEL_THREADS=64", "ACVM_LEVEL_GATES_FASTEST", "ACVM_LEVEL_NO_PRODUCTS"]}
        times = {}
        for name, defines in variants.items():
            if defines is None:
                times[name] = time_ms(lambda: fused_level_call(W, desc, BN254_FR, t1, t2))
                continue
            fn = build.load_variant("level", defines)

            def run_variant():
                err = fn(W.data_ptr(), desc.data_ptr(), level_E, batch, t1, t2, words,
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, (name, err)

            times[name] = time_ms(run_variant)
        emit({"level_variants": {"shape": kernels["level"]["shape"], "ms": times}})
    del W, got, want, solved

    state = solver.initial_state(inputs)
    rate, secs = timed_rate(device_solve_of(solver, state, torch), batch * gates)
    rate_full, secs_full = timed_rate(lambda: solver.solve(inputs), batch * gates, reps=3)
    if want_profile:
        emit({"profile_static": profile(device_solve_of(solver, state, torch), secs)})
    emit({"path_static": {
        "gates": gates, "batch": batch, "levels": len(solver.plan.levels),
        "level_gates": level_gates, "ok": True, "checked_instances": [0, batch - 1], "launches": static_launches,
        "plan_and_pack_seconds": plan_seconds,
        "witness_solves_per_sec": rate, "solve_seconds": secs,
        "witness_solves_per_sec_with_packing": rate_full, "solve_seconds_with_packing": secs_full,
        "panel_bytes": solver.panel_bytes(batch),
        "peak_device_bytes": torch.cuda.max_memory_allocated()}})
    del state, res, solver
    torch.cuda.empty_cache()

    # -- 5. path_dyn --------------------------------------------------------------
    circuit = build_wide_arith_circuit(num_inputs=128, num_levels=4, gates_per_level=4096,
                                       dyn_fraction=0.5, seed=1234)
    solver = BatchSolver(plan_circuit(circuit))
    inputs = random_inputs(circuit, batch)
    build.reset_launches()
    res = pass_peak("dyn", lambda: solver.solve(inputs), batch, inputs=inputs)
    torch.cuda.synchronize()
    dyn_launches = dict(build.LAUNCHES)
    assert res.ok.all() and (res.fail == FAIL_NONE).all()
    # A level inverts its denominators in one batch_inv launch; mul is left
    # with to_mont(den) and -num * den^-1.
    assert dyn_launches["batch_inv"] == 4 and dyn_launches["mul"] == 8, dyn_launches
    assert dyn_launches["pow"] == 0, dyn_launches
    for name in ("level", "dot"):
        assert dyn_launches[name] > 0, dyn_launches
    check_instances(circuit, inputs, res, (0, batch - 1))
    gates = len(circuit.opcodes)
    state = solver.initial_state(inputs)
    rate, secs = timed_rate(device_solve_of(solver, state, torch), batch * gates)
    if want_profile:
        emit({"profile_dyn": profile(device_solve_of(solver, state, torch), secs)})
    del state, res, solver

    # Chosen failures: opcode 0 solves w4 from w1*w4 + w2 = 0 (runtime
    # denominator w1), opcode 1 asserts w3 - w2 = 0.
    fe = FieldElement
    small = Circuit(
        current_witness_index=4,
        opcodes=[
            ops.OpcodeArithmetic(Expression(
                mul_terms=[(fe(1), Witness(1), Witness(4))],
                linear_combinations=[(fe(1), Witness(2))], q_c=fe(0))),
            ops.OpcodeArithmetic(Expression(
                linear_combinations=[(fe(1), Witness(3)), (-fe(1), Witness(2))], q_c=fe(0))),
        ],
        private_parameters={Witness(1), Witness(2), Witness(3)},
    )
    cases = [  # (w1, w2, w3)
        (0, 5, 5), (2, 4, 7), (0, 0, 0), (0, 3, 9), (3, 6, 6), (P - 1, 1, 1),
    ]
    small_inputs = [{1: a, 2: b, 3: c} for a, b, c in cases]
    res = BatchSolver(plan_circuit(small)).solve(small_inputs)
    want_fail = []
    for b, inp in enumerate(small_inputs):
        w, failed = evaluate(small, inp, P)
        want_fail.append(int(FAIL_NONE) if failed is None else failed)
        assert res.witness_ints(4)[b] == w[4], (b, res.witness_ints(4)[b], w[4])
    assert want_fail == [0, 1, int(FAIL_NONE), 0, int(FAIL_NONE), int(FAIL_NONE)]
    assert res.fail.tolist() == want_fail, (res.fail.tolist(), want_fail)
    assert res.ok.tolist() == [f == int(FAIL_NONE) for f in want_fail]
    assert res.error_location(1).acir_index == 1 and res.error_location(2) is None
    emit({"path_dyn": {
        "gates": gates, "batch": batch, "dyn_fraction": 0.5, "ok": True,
        "checked_instances": [0, batch - 1], "launches": dyn_launches,
        "dyn_solves_per_sec": rate, "solve_seconds": secs,
        "failing_instances": {"fail": want_fail, "ok": res.ok.tolist()}}})

    # -- 6. path_dyn_v1 -------------------------------------------------------------
    # The solve gates of the generated circuit evaluate linear expressions only
    # (a quadratic term there holds the unknown), so 256 of its quadratic
    # constraints are stated once more: as assert-zero checks over known
    # witnesses they need the operand pre-multiply of the v1 route.
    circuit = with_repeated_constraints(
        build_wide_arith_circuit(num_inputs=128, num_levels=2, gates_per_level=4096,
                                 dyn_fraction=0.5, seed=1234), 256)
    plan = plan_circuit(circuit)
    inputs = random_inputs(circuit, batch)
    res_v2 = BatchSolver(plan).solve(inputs)
    solver = BatchSolver(plan, dot_kernel="v1")
    build.reset_launches()
    res = solver.solve(inputs)
    torch.cuda.synchronize()
    v1_launches = dict(build.LAUNCHES)
    assert res.ok.all() and (res.fail == FAIL_NONE).all()
    assert v1_launches["dot_v1"] > 0 and v1_launches["mul_v1"] > 0, v1_launches
    assert v1_launches["dot"] == 0, v1_launches
    assert v1_launches["batch_inv"] == 2 and v1_launches["mul"] == 4, v1_launches
    assert torch.equal(res.panel, res_v2.panel) and np.array_equal(res.fail, res_v2.fail)
    check_instances(circuit, inputs, res, (0, batch - 1))
    gates = len(circuit.opcodes)
    state = solver.initial_state(inputs)
    rate, secs = timed_rate(device_solve_of(solver, state, torch), batch * gates, reps=3)
    emit({"path_dyn_v1": {
        "gates": gates, "batch": batch, "dyn_fraction": 0.5, "repeated_constraints": 256,
        "dot_kernel": "v1", "ok": True, "equals_v2_panel": True,
        "checked_instances": [0, batch - 1], "launches": v1_launches,
        "dyn_solves_per_sec": rate, "solve_seconds": secs}})
    del state, res, res_v2, solver
    torch.cuda.empty_cache()

    # -- 7. path_ec -------------------------------------------------------------------
    ec_launches = {}
    ec_report = {}

    def solve_gadgets(kind, num_gadgets, B, edit=None):
        circuit = build_gadget_circuit(kind, num_gadgets, msg_len=32)
        cols = gadget_inputs_columnar(circuit, B, kind)
        if edit is not None:
            cols = {w: a.astype(object) for w, a in cols.items()}
            edit(circuit, cols)
        t0 = time.perf_counter()
        solver = BatchSolver(plan_circuit(circuit))
        plan_seconds = time.perf_counter() - t0
        build.reset_launches()
        res = pass_peak(f"ec_{kind}", lambda: solver.solve(cols), B, inputs=cols)
        torch.cuda.synchronize()
        return circuit, cols, solver, res, dict(build.LAUNCHES), plan_seconds

    def host_outputs(kind, call, inst):
        """The gadget's outputs for one instance from the host curve code."""
        if kind == "fixed_base":
            x, y = host_gk.fixed_base_scalar_mul(
                fe(inst[int(call.low.witness)]), fe(inst[int(call.high.witness)]))
            return {int(call.outputs[0]): int(x), int(call.outputs[1]): int(y)}
        if kind == "pedersen":
            x, y = host_gk.pedersen_commit(
                [fe(inst[int(fi.witness)]) for fi in call.inputs], call.domain_separator)
            return {int(call.outputs[0]): int(x), int(call.outputs[1]): int(y)}
        good = host_gk.schnorr_verify(
            fe(inst[int(call.public_key_x.witness)]), fe(inst[int(call.public_key_y.witness)]),
            bytes(inst[int(fi.witness)] for fi in call.signature),
            bytes(inst[int(fi.witness)] for fi in call.message))
        return {int(call.output): int(good)}

    def check_gadget_instances(kind, circuit, cols, res, instances):
        for b in instances:
            inst, got = columnar_instance(cols, b), res.instance_ints(b)
            for opcode in circuit.opcodes:
                for w, v in host_outputs(kind, opcode.call, inst).items():
                    assert got[w] == v, (kind, b, w)

    for kind, num_gadgets, B in (("pedersen", 2, 2048), ("fixed_base", 4, 4096),
                                 ("schnorr", 2, 1024)):
        circuit, cols, solver, res, launches, plan_seconds = solve_gadgets(kind, num_gadgets, B)
        assert res.ok.all() and (res.fail == FAIL_NONE).all(), kind
        assert launches["pt_add"] > 0 and launches["pow"] > 0, (kind, launches)
        if kind == "schnorr":
            # One gadget level: one ladder launch, and pt_add only for the two
            # trees (6 + 8 rounds) and R = sG + eP: 527 before the ladder kernel.
            # The challenge's BLAKE2s: one blake2s launch a level.
            assert launches["pt_ladder"] == 1 and launches["pt_add"] == 15, launches
            assert launches["blake2s"] == 1, launches
        else:
            assert launches["pt_ladder"] == 0 and launches["blake2s"] == 0, (kind, launches)
        check_gadget_instances(kind, circuit, cols, res, (0, B - 1))
        state = solver.initial_state(cols)
        rate, secs = timed_rate(device_solve_of(solver, state, torch), num_gadgets * B, reps=3)
        rate_full, secs_full = timed_rate(lambda: solver.solve(cols), num_gadgets * B, reps=3)
        if want_profile:
            emit({f"profile_ec_{kind}": profile(device_solve_of(solver, state, torch), secs)})
        ec_launches[kind] = launches
        ec_report[kind] = {
            "gadgets": num_gadgets, "batch": B, "ok": True, "checked_instances": [0, B - 1],
            "launches": launches, "plan_and_tables_seconds": plan_seconds,
            "gadget_solves_per_sec": rate, "solve_seconds": secs,
            "gadget_solves_per_sec_with_packing": rate_full,
            "solve_seconds_with_packing": secs_full}
        del state, res, solver
        torch.cuda.empty_cache()

    # Schnorr: a flipped signature byte (gadget 0, instances 3 and 100) and an
    # off-curve key (gadget 1, instance 7) verify false there and true
    # everywhere else; the instance is still solved (ok).
    def forge(circuit, cols):
        c0, c1 = circuit.opcodes[0].call, circuit.opcodes[1].call
        for b, j in ((3, 5), (100, 40)):  # byte 5 lies in s, byte 40 in e
            cols[int(c0.signature[j].witness)][b] ^= 1
        cols[int(c1.public_key_y.witness)][7] += 1

    circuit, cols, _, res, _, _ = solve_gadgets("schnorr", 2, 128, edit=forge)
    assert res.ok.all() and (res.fail == FAIL_NONE).all()
    want = [[1] * 128, [1] * 128]
    want[0][3] = want[0][100] = want[1][7] = 0
    got = [res.witness_ints(int(op.call.output)) for op in circuit.opcodes]
    assert got == want, "forged signatures"
    check_gadget_instances("schnorr", circuit, cols, res, (3, 7, 100))

    # Fixed base: a limb past 2^128 (gadget 1, instance 5) and a scalar equal to
    # the group order (gadget 2, instance 9) fail their instance at that opcode
    # and write zeros; the order minus one (gadget 3, instance 11) is valid.
    def out_of_range(circuit, cols):
        calls = [op.call for op in circuit.opcodes]
        cols[int(calls[1].high.witness)][5] = 1 << 128
        for call, b, scalar in ((calls[2], 9, N_ORDER), (calls[3], 11, N_ORDER - 1)):
            cols[int(call.low.witness)][b] = scalar & ((1 << 128) - 1)
            cols[int(call.high.witness)][b] = scalar >> 128

    circuit, cols, _, res, _, _ = solve_gadgets("fixed_base", 4, 64, edit=out_of_range)
    want_fail = [int(FAIL_NONE)] * 64
    want_fail[5], want_fail[9] = 1, 2
    assert res.fail.tolist() == want_fail, res.fail.tolist()
    assert res.ok.tolist() == [f == int(FAIL_NONE) for f in want_fail]
    assert res.error_location(9).acir_index == 2 and res.error_location(11) is None
    calls = [op.call for op in circuit.opcodes]
    for call, b in ((calls[1], 5), (calls[2], 9)):
        assert [res.witness_ints(int(w))[b] for w in call.outputs] == [0, 0]
    check_gadget_instances("fixed_base", circuit, cols, res, (0, 11, 63))
    for b, skip in ((5, 1), (9, 2)):  # the failing instance's other gadgets still solve
        inst, got = columnar_instance(cols, b), res.instance_ints(b)
        for g, call in enumerate(calls):
            if g != skip:
                for w, v in host_outputs("fixed_base", call, inst).items():
                    assert got[w] == v, (b, g)
    emit({"path_ec": {**ec_report,
                      "forged_signatures": {"batch": 128, "false_at": {"gadget 0": [3, 100], "gadget 1": [7]}, "ok": True},
                      "invalid_scalars": {"batch": 64, "fail": {"5": 1, "9": 2}, "outputs_zeroed": True}}})

    # -- 8. path_int ------------------------------------------------------------------
    # The u32 circuit (8 rounds x 1,024 units, 98,432 opcodes) over 1,024
    # instances; input witness 6 of instance 3 is 2^32 + 5, which fails its
    # Range opcode (index 5).  The Quotient levels divide with the divmod
    # kernel, once a level, and the plain division never runs on the card.
    int_B, rounds, bad_b, bad_w = 1024, 8, 3, 6
    circuit = build_u32_circuit(num_rounds=rounds, units_per_round=1024, seed=1234)
    t0 = time.perf_counter()
    solver = BatchSolver(plan_circuit(circuit))
    plan_seconds = time.perf_counter() - t0
    inputs = u32_inputs(circuit, int_B)
    inputs[bad_b][bad_w] = (1 << 32) + 5
    build.reset_launches()
    intops.PLAIN_ON_CARD["long_divmod"] = 0
    res = pass_peak("int", lambda: solver.solve(inputs), int_B, inputs=inputs)
    torch.cuda.synchronize()
    int_launches = dict(build.LAUNCHES)
    plain_on_card = intops.PLAIN_ON_CARD["long_divmod"]
    quotient_levels = [lv["quotient"] for seg in solver.segments for lv in seg.levels
                       if "quotient" in lv["kinds"]]
    assert len(quotient_levels) == rounds and int_launches["divmod"] == rounds, int_launches
    assert plain_on_card == 0, plain_on_card
    for name in ("level", "dot"):
        assert int_launches[name] > 0, int_launches
    want_fail = [int(FAIL_NONE)] * int_B
    want_fail[bad_b] = bad_w - 1
    assert res.fail.tolist() == want_fail and res.ok.tolist() == [f == int(FAIL_NONE) for f in want_fail]
    for b in (0, bad_b, int_B - 1):
        want, failed = evaluate(circuit, inputs[b], P)
        assert failed == (bad_w - 1 if b == bad_b else None), (b, failed)
        got = res.instance_ints(b)
        assert len(want) == circuit.num_vars() - 1
        bad = [k for k, v in want.items() if got[k] != v]
        assert not bad, f"u32 instance {b}: {len(bad)} witnesses differ, first {bad[:3]}"
    opcodes = len(circuit.opcodes)

    # divmod against its plain version, tolerance 0: a quotient level's
    # operands (1,024 gates x 1,024 instances); the edge set at the Quotient's
    # and Brillig's widths, against Python ints too; the word-length grid, 1,024
    # pairs for each pair of word lengths (m, n) in 1..8; and the second timed
    # shape, 2^20 random 256-bit dividends over random 128-bit divisors, as the
    # Brillig VM's 256-bit division can give them.
    from acvm_tpu_torch.gpu.batch_solver import eval_exprs

    qa = eval_exprs(solver.ctx, res.panel, quotient_levels[0]["a"])
    qb = eval_exprs(solver.ctx, res.panel, quotient_levels[0]["b"])
    build.reset_launches()
    got_q, got_r = intops.long_divmod(qa, qb)
    want_q, want_r = intops.long_divmod_plain(qa, qb)
    torch.cuda.synchronize()
    errs = [max_abs_err(got_q, want_q), max_abs_err(got_r, want_r)]
    ea, eb = divmod_edge_operands(P)
    ta = torch.from_numpy(fk.ints_to_limbs32(ea).copy()).to(dev)
    tb = torch.from_numpy(fk.ints_to_limbs32(eb).copy()).to(dev)
    widths = (256, 254, 128, 64, 32, 8)
    for bits in widths:
        q, r = intops.long_divmod(ta, tb, num_bits=bits)
        pq, pr = intops.long_divmod_plain(ta, tb, num_bits=bits)
        errs += [max_abs_err(q, pq), max_abs_err(r, pr)]
        m = (1 << bits) - 1
        ints = [divmod(x & m, y) if y else (0, 0) for x, y in zip(ea, eb)]
        assert list(zip(fk.limbs32_to_ints(q.cpu().numpy()), fk.limbs32_to_ints(r.cpu().numpy()))) == ints
    grid = [torch.from_numpy(fk.ints_to_limbs32(x).copy()).to(dev) for x in divmod_word_grid(1024)]
    for got, want in zip(intops.long_divmod(*grid), intops.long_divmod_plain(*grid)):
        errs.append(max_abs_err(got, want))
    rng = np.random.default_rng(7)
    wide = rng.integers(0, 1 << 32, size=(2, 1 << 20, 8), dtype=np.uint64).astype(np.uint32)
    wide[1, :, 4:] = 0
    wa, wb = torch.from_numpy(wide.view(np.int32)).to(dev)
    for got, want in zip(intops.long_divmod(wa, wb), intops.long_divmod_plain(wa, wb)):
        errs.append(max_abs_err(got, want))
    torch.cuda.synchronize()
    assert build.LAUNCHES["divmod"] == 3 + len(widths) and max(errs) == 0, (build.LAUNCHES["divmod"], errs)

    def division_work(a, b):
        """What word-level division of each element needs (csrc/divmod.cu):
        with m, n the words of a and b, nothing where b = 0 or m < n; else
        m - n + 1 digits (m where n = 1), each n multiply-adds and n + 1
        subtractions for q^ b and 3 operations for the estimate, the least a
        2-by-1 division takes (2n + 4), and m + 2n words shifted to normalise
        and back.
        Returns (digits, int32 operations) summed over the elements."""
        words = np.arange(1, 9)
        m = ((a.cpu().numpy().reshape(-1, 8) != 0) * words).max(1)
        n = ((b.cpu().numpy().reshape(-1, 8) != 0) * words).max(1)
        live = (n > 0) & (m >= n)
        digits = np.where(live, np.where(n == 1, m, m - n + 1), 0)
        ops = np.where(live, digits * (2 * n + 4) + m + 2 * n, 0)
        return int(digits.sum()), int(ops.sum())

    # 128 bytes an element (a, b in; q, r out) against the operations above.
    n_div = qa.numel() // 8
    digits, div_ops = division_work(qa, qb)
    b_ms, b_by = bound(128 * n_div, div_ops)
    wide_digits, wide_ops = division_work(wa, wb)
    wide_bound, wide_by = bound(128 * (1 << 20), wide_ops)
    kernels["divmod"] = dict(
        name="divmod", route="cuda", source="acvm_tpu_torch/csrc/divmod.cu",
        replaces="acvm_tpu/tpu/intops.py:134",
        shape=f"G={qa.shape[0]}, B={qa.shape[1]} (a quotient level of path_int), num_bits=256",
        digits_per_element=digits / n_div, ops_per_element=div_ops / n_div,
        edge_cases=len(ea), edge_widths=list(widths), grid_cases=grid[0].shape[0],
        max_abs_err=max(errs),
        ms=time_ms(lambda: intops.long_divmod(qa, qb)),
        ms_queued=time_ms(lambda: intops.long_divmod(qa, qb), calls=10),
        plain_ms=time_ms(lambda: intops.long_divmod_plain(qa, qb), 3, warmup=0),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        # The same 128 bytes an element through one copy (torch.cat of a and
        # b): what the card's memory gives a kernel that only moves them.
        copy_ms_queued=time_ms(lambda: torch.cat((qa, qb)), calls=10),
        brillig_shape=dict(
            shape="N=2^20, random 256-bit a over random 128-bit b, num_bits=256",
            digits_per_element=wide_digits / (1 << 20), ops_per_element=wide_ops / (1 << 20),
            ms=time_ms(lambda: intops.long_divmod(wa, wb)),
            ms_queued=time_ms(lambda: intops.long_divmod(wa, wb), calls=10),
            bound_ms=wide_bound, bound_by=wide_by))
    del qa, qb, got_q, got_r, want_q, want_r, wa, wb, res

    state = solver.initial_state(inputs)
    rate, secs = timed_rate(device_solve_of(solver, state, torch), opcodes * int_B)
    rate_full, secs_full = timed_rate(lambda: solver.solve(inputs), opcodes * int_B, reps=3)
    if want_profile:
        emit({"profile_int": profile(device_solve_of(solver, state, torch), secs)})
    emit({"path_int": {
        "opcodes": opcodes, "witnesses": circuit.num_vars() - 1, "batch": int_B,
        "rounds": rounds, "units_per_round": 1024, "levels": len(solver.plan.levels),
        "quotient_levels": len(quotient_levels), "ok": True,
        "checked_instances": [0, bad_b, int_B - 1], "failing_instance": {"instance": bad_b, "fail": bad_w - 1},
        "launches": int_launches, "plain_divmod_on_card": plain_on_card,
        "plan_and_pack_seconds": plan_seconds,
        "int_solves_per_sec": rate, "solve_seconds": secs,
        "int_solves_per_sec_with_packing": rate_full, "solve_seconds_with_packing": secs_full,
        "panel_bytes": solver.panel_bytes(int_B)}})
    del state, solver
    torch.cuda.empty_cache()

    # -- 9. path_sha ------------------------------------------------------------------
    # The compiler's SHA-256 fallback (28,980 opcodes: 8,297 straight-line
    # Brillig hints, range checks, AND/XOR, Quotient, ToLeRadix) over 4,096
    # random 32-byte messages, columnar.  Outputs of two instances against
    # hashlib, their full witness maps against the evaluator; one divmod launch
    # a Quotient level and no plain division on the card.
    sha_B = 4096
    circuit = build_sha256_circuit(32)
    t0 = time.perf_counter()
    solver = BatchSolver(plan_circuit(circuit))
    plan_seconds = time.perf_counter() - t0
    cols = sha256_inputs(sha_B)
    build.reset_launches()
    intops.PLAIN_ON_CARD["long_divmod"] = 0
    res = pass_peak("sha", lambda: solver.solve(cols), sha_B, inputs=cols)
    torch.cuda.synchronize()
    sha_launches = dict(build.LAUNCHES)
    plain_on_card = intops.PLAIN_ON_CARD["long_divmod"]
    levels = [lv for seg in solver.segments for lv in seg.levels]
    quotient_levels = sum("quotient" in lv["kinds"] for lv in levels)
    assert res.ok.all() and (res.fail == FAIL_NONE).all()
    assert sha_launches["divmod"] == quotient_levels == 748 and plain_on_card == 0, sha_launches
    for name in ("dot", "mul", "level"):
        assert sha_launches[name] > 0, sha_launches
    for b in (0, sha_B - 1):
        inst, got = columnar_instance(cols, b), res.instance_ints(b)
        digest = bytes(got[33 + i] for i in range(32))
        assert digest == hashlib.sha256(bytes(inst[i + 1] for i in range(32))).digest(), b
        want, failed = evaluate(circuit, inst, P)
        assert failed is None and len(want) == circuit.num_vars() - 1, (b, failed)
        bad = [k for k, v in want.items() if got[k] != v]
        assert not bad, f"sha instance {b}: {len(bad)} witnesses differ, first {bad[:3]}"
    blocks = sum(len(lv.brillig) for lv in solver.plan.levels)
    groups = sum(len(lv.get("brillig", [])) for lv in levels)

    # Each kernel of the path against its plain version, tolerance 0, at this
    # path's own shapes (B = 4,096, a few blocks a group): the operands of the
    # widest Brillig input panel that reads witnesses (a constant-only panel
    # launches nothing), of the largest Quotient level, of the field Mul of
    # the largest group that has one (and its to_mont), and the largest
    # static level, all taken again from the solved panel.
    from acvm_tpu_torch import brillig as br
    from acvm_tpu_torch.gpu.brillig_trace import BrilligProgram, trace_brillig

    ctx, params = solver.ctx, solver.ctx.params
    brillig_bufs = [buf for lv in levels for buf in lv.get("brillig", [])]
    widest = max((pack for buf in brillig_bufs for pack in buf["inputs"]
                  if pack["lin_idx"].shape[1] or pack["mul_idx"].shape[1]),
                 key=lambda pack: pack["qc"].shape[0])
    sha_checks = {"dot": dot_check(res.panel, widest, params)}
    quot = max((lv["quotient"] for lv in levels if "quotient" in lv["kinds"]),
               key=lambda q: q["q_idx"].shape[0])
    qa, qb = eval_exprs(ctx, res.panel, quot["a"]), eval_exprs(ctx, res.panel, quot["b"])
    errs = [max_abs_err(x, y) for x, y in zip(intops.long_divmod(qa, qb), intops.long_divmod_plain(qa, qb))]
    sha_checks["divmod"] = dict(shape=f"G={qa.shape[0]}, B={qa.shape[1]}, num_bits=256", max_abs_err=max(errs))
    mul_at = [(buf, i) for buf in brillig_bufs for i, st in enumerate(buf["program"].steps)
              if st.bit_size is None and st.op == br.BinaryFieldOp.Mul]
    buf, i = max(mul_at, key=lambda t: t[0]["out_idx"][0].shape[0])
    step = buf["program"].steps[i]
    a, b = trace_brillig(ctx, BrilligProgram(buf["program"].steps[:i], [step.lhs, step.rhs]),
                         [eval_exprs(ctx, res.panel, pack) for pack in buf["inputs"]])
    am = ctx.to_mont(a)
    errs = [max_abs_err(am, fk.mont_mul_plain(a, ctx.r2_limbs, params)),
            max_abs_err(fk.mont_mul(am, b, params), fk.mont_mul_plain(am, b, params))]
    sha_checks["mul"] = dict(shape=f"G={a.shape[0]}, B={a.shape[1]}, b {tuple(b.shape)}",
                             max_abs_err=max(errs))
    static = max((lv["arith_static"] for lv in levels if "arith_static" in lv["kinds"]),
                 key=lambda s_: s_["desc"].shape[0])
    sha_checks["level"] = level_check(res.panel, static, params)
    torch.cuda.synchronize()
    assert all(c["max_abs_err"] == 0 for c in sha_checks.values()), sha_checks
    del qa, qb, a, b, am

    state = solver.initial_state(cols)
    rate, secs = timed_rate(device_solve_of(solver, state, torch), sha_B, reps=3)
    rate_full, secs_full = timed_rate(lambda: solver.solve(cols), sha_B, reps=3)
    if want_profile:
        emit({"profile_sha": profile(device_solve_of(solver, state, torch), secs)})
        # The same solve with one trace a Brillig block, not one a group: what
        # the grouping saves.
        one_a_block = BatchSolver(solver.plan, group_stages=False)
        _, block_secs = timed_rate(device_solve_of(one_a_block, state, torch), sha_B, reps=1)
        emit({"profile_sha_one_trace_a_block": profile(device_solve_of(one_a_block, state, torch),
                                                       block_secs)})
        del one_a_block
    # The same messages in the three ingest forms: host columns (uint8 numpy),
    # the packed matrix (witness indices, (B, 32) uint8) and uint8 columns on
    # the card.  Equal panels and flags, or the phase fails; each form's rate
    # through solve(), and its _pack_host apart from the upload and panel
    # build (median of three, ending in a synchronize).
    forms = {"host_columns": cols,
             "packed_matrix": (list(cols), np.stack([cols[w] for w in cols], axis=1)),
             "device_uint8": {w: torch.from_numpy(a).to(dev) for w, a in cols.items()}}
    ingest = {}
    for form_name, form in forms.items():
        got = solver.solve(form)
        assert torch.equal(got.panel, res.panel), form_name
        assert np.array_equal(got.ok, res.ok) and np.array_equal(got.fail, res.fail), form_name
        del got
        pack_times, build_times = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            B_, kwargs = solver._pack_host(form)
            t1 = time.perf_counter()
            state_ = solver._finish_initial_state(B_, **kwargs)
            torch.cuda.synchronize()
            pack_times.append(t1 - t0)
            build_times.append(time.perf_counter() - t1)
            del state_, kwargs
        form_rate, form_secs = timed_rate(lambda: solver.solve(form), sha_B, reps=3)
        ingest[form_name] = {"pack_host_ms": statistics.median(pack_times) * 1e3,
                             "upload_and_panel_build_ms": statistics.median(build_times) * 1e3,
                             "sha256_solves_per_sec_with_packing": form_rate,
                             "solve_seconds_with_packing": form_secs}
    del forms
    emit({"path_sha": {
        "opcodes": len(circuit.opcodes), "witnesses": circuit.num_vars() - 1, "batch": sha_B,
        "levels": len(levels), "quotient_levels": quotient_levels, "brillig_blocks": blocks,
        "brillig_groups": groups, "ok": True, "checked_instances": [0, sha_B - 1],
        "kernels_against_plain": sha_checks,
        "launches": sha_launches, "launches_all_port_kernels": sum(sha_launches.values()),
        "plain_divmod_on_card": plain_on_card, "plan_and_pack_seconds": plan_seconds,
        "sha256_solves_per_sec": rate, "solve_seconds": secs,
        "sha256_solves_per_sec_with_packing": rate_full, "solve_seconds_with_packing": secs_full,
        "ingest_forms_equal": True, "ingest_forms": ingest,
        "panel_bytes": solver.panel_bytes(sha_B)}})
    del state, res, solver
    torch.cuda.empty_cache()

    # -- 10. path_mem -----------------------------------------------------------------
    # Noir arrays at runtime indices: 8 blocks of 1,024 entries, 32 rounds of
    # read, multiply-add and write a block, 4 final reads a block, a read under a
    # predicate, a read and a write under runtime selectors; 1,024 instances,
    # one of them with an index one past its block at the middle memory opcode.
    mem_B, mem_bad = 1024, 5
    circuit = build_array_circuit()
    t0 = time.perf_counter()
    solver = BatchSolver(plan_circuit(circuit))
    plan_seconds = time.perf_counter() - t0
    cols, fail_op = array_inputs(circuit, mem_B, fail_instance=mem_bad)
    build.reset_launches()
    res = pass_peak("mem", lambda: solver.solve(cols), mem_B, inputs=cols)
    torch.cuda.synchronize()
    mem_launches = dict(build.LAUNCHES)
    want_fail = [int(FAIL_NONE)] * mem_B
    want_fail[mem_bad] = fail_op
    assert res.fail.tolist() == want_fail and res.ok.tolist() == [f == int(FAIL_NONE) for f in want_fail]
    for name in ("level", "dot"):
        assert mem_launches[name] > 0, mem_launches
    for b in (0, mem_bad, mem_B - 1):
        want, failed = evaluate(circuit, columnar_instance(cols, b), P)
        assert failed == (fail_op if b == mem_bad else None), (b, failed)
        got = res.instance_ints(b)
        assert len(want) == circuit.num_vars() - 1
        bad = [k for k, v in want.items() if got[k] != v]
        assert not bad, f"array instance {b}: {len(bad)} witnesses differ, first {bad[:3]}"
    opcodes = len(circuit.opcodes)
    levels = [lv for seg in solver.segments for lv in seg.levels]

    # Each kernel of the path against its plain version, tolerance 0, at this
    # path's shapes: the init level (8,192 static gates) and the index panel
    # of the largest memory group, taken again from the solved panel.
    params = solver.ctx.params
    init = max((lv["arith_static"] for lv in levels if "arith_static" in lv["kinds"]),
               key=lambda s_: s_["desc"].shape[0])
    group = max((buf for lv in levels for buf in lv.get("memory", []) if buf["kind"] == "op"),
                key=lambda buf: buf["k"].shape[0])
    mem_checks = {"level": level_check(res.panel, init, params),
                  "dot": dot_check(res.panel, group["index"], params)}
    torch.cuda.synchronize()
    assert all(c["max_abs_err"] == 0 for c in mem_checks.values()), mem_checks

    state = solver.initial_state(cols)
    rate, secs = timed_rate(device_solve_of(solver, state, torch), opcodes * mem_B)
    rate_full, secs_full = timed_rate(lambda: solver.solve(cols), opcodes * mem_B, reps=3)
    if want_profile:
        emit({"profile_mem": profile(device_solve_of(solver, state, torch), secs)})
    emit({"path_mem": {
        "opcodes": opcodes, "witnesses": circuit.num_vars() - 1, "batch": mem_B,
        "blocks": len(solver.memory_slots), "block_size": 1024, "levels": len(levels),
        "memory_groups": sum(len(lv.get("memory", [])) for lv in levels),
        "memory_opcodes": sum(len(lv.memory) for lv in solver.plan.levels),
        "ok": True, "checked_instances": [0, mem_bad, mem_B - 1],
        "failing_instance": {"instance": mem_bad, "fail": fail_op},
        "kernels_against_plain": mem_checks,
        "launches": mem_launches, "launches_all_port_kernels": sum(mem_launches.values()),
        "plan_and_pack_seconds": plan_seconds,
        "mem_solves_per_sec": rate, "solve_seconds": secs,
        "mem_solves_per_sec_with_packing": rate_full, "solve_seconds_with_packing": secs_full,
        "panel_bytes": solver.panel_bytes(mem_B)}})
    del state, res, solver
    torch.cuda.empty_cache()

    # -- 11. path_host ----------------------------------------------------------------
    # A Noir program that sorts 64 u32 keys, prints the decimal digits of their
    # sum and asks an oracle for 3 x + 1 (build_sort_circuit(64): 1,171
    # opcodes), over 1,024 instances, one with a key of 2^32: device segments
    # around three host stages (PermutationSort, ToLeRadix(10), a foreign
    # call).  Every instance's sorted keys, digits, answer and flags against
    # Python ints; host_batch=False gives the same panel.
    host_B, host_bad = 1024, 7
    n_keys = 64
    circuit = build_sort_circuit(n_keys)
    roles = sort_circuit_roles(n_keys)
    t0 = time.perf_counter()
    solver = BatchSolver(plan_circuit(circuit), foreign_call_handler=oracle_affine)
    plan_seconds = time.perf_counter() - t0
    stage_kinds = [[type(getattr(circuit.opcodes[h.opcode_indices[0]], "directive", None)
                         or circuit.opcodes[h.opcode_indices[0]]).__name__ for h in seg.host_stages]
                   for seg in solver.segments]
    assert sorted(k for seg in stage_kinds for k in seg) == [
        "DirPermutationSort", "DirToLeRadix", "OpcodeBrillig"], stage_kinds
    cols, fail_op = sort_inputs(circuit, host_B, fail_instance=host_bad)
    build.reset_launches()
    stats = SolveStats()
    t0 = time.perf_counter()
    res = pass_peak("host", lambda: solver.solve(cols, stats=stats), host_B, inputs=cols)
    first_solve_seconds = time.perf_counter() - t0
    host_launches = dict(build.LAUNCHES)
    for name in ("level", "dot"):
        assert host_launches[name] > 0, host_launches
    want_fail = [int(FAIL_NONE)] * host_B
    want_fail[host_bad] = fail_op
    assert res.fail.tolist() == want_fail and res.ok.tolist() == [f == int(FAIL_NONE) for f in want_fail]
    rows = sorted({w for ws in roles.values() for w in ws})
    vals = fk.limbs32_to_ints(res.panel[torch.tensor(rows, device=dev)].cpu().numpy())
    got = {w: vals[i * host_B:(i + 1) * host_B] for i, w in enumerate(rows)}
    for b in range(host_B):
        keys = [int(cols[w][b]) for w in roles["keys"]]
        total = sum(keys)
        assert [got[w][b] for w in roles["sorted"]] == sorted(keys), b
        assert [got[w][b] for w in roles["diffs"]] == [y - x for x, y in zip(sorted(keys), sorted(keys)[1:])], b
        assert got[roles["total"][0]][b] == total, b
        assert [got[w][b] for w in roles["digits"]] == [total // 10 ** j % 10 for j in range(12)], b
        assert got[roles["answer"][0]][b] == (3 * total + 1) % P, b
    # Two full witness maps against the sequential engine (acvm_tpu_torch.pwg,
    # held to the JAX package's by tests/test_torch_pwg.py), the failing
    # instance's first failure too.
    for b in (0, host_B - 1, host_bad):
        status, acvm = sequential_solve(circuit, columnar_instance(cols, b), oracle_affine)
        if b == host_bad:
            assert status == "failure" and acvm.instruction_pointer == fail_op, (status, b)
            continue
        assert status == "solved", (status, b)
        inst = res.instance_ints(b)
        assert all(inst[int(w)] == int(v) for w, v in acvm.finalize()), b
    clean, _ = sort_inputs(circuit, host_B)  # the second solve: no failing instance
    res_clean = solver.solve(clean)
    assert res_clean.ok.all()
    per_instance_stats = SolveStats()
    t0 = time.perf_counter()
    per_instance = BatchSolver(solver.plan, foreign_call_handler=oracle_affine,
                               host_batch=False).solve(cols, stats=per_instance_stats)
    per_instance_seconds = time.perf_counter() - t0
    assert torch.equal(per_instance.panel, res.panel)
    assert np.array_equal(per_instance.ok, res.ok) and np.array_equal(per_instance.fail, res.fail)
    del per_instance, res_clean

    # level and dot against their plain versions on one call's operands from
    # the solved panel: the widest static level, the booleanity checks' panel.
    levels = [lv for seg in solver.segments for lv in seg.levels]
    params = solver.ctx.params
    static = max((lv["arith_static"] for lv in levels if "arith_static" in lv["kinds"]),
                 key=lambda s_: s_["desc"].shape[0])
    check = max((lv["arith_check"] for lv in levels if "arith_check" in lv["kinds"]),
                key=lambda c_: c_["expr"]["qc"].shape[0])
    host_checks = {"level": level_check(res.panel, static, params),
                   "dot": dot_check(res.panel, check["expr"], params)}
    torch.cuda.synchronize()
    assert all(c["max_abs_err"] == 0 for c in host_checks.values()), host_checks

    opcodes = len(circuit.opcodes)
    timed_stats = SolveStats()
    rate, secs = timed_rate(lambda: solver.solve(cols), opcodes * host_B, reps=3)
    solver.solve(cols, stats=timed_stats)
    if want_profile:
        emit({"profile_host": profile(lambda: solver.solve(cols), secs)})
    emit({"path_host": {
        "opcodes": opcodes, "witnesses": circuit.num_vars() - 1, "batch": host_B, "keys": n_keys,
        "control_bits": len(roles["bits"]), "levels": len(levels), "segments": len(solver.segments),
        "host_stages_by_segment": stage_kinds, "ok": True, "checked_instances": host_B,
        "failing_instance": {"instance": host_bad, "fail": fail_op},
        "kernels_against_plain": host_checks, "launches": host_launches,
        "launches_all_port_kernels": sum(host_launches.values()),
        "plan_and_pack_seconds": plan_seconds, "first_solve_seconds": first_solve_seconds,
        "host_solves_per_sec": rate, "solve_seconds": secs,
        "solve_stats": timed_stats.summary(), "segment_seconds": timed_stats.segment_seconds,
        "host_stage_seconds": timed_stats.host_stage_seconds,
        "host_per_instance_stages": timed_stats.host_per_instance_stages,
        "host_batch_off": {"equal_panel": True, "solve_seconds": per_instance_seconds,
                           "host_per_instance_stages": per_instance_stats.host_per_instance_stages,
                           "host_stage_seconds": per_instance_stats.host_stage_seconds},
        "panel_bytes": solver.panel_bytes(host_B)}})
    del res, solver
    torch.cuda.empty_cache()

    # -- 12. path_vm ------------------------------------------------------------------
    # A Noir program with three unconstrained helpers that loop (an insertion
    # sort of 16 u32 keys into an array output, an integer square root by binary
    # search, an inverse that asserts its input is not 0), over 8,192
    # instances: the worst-case sort, all keys 2^32 - 1, k_0 = k_1 (a trap), a
    # key of 2^32 (a Range).  Every instance's sorted keys, root, inverse and
    # flags against Python ints; one brillig_vm launch a block, none per
    # instance; host_batch=False the same panel on 256 instances.
    vm_B, n_vm_keys = 8192, 16
    circuit = build_brillig_vm_circuit(n_vm_keys)
    roles = brillig_vm_circuit_roles(n_vm_keys)
    cols, vm_fails = brillig_vm_inputs(circuit, vm_B)
    t0 = time.perf_counter()
    solver = BatchSolver(plan_circuit(circuit))
    plan_seconds = time.perf_counter() - t0
    stage_blocks = [[i for h in seg.host_stages for i in h.opcode_indices] for seg in solver.segments]
    assert sorted(i for seg in stage_blocks for i in seg) == roles["blocks"], stage_blocks
    build.reset_launches()
    stats = SolveStats()
    t0 = time.perf_counter()
    res = pass_peak("vm", lambda: solver.solve(cols, stats=stats), vm_B, inputs=cols)
    first_solve_seconds = time.perf_counter() - t0
    vm_launches = dict(build.LAUNCHES)
    assert vm_launches["brillig_vm"] == 3 and stats.host_per_instance_stages == 0, (
        vm_launches, stats.host_per_instance_stages)
    want_fail = [vm_fails.get(b, int(FAIL_NONE)) for b in range(vm_B)]
    assert res.fail.tolist() == want_fail and res.ok.tolist() == [b not in vm_fails for b in range(vm_B)]
    rows = sorted({w for key in ("keys", "total", "sorted", "root", "inverse") for w in roles[key]})
    vals = fk.limbs32_to_ints(res.panel[torch.tensor(rows, device=dev)].cpu().numpy())
    got = {w: vals[i * vm_B:(i + 1) * vm_B] for i, w in enumerate(rows)}
    for b in range(vm_B):
        keys = [int(cols[w][b]) for w in roles["keys"]]
        # the sort compares at 32 bits: the key 2^32 of instance 3 sorts as 0
        assert [got[w][b] for w in roles["sorted"]] == sorted(keys, key=lambda v: v % 2**32), b
        assert got[roles["total"][0]][b] == sum(keys), b
        assert got[roles["root"][0]][b] == math.isqrt(sum(keys)), b
        x = (keys[0] - keys[1]) % P
        assert got[roles["inverse"][0]][b] == (pow(x, -1, P) if x else 0), b
    for b in (0, 2, 4):  # the worst-case sort, a trap, a plain instance
        status, acvm = sequential_solve(circuit, columnar_instance(cols, b), None)
        if b in vm_fails:
            assert status == "failure" and acvm.instruction_pointer == vm_fails[b], (status, b)
            continue
        assert status == "solved", (status, b)
        inst = res.instance_ints(b)
        assert all(inst[int(w)] == int(v) for w, v in acvm.finalize()), b
    per_B = 256
    part = {w: v[:per_B] for w, v in cols.items()}
    per_instance_stats = SolveStats()
    t0 = time.perf_counter()
    per_instance = BatchSolver(solver.plan, host_batch=False).solve(part, stats=per_instance_stats)
    per_instance_seconds = time.perf_counter() - t0
    assert torch.equal(per_instance.panel, res.panel[:, :per_B])
    assert per_instance.fail.tolist() == want_fail[:per_B]
    assert per_instance_stats.host_per_instance_stages == 3
    del per_instance

    # The VM route's parts, block by block, on the host columns the stage reads.
    from acvm_tpu_torch.gpu import brillig_vm_device as bvm, host_batch
    read = roles["keys"] + roles["total"]
    host_cols = host_batch.limb_cols_to_object(res.panel[torch.tensor(read, device=dev)].cpu().numpy())
    col_of = {w: host_cols[:, i] for i, w in enumerate(read)}
    route = []
    for name, index in zip(("sort", "isqrt", "inverse"), roles["blocks"]):
        brillig = circuit.opcodes[index].brillig
        t0 = time.perf_counter()
        program, regs, mem = bvm.initial_state(brillig, lambda w: col_of[int(w)], vm_B, P, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        status, steps = bvm.run_vm(program, regs, mem, bvm.step_budget(program.n_pc))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bvm.read_outputs(brillig, regs, mem, status)
        t3 = time.perf_counter()
        steps = steps.float()
        route.append(dict(block=name, opcode=index, n_pc=program.n_pc,
                          steps_mean=float(steps.mean()), steps_max=int(steps.max()),
                          inputs_ms=(t1 - t0) * 1e3, kernel_ms=(t2 - t1) * 1e3,
                          readback_ms=(t3 - t2) * 1e3))
        del regs, mem
    opcodes = len(circuit.opcodes)
    rate, secs = timed_rate(lambda: solver.solve(cols), opcodes * vm_B, reps=3)
    timed_stats = SolveStats()
    solver.solve(cols, stats=timed_stats)
    if want_profile:
        profile_vm = profile(lambda: solver.solve(cols), secs)
        # The busy share counts only what the trace saw: every brillig_vm
        # launch of the solve must be in it (checked at the verdict).
        profile_vm["brillig_vm_launches_traced"] = sum(
            r["calls"] for r in profile_vm["port_kernels"] if "brillig_vm_kernel" in r["kernel"])
        emit({"profile_vm": profile_vm})

    # brillig_vm against its plain version, tolerance 0, on each block of the
    # path over all 8,192 instances (the state the stage loads): registers,
    # memory, status and steps.  Then the two state tiers the path does not
    # reach (vm_launch_plan puts the path's registers and memory on chip): the
    # binary search over 256 words (memory in device memory) and a register
    # file of 300 rows (all in device memory), at 8,191 instances (a ragged
    # last warp).  Each timed launch starts from a fresh copy of the state.
    I_, F_ = br.BinaryIntOp, br.BinaryFieldOp
    # The bound's operations a kind: 8 words an int op, a data move or a
    # branch test (36 multiply-adds a 256-bit product's low half), 1 a jump,
    # call, return or stop; field ops 16 (add, sub), 2 x 136 (mul), 313 x 136
    # (div: to Montgomery form, the p - 2 chain, the product).  An
    # UnsignedDiv costs what its operands need (`division_work`, row 10's
    # count), from the operands the sequential VM sees (`division_census`).
    int_cost = {int(I_.Mul): 36}
    div_products = fk.pow_chain_products(P - 2) + 2
    field_cost = {int(F_.Add): 16, int(F_.Sub): 16, int(F_.Mul): 2 * MADDS_PER_MONT_MUL,
                  int(F_.Div): div_products * MADDS_PER_MONT_MUL}
    kind_names = {bvm.K_JUMP: "Jump", bvm.K_JUMP_IF: "JumpIf", bvm.K_JUMP_IF_NOT: "JumpIfNot",
                  bvm.K_CALL: "Call", bvm.K_RETURN: "Return", bvm.K_CONST: "Const",
                  bvm.K_MOV: "Mov", bvm.K_LOAD: "Load", bvm.K_STORE: "Store",
                  bvm.K_TRAP: "Trap", bvm.K_STOP: "Stop"}
    light = {"Jump", "Call", "Return", "Stop", "Trap"}

    def vm_work(program, pc_counts, brillig, B):
        """(opcodes executed by kind, int32 operations, division digits) of
        one run, from the opcodes executed at each pc."""
        executed_by_kind, ops, digits = {}, 0, 0
        for (kind, sub), n in zip(program.table[:, :2].tolist(), pc_counts.tolist()):
            if n == 0:
                continue
            if kind == bvm.K_BIN_INT:
                assert sub != int(I_.SignedDiv), "count a SignedDiv's magnitudes"
                name, cost = f"BinaryIntOp.{I_(sub).name}", int_cost.get(sub, 8)
                cost = 0 if sub == int(I_.UnsignedDiv) else cost  # counted from the operands below
            elif kind == bvm.K_BIN_FIELD:
                name, cost = f"BinaryFieldOp.{F_(sub).name}", field_cost.get(sub, 8)
            else:
                name = kind_names[kind]
                cost = 1 if name in light else 8
            executed_by_kind[name] = executed_by_kind.get(name, 0) + n
            ops += n * cost
        if "BinaryIntOp.UnsignedDiv" in executed_by_kind:
            pairs = division_census(brillig, col_of, B)
            assert len(pairs) == executed_by_kind["BinaryIntOp.UnsignedDiv"], len(pairs)
            a = torch.from_numpy(fk.ints_to_limbs32([x for x, _ in pairs]).copy())
            b = torch.from_numpy(fk.ints_to_limbs32([y for _, y in pairs]).copy())
            digits, div_ops = division_work(a, b)
            ops += div_ops
        return executed_by_kind, ops, digits

    def vm_ms(program, regs0, mem0, budget, calls, reps=7, launch=None):
        """Median event time of one launch over ``calls`` launches queued back
        to back, each on its own copy of the initial state (made before);
        ``launch(regs, mem)`` runs one (default: ``run_vm``)."""
        run = launch or (lambda r, m: bvm.run_vm(program, r, m, budget))
        run(regs0.clone(), mem0.clone())
        times = []
        for _ in range(reps):
            copies = [(regs0.clone(), mem0.clone()) for _ in range(calls)]
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for r, m in copies:
                run(r, m)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / calls)
        return statistics.median(times)

    def vm_check(brillig, get, B):
        """The kernel against the plain version on one block: (program,
        initial regs and mem, budget, the plain run's (regs, mem, status,
        steps), pc counts, plain seconds, steps)."""
        program, regs0, mem0 = bvm.initial_state(brillig, get, B, P, dev)
        budget = bvm.step_budget(program.n_pc)
        regs_k, mem_k = regs0.clone(), mem0.clone()
        status_k, steps_k = bvm.run_vm(program, regs_k, mem_k, budget)
        regs_p, mem_p = regs0.clone(), mem0.clone()
        pc_counts = torch.zeros(program.n_pc, dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        status_p, steps_p = bvm.run_vm_plain(program, regs_p, mem_p, budget, pc_counts=pc_counts)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - t0
        err = max(max_abs_err(regs_k, regs_p), max_abs_err(mem_k, mem_p),
                  max_abs_err(status_k, status_p), max_abs_err(steps_k, steps_p))
        assert err == 0, err
        assert int(pc_counts.sum()) == int(steps_k.sum())
        return (program, regs0, mem0, budget, (regs_p, mem_p, status_p, steps_p), pc_counts,
                plain_seconds, steps_k)

    def vm_plan(program, regs0, mem0):
        plan = bvm.vm_plan_for(program, regs0, mem0)
        return plan, {"threads": plan.threads, "blocks": plan.blocks,
                      "table_on_chip": plan.table_on_chip, "registers_on_chip": plan.regs_on_chip,
                      "memory_on_chip": plan.mem_on_chip, "shared_bytes": plan.shared_bytes}

    vm_blocks = {}
    for name, index in zip(("sort", "isqrt", "inverse"), roles["blocks"]):
        brillig = circuit.opcodes[index].brillig
        vm_blocks[name] = (brillig, *vm_check(brillig, lambda w: col_of[int(w)], vm_B))
    (_, program, regs0, mem0, budget, (regs_p, mem_p, status_p, steps_p), pc_counts, _,
     steps_k) = vm_blocks["sort"]
    n_regs, mem_cap = regs0.shape[0], mem0.shape[0]
    assert int((status_p != bvm.HALTED).sum()) == 0
    # The sort's Loads and Stores reach a[j - 1] and a[j] for j < 16: the
    # array's own rows.  The rows past it are the capacity's padding, still 0.
    array_rows = n_vm_keys
    assert not bool(mem_p[array_rows:].any()) and not bool(mem0[array_rows:].any())
    tier_B = vm_B - 1
    wide_cols, _, _ = brillig_vm_edge_inputs(tier_B, array=256)
    wide_obj = {w: np.asarray(v).astype(object) for w, v in wide_cols.items()}
    tiers = {}
    for name, brillig in (
            ("binary_search_256_words", build_brillig_vm_edges_circuit(array=256).opcodes[1].brillig),
            ("registers_300", build_brillig_vm_wide_registers_circuit().opcodes[0].brillig)):
        t_program, t_regs0, t_mem0, t_budget, _, _, _, t_steps = vm_check(
            brillig, lambda w: wide_obj[int(w)], tier_B)
        plan, plan_info = vm_plan(t_program, t_regs0, t_mem0)
        tiers[name] = dict(batch=tier_B, registers=t_regs0.shape[0], memory_cells=t_mem0.shape[0],
                           plan=plan_info, steps_mean=float(t_steps.float().mean()),
                           steps_max=int(t_steps.max()), max_abs_err=0,
                           ms=vm_ms(t_program, t_regs0, t_mem0, t_budget, 1))
        del t_regs0, t_mem0
    assert not tiers["binary_search_256_words"]["plan"]["memory_on_chip"]
    assert tiers["binary_search_256_words"]["plan"]["registers_on_chip"]
    assert not tiers["registers_300"]["plan"]["registers_on_chip"]

    # The bound of each block: the state the instances touch read and written
    # once (the block's registers; for the sort the array's rows of memory),
    # status and steps written, the program table read; against the int32
    # operations of the opcodes executed.
    def block_row(name, touched_mem_rows):
        brillig, b_program, b_regs0, b_mem0, b_budget, _, b_counts, plain_seconds, b_steps = vm_blocks[name]
        by_kind, ops, digits = vm_work(b_program, b_counts, brillig, vm_B)
        moved = (2 * (b_regs0.shape[0] + touched_mem_rows) * fk.LIMBS * 4 * vm_B + 2 * 4 * vm_B
                 + b_program.table.size * 4)
        b_ms, b_by = bound(moved, ops)
        _, plan_info = vm_plan(b_program, b_regs0, b_mem0)
        return dict(n_pc=b_program.n_pc, registers=b_regs0.shape[0], memory_cells=b_mem0.shape[0],
                    plan=plan_info, steps_mean=float(b_steps.float().mean()), steps_max=int(b_steps.max()),
                    opcodes_executed=int(b_steps.sum()), executed_by_kind=by_kind, int32_ops=ops,
                    division_digits=digits, bound_bytes=moved, max_abs_err=0,
                    ms=vm_ms(b_program, b_regs0, b_mem0, b_budget, 1),
                    ms_queued=vm_ms(b_program, b_regs0, b_mem0, b_budget, 10),
                    plain_seconds_one_run=plain_seconds, bound_ms=b_ms, bound_by=b_by)

    sort_row = block_row("sort", array_rows)
    isqrt_row = block_row("isqrt", 0)
    inverse_row = block_row("inverse", 0)
    # The inverse is one field Div a live instance: a chain of 313 dependent
    # products, each at the latency `mont_probe` measured in one warp's chain.
    us_per_product = candidates["carry_flag_even_odd"]["us_per_product_in_chain"]
    inverse_row["latency_floor_ms"] = div_products * us_per_product * 1e-3
    inverse_row["latency_floor_from"] = f"{div_products} products x int32.mont_mul_candidates" \
                                        ".carry_flag_even_odd.us_per_product_in_chain"
    if "--vm-variants" in sys.argv:
        # brillig_vm rebuilt with its measurement switch (csrc/brillig_vm.cu:
        # VM_REGROUP) and run under another plan, and the parent tree's kernel
        # (--parent=DIR, its own launcher), on each block's state; every
        # one bit-exact against the plain run.
        from concurrent.futures import ThreadPoolExecutor

        variants = {  # name: (switches, state on chip as the plan puts it, or all in device memory)
            "as_built": None,
            "device_state_no_regroup": (("VM_REGROUP=0",), False),
            "device_state_regroup": (("VM_REGROUP=1",), False),
            "on_chip_no_regroup": (("VM_REGROUP=0",), True),
            "on_chip_regroup": (("VM_REGROUP=1",), True),
        }
        switches = sorted({v[0] for v in variants.values() if v})
        with ThreadPoolExecutor(len(switches)) as pool:  # one nvcc a build, all started together
            built = dict(zip(switches, pool.map(lambda d: build.load_variant("brillig_vm", d), switches)))
        fns = {k: built[v[0]] for k, v in variants.items() if v}
        if parent_tree:
            # The earlier launcher: prog, n_pc, regs, mem, status, steps, B,
            # mem_cap, max_steps, field words, p - 2's chain, stream.
            _P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fns["parent_tree"] = build.load_variant(
                "brillig_vm", [], source=f"{parent_tree}/acvm_tpu_torch/csrc/brillig_vm.cu",
                signature=("acvm_brillig_vm", [_P, _I, _P, _P, _P, _P, _LL, _I, _I, _P, _P, _P]))
            variants["parent_tree"] = ([], None)
        times = {}
        for vname, spec in variants.items():
            times[vname] = {}
            for bname, (_, b_program, b_regs0, b_mem0, b_budget, want, *_) in vm_blocks.items():
                plan, _ = vm_plan(b_program, b_regs0, b_mem0)
                if spec is not None and spec[1] is False:  # registers and memory in device memory
                    row = fk.LIMBS * 4 * plan.threads
                    plan = plan._replace(
                        regs_on_chip=False, mem_on_chip=False,
                        shared_bytes=plan.shared_bytes - row * (b_regs0.shape[0] * plan.regs_on_chip
                                                                + b_mem0.shape[0] * plan.mem_on_chip))

                def launch(r, m, fn=fns.get(vname), plan=plan, b_program=b_program, b_budget=b_budget,
                           parent_args=vname == "parent_tree"):
                    if fn is None:
                        return bvm.run_vm(b_program, r, m, b_budget)
                    args, st, steps = bvm.vm_launch_args(b_program, r, m, b_budget, plan)
                    err = fn(*(args[:7] + args[8:12] + args[17:] if parent_args else args))
                    assert err == 0, (vname, err)
                    return st, steps

                r, m = b_regs0.clone(), b_mem0.clone()
                got = (r, m, *launch(r, m))
                torch.cuda.synchronize()
                assert all(torch.equal(x, y) for x, y in zip(got, want)), (vname, bname)
                times[vname][bname] = vm_ms(b_program, b_regs0, b_mem0, b_budget, 1, launch=launch)
                if bname == "sort":
                    times[vname]["sort_queued"] = vm_ms(b_program, b_regs0, b_mem0, b_budget, 10,
                                                        launch=launch)
        emit({"vm_variants": {"card": smi, "blocks": f"path_vm's three blocks, B={vm_B}",
                              "equal_to_plain": True, "ms": times}})
    kernels["brillig_vm"] = dict(
        name="brillig_vm", route="cuda", source="acvm_tpu_torch/csrc/brillig_vm.cu",
        replaces="acvm_tpu/tpu/brillig_vm_device.py:215",
        shape=f"block A of path_vm: {program.n_pc} opcodes, B={vm_B}, {n_regs} registers, "
              f"{mem_cap} memory cells",
        **{k: v for k, v in sort_row.items() if k not in ("plain_seconds_one_run",)},
        plain_ms=time_ms(lambda: bvm.run_vm_plain(program, regs0.clone(), mem0.clone(), budget),
                         3, warmup=0),
        library_ms=None, isqrt_block=isqrt_row, inverse_block=inverse_row, state_tiers=tiers)
    emit({"path_vm": {
        "opcodes": opcodes, "witnesses": circuit.num_vars() - 1, "batch": vm_B, "keys": n_vm_keys,
        "levels": len([lv for seg in solver.segments for lv in seg.levels]),
        "segments": len(solver.segments), "blocks_by_segment": stage_blocks, "ok": True,
        "checked_instances": vm_B, "failing_instances": {str(b): f for b, f in vm_fails.items()},
        "launches": vm_launches, "launches_all_port_kernels": sum(vm_launches.values()),
        "plan_and_pack_seconds": plan_seconds, "first_solve_seconds": first_solve_seconds,
        "vm_solves_per_sec": rate, "solve_seconds": secs,
        "solve_stats": timed_stats.summary(), "segment_seconds": timed_stats.segment_seconds,
        "host_stage_seconds": timed_stats.host_stage_seconds,
        "host_per_instance_stages": timed_stats.host_per_instance_stages,
        "vm_route": route,
        "host_batch_off": {"instances": per_B, "equal_panel": True,
                           "solve_seconds": per_instance_seconds,
                           "host_per_instance_stages": per_instance_stats.host_per_instance_stages,
                           "host_stage_seconds": per_instance_stats.host_stage_seconds},
        "panel_bytes": solver.panel_bytes(vm_B),
        "sort_state_bytes": (regs0.numel() + mem0.numel()) * 4}})
    del res, solver, vm_blocks, regs_p, mem_p
    torch.cuda.empty_cache()

    # -- 13. brillig_ops --------------------------------------------------------------
    # One straight-line block for each Brillig op (5 field, 13 int at 1-256
    # bits) over 2,048 instances of edge values, every witness of every
    # instance against the evaluator.  Field Div reaches pow, the divisions and
    # the reduction of 254- and 256-bit results reach divmod.
    ops_B = 2048
    ops_circuit = build_brillig_ops_circuit()
    ops_input_cols = brillig_ops_inputs(ops_B)
    build.reset_launches()
    intops.PLAIN_ON_CARD["long_divmod"] = 0
    res = BatchSolver(plan_circuit(ops_circuit)).solve(ops_input_cols)
    torch.cuda.synchronize()
    ops_launches = dict(build.LAUNCHES)
    assert res.ok.all() and intops.PLAIN_ON_CARD["long_divmod"] == 0
    assert ops_launches["pow"] > 0 and ops_launches["divmod"] > 0 and ops_launches["mul"] > 0
    nw = ops_circuit.num_vars()
    ops_ints = fk.limbs32_to_ints(res.panel.cpu().numpy())  # witness-major
    for b in range(ops_B):
        want, failed = evaluate(ops_circuit, columnar_instance(ops_input_cols, b), P)
        assert failed is None and len(want) == nw - 1
        bad = [k for k, v in want.items() if ops_ints[k * ops_B + b] != v]
        assert not bad, f"brillig ops instance {b}: witnesses {bad[:3]} differ"
    emit({"brillig_ops": {"blocks": len(ops_circuit.opcodes), "batch": ops_B, "ok": True,
                          "checked_instances": ops_B, "launches": ops_launches}})
    del res

    # -- 14. brillig_vm_edges -----------------------------------------------------------
    # The JAX package's device-VM fixtures (a sum loop, a binary search over an
    # array input, Call/Return with a conditional Trap) and a predicated loop,
    # over 2,048 instances, against Python ints; one instance's loop past the
    # step budget makes its block rerun instance by instance (one per-instance
    # stage, the sequential engine's answer).  Then every block of the
    # Brillig-ops circuit through the VM equals the trace route's panel above,
    # bit for bit; where an UnsignedDiv divides by zero the VM traps (the trace
    # gives 0 and no flag), by design.
    from acvm_tpu_torch.gpu import brillig_vm_device as bvm

    edge_B, edge_escape = 2048, 5
    circuit = build_brillig_vm_edges_circuit()
    edge_plan = plan_circuit(circuit)
    edges = {}
    for escape in (None, edge_escape):
        cols, expected, trap = brillig_vm_edge_inputs(edge_B, escape_instance=escape)
        build.reset_launches()
        stats = SolveStats()
        res = BatchSolver(edge_plan).solve(cols, stats=stats)
        torch.cuda.synchronize()
        assert build.LAUNCHES["brillig_vm"] == 4, build.LAUNCHES
        assert stats.host_per_instance_stages == (0 if escape is None else 1), stats.host_per_instance_stages
        assert res.ok.tolist() == (~trap).tolist()
        assert res.fail.tolist() == [2 if t else int(FAIL_NONE) for t in trap]
        for w, want in expected.items():
            assert res.witness_ints(w) == want, w
        edges["escape" if escape is not None else "no_escape"] = {
            "launches": build.LAUNCHES["brillig_vm"],
            "host_per_instance_stages": stats.host_per_instance_stages,
            "host_stage_seconds": stats.host_stage_seconds}
    status, acvm = sequential_solve(circuit, columnar_instance(cols, edge_escape), None)
    assert status == "solved" and int(acvm.finalize().get(Witness(2))) == res.witness_ints(2)[edge_escape]
    ops_cols = {w: np.asarray(v).astype(object) for w, v in ops_input_cols.items()}
    udiv_zero = 0
    for index, op in enumerate(ops_circuit.opcodes):
        values, trapped = bvm.run_brillig_vm_batch(op.brillig, lambda w: ops_cols[int(w)], ops_B, P, dev)
        for w, v in values.items():
            assert v.tolist() == ops_ints[w * ops_B:(w + 1) * ops_B], (index, w)
        code = op.brillig.bytecode[-2]
        divides = isinstance(code, br.OpBinaryIntOp) and code.op == br.BinaryIntOp.UnsignedDiv
        zero = [divides and int(v) % (1 << code.bit_size) == 0 for v in ops_cols[2]]
        assert trapped.tolist() == zero, index
        udiv_zero += sum(zero)
    emit({"brillig_vm_edges": {"batch": edge_B, "blocks": len(circuit.opcodes), "ok": True,
                               "escape_instance": edge_escape, **edges,
                               "brillig_ops_blocks_equal_trace": len(ops_circuit.opcodes),
                               "brillig_ops_batch": ops_B, "udiv_by_zero_trapped": udiv_zero}})
    del res


    # -- 15. path_hash ----------------------------------------------------------------
    # (a) The JAX package's gadget circuits at bench.py's sizes: 8 gadgets of 64
    # one-byte inputs, B = 8,192 random messages as the packed (witnesses,
    # uint8 matrix) form already on the card.  One launch of the kind's kernel
    # a solve; every digest against hashlib, Keccak's against the host Keccak
    # on 512 instances (pure Python).
    import types

    from acvm_tpu_torch.blackbox import hashes as host_hashes
    from acvm_tpu_torch.gpu import gadgets

    def reset_plain_digests():
        for key in gadgets.PLAIN_ON_CARD:
            gadgets.PLAIN_ON_CARD[key] = 0

    def hash_groups(solver):
        return [g for seg in solver.segments for lv in seg.levels for g in lv.get("hashes", [])]

    hash_B, hash_G, hash_M = 8192, 8, 64
    host_digest = {"sha256": host_hashes.sha256, "blake2s": host_hashes.blake2s,
                   "keccak256": host_hashes.keccak256}
    hash_launches = {name: 0 for name in build.KERNELS}
    hash_report, hash_states = {}, {}
    for kind in host_digest:
        kernel = gadgets.KERNEL_OF[kind]
        circuit = build_gadget_circuit(kind, hash_G, hash_M)
        witnesses = sorted(int(w) for w in circuit.circuit_arguments())
        matrix = torch.from_numpy(np.random.default_rng(7).integers(
            0, 256, size=(hash_B, len(witnesses)), dtype=np.uint8)).to(dev)
        t0 = time.perf_counter()
        solver = BatchSolver(plan_circuit(circuit))
        plan_seconds = time.perf_counter() - t0
        build.reset_launches()
        reset_plain_digests()
        res = pass_peak(f"hash_{kind}", lambda: solver.solve((witnesses, matrix)), hash_B,
                        inputs=(witnesses, matrix))
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        assert res.ok.all() and (res.fail == FAIL_NONE).all(), kind
        assert launches[kernel] == 1 and sum(launches.values()) == 1, (kind, launches)
        assert not any(gadgets.PLAIN_ON_CARD.values()), gadgets.PLAIN_ON_CARD
        for name, n in launches.items():
            hash_launches[name] += n
        column = {w: i for i, w in enumerate(witnesses)}
        out_rows = torch.tensor([int(w) for op in circuit.opcodes for w in op.call.outputs], device=dev)
        digests = res.panel.index_select(0, out_rows)[..., 0].cpu().numpy().astype(np.uint8)
        digests = digests.reshape(hash_G, 32, hash_B)
        messages = matrix.cpu().numpy()
        checked = hash_B if kind != "keccak256" else 512
        for g, op in enumerate(circuit.opcodes):
            msgs = messages[:, [column[int(fi.witness)] for fi in op.call.inputs]]
            for b in range(checked):
                assert digests[g, :, b].tobytes() == host_digest[kind](msgs[b].tobytes()), (kind, g, b)
        state = solver.initial_state((witnesses, matrix))
        rate, secs = timed_rate(device_solve_of(solver, state, torch), hash_G * hash_B)
        rate_full, secs_full = timed_rate(lambda: solver.solve((witnesses, matrix)), hash_G * hash_B)
        if want_profile:
            emit({f"profile_hash_{kind}": profile(device_solve_of(solver, state, torch), secs)})
        hash_states[kind] = (state[0], hash_groups(solver)[0])
        hash_report[kind] = {
            "gadgets": hash_G, "message_bytes": hash_M, "batch": hash_B, "witnesses": len(witnesses) + hash_G * 32,
            "panel_bytes": solver.panel_bytes(hash_B), "ok": True, "digests_checked": hash_G * checked,
            "launches": {k: v for k, v in launches.items() if v}, "plan_seconds": plan_seconds,
            f"{kind}_solves_per_sec": rate, "solve_seconds": secs,
            f"{kind}_solves_per_sec_with_packing": rate_full, "solve_seconds_with_packing": secs_full}
        del res, solver, matrix
    torch.cuda.empty_cache()

    # (b) The Merkle-membership program: blake2s leaf, 16 levels of boolean
    # check, selection (64 solve gates) and sha256, hash-to-field nullifier,
    # variable-length Keccak signal, Keccak binding; 20 hash launches a solve.
    # Instance 1 has a path bit of 2 (fails level 0's boolean check), 2 a
    # memo_len of 233 (fails at the keccak_var opcode), 3 a memo_len of
    # 2^128 + 100 (its low 128 bits: 100 bytes, solved, as pwg.ACVM reads it),
    # 4-8 the memo_lens 0, 135, 136, 137, 232 either side of Keccak's rate.
    depth, memb_B = 16, 8192
    memb_lens = {2: 233, 3: (1 << 128) + 100, 4: 0, 5: 135, 6: 136, 7: 137, 8: 232}
    circuit = build_membership_circuit(depth)
    roles = membership_circuit_roles(depth)
    cols = membership_inputs(circuit, memb_B)
    cols[roles["bits"][0]][1] = 2
    memo_len = roles["memo_len"][0]
    cols[memo_len] = cols[memo_len].astype(object)
    for b, n in memb_lens.items():
        cols[memo_len][b] = n
    t0 = time.perf_counter()
    solver = BatchSolver(plan_circuit(circuit))
    plan_seconds = time.perf_counter() - t0
    build.reset_launches()
    reset_plain_digests()
    res = pass_peak("membership", lambda: solver.solve(cols), memb_B, inputs=cols)
    torch.cuda.synchronize()
    memb_launches = dict(build.LAUNCHES)
    for name, n in memb_launches.items():
        hash_launches[name] += n
    hash_kernel_launches = {k: memb_launches[k] for k in ("sha256", "blake2s", "keccak")}
    assert hash_kernel_launches == {"sha256": depth, "blake2s": 2, "keccak": 2}, memb_launches
    assert memb_launches["level"] > 0 and not any(gadgets.PLAIN_ON_CARD.values()), (
        memb_launches, gadgets.PLAIN_ON_CARD)
    want_fail = [int(FAIL_NONE)] * memb_B
    want_fail[1], want_fail[2] = roles["bool_check_opcodes"][0], roles["keccak_var_opcode"][0]
    assert res.fail.tolist() == want_fail and res.ok.tolist() == [f == int(FAIL_NONE) for f in want_fail]

    def rows_of(role):  # (B, n) limb 0 of the role's witnesses
        idx = torch.tensor(roles[role], device=dev)
        return res.panel.index_select(0, idx)[..., 0].T.cpu().numpy()

    got_leaf, got_root = rows_of("leaf"), rows_of("root")
    got_nullifier = res.witness_ints(roles["nullifier"][0])
    stack = lambda role: np.stack([np.asarray(cols[w]).astype(np.uint8) for w in roles[role]], 1)  # noqa: E731
    secret, bits = stack("secret"), stack("bits")
    sibs = stack("siblings").reshape(memb_B, depth, 32)
    ext = cols[roles["ext_nullifier"][0]]
    for b in range(memb_B):
        if b == 1:  # the path bit of 2: the gates' own arithmetic
            want = membership_outputs(columnar_instance(cols, b), depth)
            leaf, root = want["leaf"], want["root"]
        else:
            leaf = cur = host_hashes.blake2s(secret[b].tobytes())
            for i in range(depth):
                sib = sibs[b, i].tobytes()
                cur = host_hashes.sha256(sib + cur if bits[b, i] else cur + sib)
            root = cur
        nullifier = int(host_hashes.hash_to_field_128_security(
            secret[b].tobytes() + FieldElement(int(ext[b])).to_le_bytes()))
        assert got_leaf[b].astype(np.uint8).tobytes() == leaf, b
        assert got_root[b].astype(np.uint8).tobytes() == root, b
        assert got_nullifier[b] == nullifier, b
    got_signal, got_binding = rows_of("signal"), rows_of("binding")
    for b in range(512):
        want = membership_outputs(columnar_instance(cols, b), depth)
        assert (want["signal"] is None) == (b == 2), b
        if want["signal"] is not None:
            assert got_signal[b].astype(np.uint8).tobytes() == want["signal"], b
            assert got_binding[b].astype(np.uint8).tobytes() == want["binding"], b
    for b in (0, 3, memb_B - 1):
        status, acvm = sequential_solve(circuit, columnar_instance(cols, b), None)
        assert status == "solved", (b, status)
        got = res.instance_ints(b)
        solved = list(acvm.finalize())
        assert len(solved) == circuit.num_vars() - 1 and all(got[int(w)] == int(v) for w, v in solved), b
    for b in (1, 2):
        status, acvm = sequential_solve(circuit, columnar_instance(cols, b), None)
        location = getattr(acvm.error, "opcode_location", None)
        assert status == "failure" and want_fail[b] == (
            acvm.instruction_pointer if location is None else location.acir_index), (b, status)
    # The same circuit with its hashes planned as host stages (instance by
    # instance through pwg), on 256 instances: the same flags, and the same
    # panel on every solved instance (a failing one stops at its opcode).
    host_config = types.SimpleNamespace(field_params=lambda: BN254_FR, device_hash_kernels=False,
                                        device_brillig_trace=True)
    sub = {w: a[:256] for w, a in cols.items()}
    host_stats = SolveStats()
    host_res = BatchSolver(plan_circuit(circuit, config=host_config)).solve(sub, stats=host_stats)
    dev_res = solver.solve(sub)
    assert host_res.ok.tolist() == dev_res.ok.tolist() and host_res.fail.tolist() == dev_res.fail.tolist()
    solved = torch.from_numpy(dev_res.ok).to(dev)
    assert torch.equal(host_res.panel[:, solved], dev_res.panel[:, solved])
    del host_res, dev_res
    opcodes = len(circuit.opcodes)
    rate, secs = timed_rate(lambda: solver.solve(cols), opcodes * memb_B, reps=3)
    timed_stats = SolveStats()
    solver.solve(cols, stats=timed_stats)
    state = solver.initial_state(cols)
    device_rate, device_secs = timed_rate(device_solve_of(solver, state, torch), opcodes * memb_B, reps=3)
    if want_profile:
        emit({"profile_hash_membership": profile(device_solve_of(solver, state, torch), device_secs)})
    memb_groups = {g["kind"]: g for g in hash_groups(solver)}
    memb_W = res.panel
    emit({"path_hash": {
        "card": smi, "gadget_circuits": hash_report,
        "membership": {
            "depth": depth, "opcodes": opcodes, "witnesses": circuit.num_vars() - 1, "batch": memb_B,
            "panel_bytes": solver.panel_bytes(memb_B),
            "levels": len([lv for seg in solver.segments for lv in seg.levels]),
            "hash_groups": [(g["kind"], int(g["src_w"].shape[1])) for g in hash_groups(solver)],
            "ok": True, "failing_instances": {"1": want_fail[1], "2": want_fail[2]},
            "memo_lens": {str(b): str(n) for b, n in memb_lens.items()},
            "leaf_root_nullifier_checked": memb_B, "signal_binding_checked": 512,
            "witness_maps_against_pwg": [0, 3, memb_B - 1],
            "host_stage_hashes": {"instances": 256, "equal_flags_and_solved_panel": True,
                                  "host_stage_seconds": host_stats.host_stage_seconds,
                                  "host_per_instance_stages": host_stats.host_per_instance_stages},
            "launches": {k: v for k, v in memb_launches.items() if v},
            "hash_launches": sum(hash_kernel_launches.values()), "plain_digests_on_card": 0,
            "plan_and_pack_seconds": plan_seconds,
            "membership_solves_per_sec": rate, "solve_seconds": secs,
            "membership_solves_per_sec_device": device_rate, "device_solve_seconds": device_secs,
            "solve_stats": timed_stats.summary()}}})

    # The three kernels against their plain versions at the path's shapes,
    # tolerance 0.  Bytes: one 32-byte sector a distinct (panel row,
    # instance) the kernel reads (a keccak_var instance only the rows of its
    # first length bytes) and one an output row written, and keccak_var's
    # int32 lengths; operations from the round structure of each kernel,
    # gadgets.OPS_PER_BLOCK.
    def hash_work(kind, buf, B, length=None):
        """(bytes, int32 operations, how the operations were counted)."""
        src_w = buf["src_w"].cpu().to(torch.int64)
        G, M = src_w.shape
        rows = torch.unique(src_w)
        if length is None:
            reads = B * rows.numel()
        else:  # instance b reads row r iff some gadget g has it at a j < length[g, b]
            at = torch.where(src_w[:, :, None] == rows, torch.arange(M)[None, :, None], M)
            first = at.amin(1)  # (G, rows)
            reads = (length.cpu().to(torch.int64)[:, :, None] > first[:, None, :]).any(0).sum().item()
        moved = 32 * (reads + G * B * buf["out_idx"].shape[1]) + (4 * G * B if length is not None else 0)
        per = gadgets.OPS_PER_BLOCK[gadgets.KERNEL_OF[kind]]
        if kind == "sha256":
            blocks = G * B * ((M + 8) // 64 + 1)
            how = f"{per:,} a block x ((M + 8) // 64 + 1) blocks"
        elif kind in ("blake2s", "hash_to_field"):
            blocks = G * B * max(1, -(-M // 64))
            how = f"{per:,} a block x max(1, ceil(M / 64)) blocks"
        else:
            blocks = ((length.to(torch.int64) // 136 + 1).sum().item() if length is not None
                      else G * B * (M // 136 + 1))
            how = f"{per:,} a permutation x {blocks} permutations (length // 136 + 1 each)"
        ops = per * blocks
        if kind == "hash_to_field":
            ops += G * B * gadgets.TO_FIELD_OPS
            how += f" + {gadgets.TO_FIELD_OPS} for the subtractions"
        return moved, ops, how + f"; {reads} (row, instance) sectors read"

    # The measurement builds of the three kernels on hash.cuh's message stage
    # (HASH_ROUNDS_ONLY at every shape: rounds_only_ms, the row's latency
    # floor; with --hash-variants HASH_READS_ONLY too), and with --parent=DIR
    # the parent tree's three hash kernels, all nvcc runs started together.
    # Their launchers take the same arguments, called here through
    # gadgets._launch as hash_rows calls the kernel's own.
    from concurrent.futures import ThreadPoolExecutor

    staged = ("sha256", "keccak", "blake2s")
    hash_switches = {"rounds_only": ["HASH_ROUNDS_ONLY"]}
    if "--hash-variants" in sys.argv:
        hash_switches["reads_only"] = ["HASH_READS_ONLY"]
    specs = [(name, label, defines, None) for name in staged for label, defines in hash_switches.items()]
    if parent_tree:
        specs += [(name, "parent", [], f"{parent_tree}/acvm_tpu_torch/csrc/{name}.cu") for name in staged]
    with ThreadPoolExecutor(len(specs)) as pool:
        built_fns = list(pool.map(lambda sp: build.load_variant(sp[0], sp[2], source=sp[3]), specs))
    hash_builds = {(sp[0], sp[1]): fn for sp, fn in zip(specs, built_fns)}
    hash_builds.update({(name, "change"): build.load_variant(name, []) for name in staged})
    hash_variant_ms, hash_parent = {}, {}

    def via(fn):  # a launch through another build's launcher
        def launch(kernel, *args):
            assert fn(*args) == 0, (kernel, "launch refused")
        return launch

    def parent_pair(name, label, shape, sides, make_input):
        """The parent's and the change's build equal on fresh inputs, then
        timed parent, change, change, parent."""
        outs = {side: run(make_input()) for side, run in sides.items()}
        torch.cuda.synchronize()
        assert torch.equal(outs["parent"], outs["change"]), (name, label)
        del outs
        scratch = make_input()
        timed = {f"{side}_{how}": [] for how in ("ms_queued", "ms_graph") for side in ("parent", "change")}
        for side in ("parent", "change", "change", "parent"):
            timed[f"{side}_ms_queued"].append(time_ms(lambda r=sides[side]: r(scratch), calls=10))
            timed[f"{side}_ms_graph"].append(graph_ms(lambda r=sides[side]: r(scratch)))
        hash_parent.setdefault(name, {})[label] = {"shape": shape, **timed}

    def hash_kernel_row(kind, W, buf, length=None, modulus=None, label=None):
        G, M = buf["src_w"].shape
        B = W.shape[1]
        name = gadgets.KERNEL_OF[kind]
        tables = (buf["src_w"], buf["src_limb"], buf["src_shift"], buf["out_idx"])
        run = lambda X: gadgets.hash_rows(kind, X, *tables, length=length, modulus=modulus)  # noqa: E731
        plain = lambda X: gadgets.hash_rows_plain(kind, X, *tables, length, modulus)  # noqa: E731
        subtrahends = gadgets.to_field_subtrahends(modulus) if modulus is not None else None

        def run_build(fn):  # hash_rows' launch through another build of the source
            def run_on(X):
                gadgets._launch(kind, (X, B * fk.LIMBS, fk.LIMBS), tables[:3], M,
                                (X, B * fk.LIMBS, fk.LIMBS, fk.LIMBS), tables[3], G, B,
                                length=length, subtrahends=subtrahends, launch=via(fn))
                return X
            return run_on

        got, want = run(W.clone()), plain(W.clone())
        torch.cuda.synchronize()
        err = 0 if torch.equal(got, want) else max_abs_err(got, want)
        del got, want
        scratch = W.clone()
        moved, ops, how = hash_work(kind, buf, B, length)
        b_ms, b_by = bound(moved, ops)
        # ms_graph: the kernel's own library through hash_rows' launch (no
        # length check: it synchronises), twenty launches in a CUDA graph.
        own = run_build(hash_builds[name, "change"])
        row = dict(shape=f"{kind}: G={G} x B={B} x M={M}", max_abs_err=err,
                   ms=time_ms(lambda: run(W)), ms_queued=time_ms(lambda: run(W), calls=10),
                   ms_graph=graph_ms(lambda: own(W)),
                   plain_ms=time_ms(lambda: plain(scratch), 3, warmup=0),
                   bound_ms=b_ms, bound_by=b_by, bound_bytes=moved, int32_ops=ops, ops_counted=how,
                   registers=ptxas[name]["registers"], spill_bytes=ptxas[name]["spill_bytes"])
        stage_row(row, name, label, M, True, G, B, lambda fn: (lambda r=run_build(fn): r(scratch)))
        if parent_tree:
            parent_pair(name, label, row["shape"], {side: run_build(hash_builds[name, side])
                                                    for side in ("parent", "change")}, W.clone)
        del scratch
        return row

    def stage_row(row, name, label, M, tables, G, B, runner):
        """A staged kernel's grid, shared memory and measurement builds:
        one warp a block over (ceil(B / 32), G) (hash.cuh's stage_grid);
        ``runner(fn)`` runs the row's shape through launcher ``fn``.  The
        switched builds' outputs are not compared: they are not hashes."""
        row["blocks"] = -(-B // 32) * G
        row["shared_bytes"] = getattr(build.load(name), f"acvm_{name}_shared_bytes")(M, int(tables))
        variant_ms = {"as_built": {"queued": row["ms_queued"], "graph": row["ms_graph"]}}
        for switch in hash_switches:
            f = runner(hash_builds[name, switch])
            variant_ms[switch] = {"queued": time_ms(f, calls=10), "graph": graph_ms(f)}
        row["rounds_only_ms"] = row["latency_floor_ms"] = variant_ms["rounds_only"]["graph"]
        row["rounds_only_ms_queued"] = variant_ms["rounds_only"]["queued"]
        hash_variant_ms.setdefault(name, {})[label] = variant_ms

    def matrix_kernel_row(fn, plain_fn, msg, label):
        got, want = fn(msg), plain_fn(msg)
        torch.cuda.synchronize()
        B, M = msg.shape
        per = gadgets.OPS_PER_BLOCK["blake2s"]
        b_ms, b_by = bound(B * (M + 32) * 4, B * per * max(1, -(-M // 64)))
        row = dict(shape=f"(B, M) = ({B}, {M}) int32 matrix", max_abs_err=max_abs_err(got, want),
                   ops_counted=f"{per:,} a block x max(1, ceil(M / 64)) blocks; bytes 4 (M + 32) an instance",
                   ms=time_ms(lambda: fn(msg)), ms_queued=time_ms(lambda: fn(msg), calls=10),
                   ms_graph=graph_ms(lambda: fn(msg)),
                   plain_ms=time_ms(lambda: plain_fn(msg), 3, warmup=0), bound_ms=b_ms, bound_by=b_by)
        stage_row(row, "blake2s", label, M, False, 1, B,
                  lambda f: (lambda: gadgets._digest_on_card("blake2s", msg, launch=via(f))))
        if parent_tree:
            parent_pair("blake2s", label, row["shape"], {
                side: (lambda _, f=hash_builds["blake2s", side]: gadgets._digest_on_card(
                    "blake2s", msg, launch=via(f))) for side in ("parent", "change")}, lambda: None)
        return row

    kv = memb_groups["keccak_var"]
    size = memb_W.index_select(0, kv["size_w"])[..., 0].to(torch.int64) & 0xFFFFFFFF
    kv_length = size.clamp(max=kv["src_w"].shape[1]).to(torch.int32)
    rows = {
        "sha256": [("gadgets", "sha256", *hash_states["sha256"], None, None),
                   ("membership_level", "sha256", memb_W, memb_groups["sha256"], None, None)],
        "keccak": [("gadgets_fixed_64", "keccak256", *hash_states["keccak256"], None, None),
                   ("membership_var_232", "keccak_var", memb_W, kv, kv_length, None),
                   ("membership_fixed_64", "keccak256", memb_W, memb_groups["keccak256"], None, None)],
        "blake2s": [("membership_leaf_32", "blake2s", memb_W, memb_groups["blake2s"], None, None),
                    ("membership_to_field_64", "hash_to_field", memb_W, memb_groups["hash_to_field"],
                     None, P),
                    ("gadgets_64", "blake2s", *hash_states["blake2s"], None, None)],
    }
    replaces = {"sha256": "acvm_tpu/tpu/gadgets.py:74", "keccak": "acvm_tpu/tpu/gadgets.py:244",
                "blake2s": "acvm_tpu/tpu/gadgets.py:157"}
    for name, shapes in rows.items():
        measured = {label: hash_kernel_row(kind, W, buf, length, modulus, label)
                    for label, kind, W, buf, length, modulus in shapes}
        first = measured.pop(shapes[0][0])
        kernels[name] = dict(name=name, route="cuda", source=f"acvm_tpu_torch/csrc/{name}.cu",
                             replaces=replaces[name], **first, library_ms=None,
                             **{label: row for label, row in measured.items()})
    # At one gadget x 8,192 instances each launch of the staged kernels spans
    # every SM: 256 one-warp blocks.
    for name, label in (("sha256", "membership_level"), ("keccak", "membership_var_232"),
                        ("keccak", "membership_fixed_64"), ("blake2s", None),
                        ("blake2s", "membership_to_field_64")):
        row = kernels[name][label] if label else kernels[name]
        assert row["blocks"] == 256 >= torch.cuda.get_device_properties(0).multi_processor_count
    kernels["keccak"]["also_replaces"] = ["acvm_tpu/tpu/gadgets.py:274", "acvm_tpu/tpu/gadgets.py:322"]
    kernels["blake2s"]["also_replaces"] = ["acvm_tpu/tpu/batch_solver.py:451"]
    schnorr_msg = torch.from_numpy(np.random.default_rng(8).integers(0, 256, size=(2048, 64))).to(dev)
    kernels["blake2s"]["schnorr_2048x64"] = matrix_kernel_row(
        gadgets.blake2s_digest, gadgets.blake2s_digest_plain, schnorr_msg, "schnorr_2048x64")
    assert all(kernels[name]["max_abs_err"] == 0 and all(
        v["max_abs_err"] == 0 for v in kernels[name].values() if isinstance(v, dict))
        for name in rows), "hash kernel against its plain version"
    if "--hash-variants" in sys.argv:
        emit({"hash_variants": {"card": smi, "ms": hash_variant_ms}})
    if parent_tree:
        # The parent's three hash kernels: equal outputs at every row's shape
        # (above), and their SASS beside this tree's.
        for name in staged:
            source = Path(f"{parent_tree}/acvm_tpu_torch/csrc/{name}.cu")
            sass = [sass_instructions(build.lib_path(name, [], source)),
                    sass_instructions(build.lib_path(name))]
            hash_parent[name] = {"shapes": hash_parent[name],
                                 "sass_instructions": [None if t is None else len(t) for t in sass],
                                 "sass_identical": None if None in sass else sass[0] == sass[1]}
    del res, solver, state, memb_W, hash_states
    torch.cuda.empty_cache()

    # -- 16. path_ecdsa ---------------------------------------------------------------
    # ECDSA verification on both curves: the JAX package's gadget circuits
    # (build_gadget_circuit ecdsa_k1 / ecdsa_r1: 2 gadgets of 32 + 32 + 64 + 32
    # byte witnesses, 322 witnesses) over 4,096 instances (8,192 verifications a
    # solve).  Each gadget draws from a pool of 256 distinct (key, message,
    # low-S signature) tuples made from the seed and tiled over the batch; the
    # planted cases of utils.ecdsa_planted come first (instance i: case i on
    # gadget 0, case i + 1 on gadget 1; instance k: a signature byte of 256 +
    # b).  Every instance's valid bits, flag and first failure against its
    # construction, 8 witness maps against the sequential engine; one
    # ecdsa_mul launch a solve, and two inv_wide launches (s^-1, Z^-1).
    # ecdsa_k1 once more over 16,384 instances: its inversions of 32,768
    # values each fold into batch_inv_wide where LimbContext.fold_rows says
    # so (from FOLD_FROM_WIDE values), else run on inv_wide.  Then the wide kernels against their plain
    # versions on both curves' p and n, and ecdsa_mul on the solves' own
    # operands.
    from acvm_tpu_torch.gpu import ecdsa as gpu_ecdsa
    from acvm_tpu_torch.utils import ecdsa_inputs, ecdsa_planted

    ecdsa_B, ecdsa_seed = 4096, 7
    fold_B = 1 << 14  # the b16384 cell: 2 gadgets, 32,768 values to invert of each kind
    ecdsa_launches, ecdsa_report, ecdsa_operands = {}, {}, {}
    real_ecdsa_mul = gpu_ecdsa.ecdsa_mul

    for label, kind, curve_name, B_run in (("ecdsa_k1", "ecdsa_k1", "secp256k1", ecdsa_B),
                                           ("ecdsa_r1", "ecdsa_r1", "secp256r1", ecdsa_B),
                                           (f"ecdsa_k1_b{fold_B}", "ecdsa_k1", "secp256k1", fold_B)):
        def recording_ecdsa_mul(curve_name, u1, u2, Q, table, label=label):
            ecdsa_operands[label] = (u1.clone(), u2.clone(), Q.clone(), table)
            return real_ecdsa_mul(curve_name, u1, u2, Q, table)

        # mont_inv_grouped's choice for the 2 B values of each kind
        folded = LimbContext(gpu_ecdsa.curve_fields(curve_name)[0], dev).fold_rows(2 * B_run) > 1
        inv_kernel = "batch_inv_wide" if folded else "inv_wide"
        circuit = build_gadget_circuit(kind, 2)
        t0 = time.perf_counter()
        cols, want_valid, want_err = ecdsa_inputs(circuit, B_run, kind, seed=ecdsa_seed, pool=256)
        inputs_seconds = time.perf_counter() - t0
        k = len(ecdsa_planted(kind, ecdsa_seed))
        t0 = time.perf_counter()
        solver = BatchSolver(plan_circuit(circuit))
        plan_seconds = time.perf_counter() - t0
        gpu_ecdsa.ecdsa_mul = recording_ecdsa_mul
        build.reset_launches()
        try:
            res = pass_peak(label, lambda: solver.solve(cols), B_run, inputs=cols)
            torch.cuda.synchronize()
        finally:
            gpu_ecdsa.ecdsa_mul = real_ecdsa_mul
        launches = dict(build.LAUNCHES)
        assert launches["ecdsa_mul"] == 1 and launches["mul_wide"] > 0 and launches[inv_kernel] == 2, launches
        assert all(launches[name] == 0 for name in build.KERNELS
                   if name not in ("ecdsa_mul", "mul_wide", inv_kernel)), launches
        outs = np.array([res.witness_ints(int(op.call.output)) for op in circuit.opcodes], dtype=bool)
        assert np.array_equal(outs, want_valid & ~want_err), kind
        want_fail = np.where(want_err[0], 0, np.where(want_err[1], 1, int(FAIL_NONE)))
        assert np.array_equal(res.fail, want_fail) and np.array_equal(res.ok, ~want_err.any(0)), kind
        assert int(want_err.any(0).sum()) > 0 and int((~want_valid).sum()) > 0
        maps = [0, 3, 4, 9, 10, 11, k, B_run - 1]  # valid, off-curve key, r = 0, the edges, 256 + b
        for b in maps:
            status, acvm = sequential_solve(circuit, columnar_instance(cols, b), None)
            if status == "solved":
                got = res.instance_ints(b)
                solved = list(acvm.finalize())
                assert res.ok[b] and len(solved) == circuit.num_vars() - 1, b
                assert all(got[int(w)] == int(v) for w, v in solved), b
            else:
                location = getattr(acvm.error, "opcode_location", None)
                assert status == "failure" and int(res.fail[b]) == (
                    acvm.instruction_pointer if location is None else location.acir_index), (b, status)
        state = solver.initial_state(cols)
        rate, secs = timed_rate(device_solve_of(solver, state, torch), 2 * B_run, reps=3)
        stats = SolveStats()
        solver.solve(cols, stats=stats)
        rate_full, secs_full = timed_rate(lambda: solver.solve(cols), 2 * B_run, reps=3)
        if want_profile:
            emit({f"profile_{label}": profile(device_solve_of(solver, state, torch), secs)})
        ecdsa_launches[label] = launches
        ecdsa_report[label] = {
            "gadgets": 2, "batch": B_run, "verifications": 2 * B_run, "pool": 256,
            "inversions_by": inv_kernel, "panel_bytes": solver.panel_bytes(B_run),
            "planted": [label for label, _, _, _ in ecdsa_planted(kind, ecdsa_seed)],
            "valid": int(outs.sum()), "err": int(want_err.sum()), "ok_instances": int(res.ok.sum()),
            "checked_instances": B_run, "witness_maps_against_pwg": maps,
            "launches": {name: n for name, n in launches.items() if n},
            "launches_a_solve": sum(launches.values()),
            "inputs_seconds": inputs_seconds, "plan_seconds": plan_seconds,
            f"{kind}_solves_per_sec": rate, "solve_seconds": secs,
            f"{kind}_solves_per_sec_with_packing": rate_full, "solve_seconds_with_packing": secs_full,
            "solve_stats": stats.summary()}
        del state, res, solver
        torch.cuda.empty_cache()
    emit({"path_ecdsa": {"card": smi, **ecdsa_report}})

    # The wide kernels against their plain versions, tolerance 0, on both
    # curves' p and n: mul_wide at N = 2^20 (b any 256-bit value on a
    # quarter), pow_wide at the s^-1 shape (8,192 values, e = n - 2) and on the
    # schedule's edge exponents, batch_inv_wide at the folded solve's 32,768
    # values (mont_inv_grouped folds them into 2 rows).  A wide product is the same 136
    # multiply-adds as a narrow one (its ninth word costs adds only).
    wide_fields = [f for name in ("secp256k1", "secp256r1") for f in gpu_ecdsa.curve_fields(name)]
    k1_p, k1_n = wide_fields[0], wide_fields[1]
    n_mul = 1 << 20
    errs = []
    for params in wide_fields:
        a = random_elements((n_mul,), params, 61, zeros=3)
        b = random_elements((n_mul,), params, 62)
        b[: n_mul // 4] = torch.from_numpy(
            np.random.default_rng(63).integers(0, 1 << 32, size=(n_mul // 4, 8), dtype=np.uint64)
            .astype(np.uint32).view(np.int32)).to(dev)
        got = fk.mont_mul(a, b, params)
        want = torch.cat([fk.mont_mul_plain(a[i : i + (1 << 18)], b[i : i + (1 << 18)], params)
                          for i in range(0, n_mul, 1 << 18)])
        torch.cuda.synchronize()
        errs.append(max_abs_err(got, want))
        r2 = torch.from_numpy(fk.int_to_limbs32(params.r2).copy()).to(dev)
        errs.append(max_abs_err(fk.mont_mul(a, r2, params), fk.mont_mul_plain(a, r2, params)))
    a = random_elements((n_mul,), k1_p, 61)
    b = random_elements((n_mul,), k1_p, 62)
    a_bn, b_bn = random_elements((n_mul,), BN254_FR, 61), random_elements((n_mul,), BN254_FR, 62)
    out = torch.empty_like(a)
    b_ms, b_by = bound(96 * n_mul, MADDS_PER_MONT_MUL * n_mul)
    kernels["mul_wide"] = dict(
        name="mul_wide", route="cuda", source="acvm_tpu_torch/csrc/mul.cu (-DACVM_WIDE)",
        replaces="acvm_tpu/fields/jnp_ops.py:153", shape=f"N={n_mul}, secp256k1 p",
        fields=[f.name for f in wide_fields], max_abs_err=max(errs),
        ms=time_ms(lambda: fk.mont_mul(a, b, k1_p, out=out)),
        ms_queued=time_ms(lambda: fk.mont_mul(a, b, k1_p, out=out), calls=10),
        narrow_bn254_ms_same_call=time_ms(lambda: fk.mont_mul(a_bn, b_bn, BN254_FR, out=out)),
        plain_ms=time_ms(lambda: [fk.mont_mul_plain(a[i : i + (1 << 18)], b[i : i + (1 << 18)], k1_p)
                                  for i in range(0, n_mul, 1 << 18)], 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del a, b, a_bn, b_bn, out, got, want

    # inv_wide (constant-time divsteps, csrc/inv.cu) against its plain version
    # and pow_wide at e = M - 2, tolerance 0, on 8,192 values of each of the
    # four wide moduli, the edge lanes 0, R (one), M - 1, 1, 2, R^-1 and the
    # longest divstep run among 1,000 seeded draws first.  Timed at the s^-1
    # shape (8,192 values, n of secp256k1 and of secp256r1) beside pow_wide
    # on the same values; its latency floor is a lone warp's inversion (one
    # launch of 32 values, graph time).  Bound: inv.cuh's int32 operations
    # (fields/kernels.py::INV_OPS, counted from its code) and 64 bytes a value.
    n_inv = 2 * ecdsa_B
    r1_n = wide_fields[3]
    errs, inv_edges = [], {}
    for params in wide_fields:
        m, R = params.modulus, params.r
        draws = np.random.default_rng(66)
        pool = [int.from_bytes(draws.bytes(40), "little") % m for _ in range(1000)]
        longest = max(pool, key=lambda x: fk.divsteps_to_zero(x, m))
        edges = [0, R, m - 1, 1, 2, pow(R, -1, m), longest]
        a = random_elements((n_inv,), params, 64)
        a[: len(edges)] = torch.from_numpy(fk.ints_to_limbs32(edges).copy()).to(dev)
        build.reset_launches()
        got = fk.mont_inv(a, params)
        assert build.LAUNCHES["inv_wide"] == 1 and build.LAUNCHES["pow_wide"] == 0, build.LAUNCHES
        errs.append(max_abs_err(got, fk.mont_inv_divsteps_plain(a, params)))
        errs.append(max_abs_err(got, fk.mont_pow(a, m - 2, params)))
        r_inv = pow(R, -1, m)
        assert fk.limbs32_to_ints(got[: len(edges)].cpu().numpy()) == [
            pow(x * r_inv, -1, m) * R % m if x else 0 for x in edges], params.name
        inv_edges[params.name] = fk.divsteps_to_zero(longest, m)
    inv_rows = {}
    for params in (k1_n, r1_n):
        a = random_elements((n_inv,), params, 64)
        a32 = a[:32].clone()
        e = params.modulus - 2
        inv_rows[params.name] = dict(
            ms=time_ms(lambda: fk.mont_inv(a, params)),
            ms_queued=time_ms(lambda: fk.mont_inv(a, params), calls=10),
            ms_graph=graph_ms(lambda: fk.mont_inv(a, params)),
            latency_floor_ms=graph_ms(lambda: fk.mont_inv(a32, params)),
            pow_wide_ms_queued=time_ms(lambda: fk.mont_pow(a, e, params), calls=10),
            pow_wide_ms_graph=graph_ms(lambda: fk.mont_pow(a, e, params)),
            plain_ms=time_ms(lambda: fk.mont_inv_divsteps_plain(a, params), 3))
    b_ms, b_by = bound(64 * n_inv, fk.INV_OPS * n_inv)
    kernels["inv_wide"] = dict(
        name="inv_wide", route="cuda", source="acvm_tpu_torch/csrc/inv.cu",
        replaces="acvm_tpu/fields/jnp_ops.py:235",
        shape=f"N={n_inv} (the s^-1 of a solve), secp256k1 n; 20 x 30 divsteps a value",
        fields=[f.name for f in wide_fields], max_abs_err=max(errs),
        edge_lanes=["0", "R", "M - 1", "1", "2", "R^-1", "longest of 1,000 draws"],
        longest_divstep_run=inv_edges, **inv_rows[k1_n.name], secp256r1_n=inv_rows[r1_n.name],
        int32_ops_per_value=fk.INV_OPS,
        ops_counted="fields/kernels.py::INV_OPS (inv.cuh's divsteps and updates, counted from its "
                    "code) a value; bytes 64 a value",
        latency_floor_from="graph time of one launch of 32 values: a lone warp's inversion",
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del a, a32, got
    if "--fold-sweep" in sys.argv:
        # mont_inv_grouped's wide choice: n values as one inv_wide launch, or
        # folded into g rows of n / g columns and one batch_inv_wide launch (a
        # Fermat chain a block of chunks).
        fold = {}
        for n in (1 << k for k in range(13, 21)):
            x = random_elements((n,), k1_p, 67)
            row = {"inv_wide": time_ms(lambda: fk.mont_inv(x, k1_p), calls=10)}
            for g in (2, 4, 8, 16, 32):
                xg = x.reshape(g, n // g, 8)
                row[f"batch_inv_wide_g{g}"] = time_ms(lambda: fk.mont_batch_inv(xg, k1_p, 0, g), calls=10)
            fold[n] = row
        emit({"fold_sweep_wide": {"card": smi, "field": k1_p.name, "ms_queued": fold}})
        del x, xg

    # pow_wide, which inv_wide replaced on the path: mont_pow's wide route for
    # a general exponent, against its plain version on the schedule's edge
    # exponents; timed at the s^-1 shape as before.
    errs = []
    for params in wide_fields:
        a = random_elements((n_inv,), params, 64, zeros=5)
        a[5] = torch.from_numpy(fk.int_to_limbs32(params.modulus - 1).copy()).to(dev)
        for e in (0, 1, 2, 15, 16, params.modulus - 2, (1 << 256) - 1):
            errs.append(max_abs_err(fk.mont_pow(a, e, params), fk.mont_pow_plain(a, e, params)))
        r_one = torch.from_numpy(fk.int_to_limbs32(params.r).copy()).to(dev)
        inv = fk.mont_pow(a, params.modulus - 2, params)
        errs.append(max_abs_err(fk.mont_mul(a[5:], inv[5:], params), r_one.expand_as(a[5:])))
    a = random_elements((n_inv,), k1_n, 64)
    chain_n = fk.pow_chain_products(k1_n.modulus - 2)
    b_ms, b_by = bound(64 * n_inv, chain_n * MADDS_PER_MONT_MUL * n_inv)
    kernels["pow_wide"] = dict(
        name="pow_wide", route="cuda", source="acvm_tpu_torch/csrc/pow.cu (-DACVM_WIDE)",
        replaces="acvm_tpu/fields/jnp_ops.py:235",
        shape=f"N={n_inv} (the s^-1 of a solve), e = n - 2 of secp256k1, {chain_n} products a chain",
        fields=[f.name for f in wide_fields], max_abs_err=max(errs), replaced_on_path_by="inv_wide",
        ms=time_ms(lambda: fk.mont_pow(a, k1_n.modulus - 2, k1_n)),
        ms_queued=time_ms(lambda: fk.mont_pow(a, k1_n.modulus - 2, k1_n), calls=10),
        latency_floor_ms=chain_n * candidates["carry_flag_even_odd"]["us_per_product_in_chain"] * 1e-3,
        plain_ms=time_ms(lambda: fk.mont_pow_plain(a, k1_n.modulus - 2, k1_n), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del a, inv

    # batch_inv_wide on the 16,384-instance solve's 32,768 values in 2 rows,
    # and mont_inv_grouped on them (the launch LimbContext.fold_rows picks).
    n_fold = 2 * fold_B
    folds = LimbContext(k1_p, dev).fold_rows(n_fold) > 1
    errs = []
    for params in wide_fields:
        x = random_elements((n_fold,), params, 65, zeros=2)
        x[n_fold - 1] = x[n_fold // 4] = 0  # zeros at chunk edges
        got = fk.mont_batch_inv(x.reshape(2, fold_B, 8), params, 0, 2).reshape(n_fold, 8)
        errs.append(max_abs_err(got, fk.mont_batch_inv_plain(x.reshape(2, fold_B, 8), params, 0, 2)
                                .reshape(n_fold, 8)))
        errs.append(max_abs_err(got, fk.mont_inv(x, params)))
        build.reset_launches()
        errs.append(max_abs_err(LimbContext(params, dev).mont_inv_grouped(x), got))
        assert build.LAUNCHES["batch_inv_wide" if folds else "inv_wide"] == 1, build.LAUNCHES
    x = random_elements((n_fold,), k1_p, 65).reshape(2, fold_B, 8)
    chain_p = fk.pow_chain_products(k1_p.modulus - 2)
    needed = fold_B * chain_p + 3 * (n_fold - fold_B)
    b_ms, b_by = bound(64 * n_fold, needed * MADDS_PER_MONT_MUL)
    wide_plan = fk.batch_inv_plan(2, fold_B, 2, torch.cuda.get_device_properties(dev).multi_processor_count)
    k1_chain = fk.pow_schedule(k1_p.modulus - 2)
    wide_depth = 2 + 5 + 1 + max(wide_plan.lanes // 32 - 1, 0) + 1 \
        + 4 + sum(sq + 1 for sq, _ in k1_chain[1]) + k1_chain[2]
    kernels["batch_inv_wide"] = dict(
        name="batch_inv_wide", route="cuda", source="acvm_tpu_torch/csrc/batch_inv.cu (-DACVM_WIDE)",
        replaces="acvm_tpu/fields/jnp_ops.py:259",
        shape=f"G=2, L={fold_B}, chunk 2 (the s^-1 or Z^-1 of the {fold_B}-instance solve, "
              f"{n_fold} values, folded), secp256k1 p",
        plan=wide_plan._asdict(), chains=wide_plan.blocks,
        fields=[f.name for f in wide_fields], max_abs_err=max(errs), products_needed=needed,
        **({} if folds else {"replaced_on_path_by": "inv_wide"}),
        ms=time_ms(lambda: fk.mont_batch_inv(x, k1_p, 0, 2)),
        ms_queued=time_ms(lambda: fk.mont_batch_inv(x, k1_p, 0, 2), calls=10),
        ms_graph=graph_ms(lambda: fk.mont_batch_inv(x, k1_p, 0, 2)),
        latency_floor_ms=wide_depth * wide_chain["us_per_product_in_chain"] * 1e-3,
        latency_floor_from="dependent products on a block's path x int32.wide_mont_mul_chain"
                           ".us_per_product_in_chain",
        pow_ms_same_values=time_ms(lambda: fk.mont_pow(x, k1_p.modulus - 2, k1_p)),
        inv_wide_ms_queued_same_values=time_ms(lambda: fk.mont_inv(x, k1_p), calls=10),
        inv_wide_ms_graph_same_values=graph_ms(lambda: fk.mont_inv(x, k1_p)),
        plain_ms=time_ms(lambda: fk.mont_batch_inv_plain(x, k1_p, 0, 2), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del x, got

    # ecdsa_mul on the operands of each 4,096-instance solve above (8,192
    # lanes: u1, u2, Q as the path gives them) and the edge lanes of
    # utils.ecdsa_mul_edges after them, in one launch: X, Y and Z against the
    # plain version, which runs the same chain; the affine R of 64 path lanes
    # and of every edge lane on the curve against the Python-int curve.  Timed
    # on the path's 8,192 lanes alone.
    #
    # Products counted from the scalars as this kernel runs them
    # (ecdsa_chain_counts): u1 G a mixed addition of 11 for each nonzero window
    # after the first, the lane's table 73 / 74, four doublings a window once
    # the accumulator is finite, 16 a nonzero window's addition to a finite
    # accumulator, 16 the last addition.  Bytes: u1, u2, Q's X and Y and the
    # table read once, R written.  A warp runs a step's products where any of
    # its lanes does, so warp_chain_products, the most any warp's sum over the
    # steps of the most its 32 lanes run there, sets the latency floor at the
    # wide product's time in a chain (int32 line).
    from acvm_tpu_torch.blackbox.ec import Curve
    from acvm_tpu_torch.utils import ecdsa_mul_edges

    lib_ecdsa = build.load("ecdsa_mul")
    lib_ecdsa.acvm_ecdsa_mul_blocks_per_sm.argtypes = [ctypes.c_int]
    ecdsa_rows, ecdsa_parent = {}, {}
    for curve_name, kind in (("secp256k1", "ecdsa_k1"), ("secp256r1", "ecdsa_r1")):
        u1, u2, Q, table = ecdsa_operands[kind]
        B2 = u1.shape[0]
        edges = ecdsa_mul_edges(kind)
        e1, e2, eq = (t.to(dev) for t in gpu_ecdsa.mul_operands(curve_name, *zip(*[e[1:] for e in edges])))
        a1, a2, aq = torch.cat([u1, e1]), torch.cat([u2, e2]), torch.cat([Q, eq], dim=1)
        got = gpu_ecdsa.ecdsa_mul(curve_name, a1, a2, aq, table)
        t0 = time.perf_counter()
        want = gpu_ecdsa.ecdsa_mul_plain(curve_name, a1, a2, aq, table)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - t0
        err = max_abs_err(got, want)
        curve = Curve(gpu_ecdsa.CURVES[curve_name])
        fp, _ = gpu_ecdsa.curve_fields(curve_name)
        ctx_p = LimbContext(fp, dev)

        def affine(R):
            ax, ay = (fk.limbs32_to_ints(c.cpu().numpy()) for c in ec.pt_to_affine(ctx_p, ec.point_of(R)))
            return [None if inf else (x, y) for x, y, inf in zip(ax, ay, ec.pt_is_inf(ec.point_of(R)).tolist())]

        got_pts = affine(got)
        k1s, k2s = fk.limbs32_to_ints(a1.cpu().numpy()), fk.limbs32_to_ints(a2.cpu().numpy())
        qx, qy = (fk.limbs32_to_ints(fk.mont_mul(c, ctx_p.one_limbs, fp).cpu().numpy()) for c in (aq[0], aq[1]))
        checked = 0
        for lane in list(range(32)) + list(range(B2 - 32, B2 + len(edges))):
            q = (qx[lane], qy[lane])
            if not curve.is_on_curve(q):
                continue
            want_pt = curve.add(curve.mul(k1s[lane], curve.generator()), curve.mul(k2s[lane], q))
            assert got_pts[lane] == want_pt, (curve_name, lane)
            checked += 1
        del got, want, a1, a2, aq
        a3 = gpu_ecdsa._a_minus_3(curve_name)
        design = ecdsa_chain_counts(u1.cpu().numpy(), gpu_ecdsa.signed_windows(u2).cpu().numpy(),
                                    8 if a3 else 7)
        b_ms, b_by = bound(B2 * (32 + 32 + 64 + 96) + table.numel() * 4,
                           design["products"] * MADDS_PER_MONT_MUL)
        ecdsa_rows[curve_name] = dict(
            shape=f"B={B2} (the operands of path_ecdsa's solve), {curve_name}", max_abs_err=err,
            edge_lanes=[label for label, _, _, _ in edges], affine_checked_lanes=checked,
            products_per_lane=design["products"] / B2, longest_chain_products=design["longest_lane"],
            warp_chain_products=design["warp_chain"],
            ms=time_ms(lambda: gpu_ecdsa.ecdsa_mul(curve_name, u1, u2, Q, table), reps=5),
            ms_queued=time_ms(lambda: gpu_ecdsa.ecdsa_mul(curve_name, u1, u2, Q, table), reps=3, calls=5),
            latency_floor_ms=design["warp_chain"] * wide_chain["us_per_product_in_chain"] * 1e-3,
            shared_bytes_a_block=lib_ecdsa.acvm_ecdsa_mul_shared_bytes(),
            blocks_per_sm=lib_ecdsa.acvm_ecdsa_mul_blocks_per_sm(int(a3)),
            plain_ms=plain_seconds * 1e3, bound_ms=b_ms, bound_by=b_by)
        # The warp's chain is the lane's: every lane adds at the same windows.
        assert design["warp_chain"] <= design["longest_lane"] + 100, ecdsa_rows[curve_name]
        if parent_tree:
            # The parent tree's kernel on the same operands, compared on the
            # affine R (its X, Y and Z come from another chain), timed parent,
            # change, change, parent.
            fns = {"parent": build.load_variant(
                       "ecdsa_mul", [], source=f"{parent_tree}/acvm_tpu_torch/csrc/ecdsa_mul.cu"),
                   "change": build.load_variant("ecdsa_mul", [])}
            field_ptr = fk._host_ptr(fk.field_words(fp))
            outs = {side: torch.empty((3, B2, 8), dtype=torch.int32, device=dev) for side in fns}

            def run(side):
                assert fns[side](u1.data_ptr(), u2.data_ptr(), Q.data_ptr(), table.data_ptr(),
                                 outs[side].data_ptr(), B2, int(a3), field_ptr,
                                 torch.cuda.current_stream().cuda_stream) == 0, side

            for side in fns:
                run(side)
            torch.cuda.synchronize()
            assert affine(outs["parent"]) == affine(outs["change"]) == got_pts[:B2], curve_name
            row = {"parent_ms": [], "change_ms": [], "parent_ms_queued": [], "change_ms_queued": []}
            for side in ("parent", "change", "change", "parent"):
                row[f"{side}_ms"].append(time_ms(lambda: run(side), reps=5))
                row[f"{side}_ms_queued"].append(time_ms(lambda: run(side), reps=3, calls=5))
            ecdsa_parent[curve_name] = {"lanes": B2, "equal_affine_R": True, **row}
            del outs
    first = ecdsa_rows.pop("secp256k1")
    # The same kernel on the 16,384-instance solve's 32,768 lanes: four times
    # the warps, its bound and floor counted on those lanes' own scalars.
    u1, u2, Q, table = ecdsa_operands[f"ecdsa_k1_b{fold_B}"]
    lanes = u1.shape[0]
    first[f"ms_lanes_{lanes}"] = time_ms(lambda: gpu_ecdsa.ecdsa_mul("secp256k1", u1, u2, Q, table),
                                         reps=5)
    first[f"ms_queued_lanes_{lanes}"] = time_ms(
        lambda: gpu_ecdsa.ecdsa_mul("secp256k1", u1, u2, Q, table), reps=3, calls=5)
    design = ecdsa_chain_counts(u1.cpu().numpy(), gpu_ecdsa.signed_windows(u2).cpu().numpy(), 7)
    b_ms, b_by = bound(lanes * (32 + 32 + 64 + 96) + table.numel() * 4,
                       design["products"] * MADDS_PER_MONT_MUL)
    first[f"bound_ms_lanes_{lanes}"], first[f"bound_by_lanes_{lanes}"] = b_ms, b_by
    first[f"warp_chain_products_lanes_{lanes}"] = design["warp_chain"]
    first[f"latency_floor_ms_lanes_{lanes}"] = design["warp_chain"] * wide_chain["us_per_product_in_chain"] * 1e-3
    del u1, u2, Q, table
    kernels["ecdsa_mul"] = dict(
        name="ecdsa_mul", route="cuda", source="acvm_tpu_torch/csrc/ecdsa_mul.cu",
        replaces="acvm_tpu/tpu/ecdsa.py:147", **first, library_ms=None,
        secp256r1=ecdsa_rows["secp256r1"],
        also_replaces=["acvm_tpu/tpu/ec.py:336", "acvm_tpu/tpu/ec.py:273"],
        bound_counts="bytes: u1, u2, Q's X and Y and the table read, R written; products from the "
                     "scalars as this kernel runs them (ecdsa_chain_counts)",
        latency_floor_from="warp_chain_products x us_per_product_in_chain of the wide product "
                           "(int32 line, wide_mont_mul_chain)")
    assert kernels["ecdsa_mul"]["max_abs_err"] == 0 and ecdsa_rows["secp256r1"]["max_abs_err"] == 0
    del ecdsa_operands
    torch.cuda.empty_cache()

    # The kernels built over field.cuh and ec.cuh (mul, pow, batch_inv, their
    # wide modes on secp256k1's p, pt_add, pt_ladder), built from the parent
    # tree at --parent=DIR beside this tree's and timed in one call, parent,
    # change, change, parent, at their rows' shapes; each pair of outputs
    # equal.  ecdsa_mul's pair (above, compared on the affine R) and the hash
    # kernels' (path_hash, at every hash row's shape) join the line.
    if parent_tree:
        shape_rng = np.random.default_rng(71)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        words = fk._host_ptr(fk.field_words(BN254_FR))
        a = random_elements((1 << 20,), BN254_FR, 72)
        b = random_elements((1 << 20,), BN254_FR, 73)
        inv_in = random_elements((2048, 2048), BN254_FR, 74)
        ex = torch.from_numpy(exceptional_panel(2048)).to(dev)
        P_pts, Q_pts = ex[0][None].repeat(64, 1, 1, 1), ex[1][None].repeat(64, 1, 1, 1)
        k_lad = torch.from_numpy(shape_rng.integers(0, 1 << 32, size=(2048, 8), dtype=np.uint64)
                                 .astype(np.uint32).view(np.int32)).to(dev)
        sched = fk._host_ptr(fk.pow_schedule_words(P - 2))
        k1_p = gpu_ecdsa.curve_fields("secp256k1")[0]
        wide_words = fk._host_ptr(fk.field_words(k1_p))
        wide_sched = fk._host_ptr(fk.pow_schedule_words(k1_p.modulus - 2))
        wa = random_elements((1 << 20,), k1_p, 75)
        wb = random_elements((1 << 20,), k1_p, 76)
        wide_inv_in = random_elements((2, fold_B), k1_p, 77)

        def out_like(t):
            return torch.empty_like(t)

        def inv_plan_args(G, L, max_scan):
            """The plan arguments of the batch_inv launcher (this tree's
            and the parent's)."""
            plan = fk.batch_inv_plan(G, L, max_scan, torch.cuda.get_device_properties(dev).multi_processor_count)
            return (plan.g, plan.lanes)

        cases = {  # kernel: (output, C arguments after the output is made)
            "mul": (out_like(a), lambda o: (a.data_ptr(), b.data_ptr(), o.data_ptr(), 1 << 20, 0, 1, words,
                                            stream())),
            "pow": (out_like(a[: 1 << 16]), lambda o: (a.data_ptr(), o.data_ptr(), 1 << 16, sched, words,
                                                       stream())),
            "batch_inv": (out_like(inv_in), lambda o: (inv_in.data_ptr(), o.data_ptr(), 2048, 2048,
                                                       *inv_plan_args(2048, 2048, _DYN_INV_CHUNK),
                                                       sched, words, stream())),
            "pt_add": (out_like(P_pts), lambda o: (*ec_fused._view_args(P_pts, "P"),
                                                   *ec_fused._view_args(Q_pts, "Q"),
                                                   *ec_fused._view_args(o, "out"), 64, 2048, words,
                                                   stream())),
            "pt_ladder": (torch.empty((3, 2048, 8), dtype=torch.int32, device=dev),
                          lambda o: (ex[0].data_ptr(), 2048 * 8, 8, k_lad.data_ptr(), o.data_ptr(),
                                     2048 * 8, 8, 2048, words, stream())),
            "pt_ladder_schnorr": (torch.empty((3, 2048, 8), dtype=torch.int32, device=dev),
                                  lambda o: (sch_panel.data_ptr(), 2048 * 8, 8, sch_k.data_ptr(), o.data_ptr(),
                                             2048 * 8, 8, 2048, words, stream())),
            "mul_wide": (out_like(wa), lambda o: (wa.data_ptr(), wb.data_ptr(), o.data_ptr(), 1 << 20, 0, 1,
                                                  wide_words, stream())),
            "pow_wide": (out_like(wa[:8192]), lambda o: (wa.data_ptr(), o.data_ptr(), 8192, wide_sched,
                                                         wide_words, stream())),
            "batch_inv_wide": (out_like(wide_inv_in), lambda o: (wide_inv_in.data_ptr(), o.data_ptr(), 2,
                                                                 fold_B, *inv_plan_args(2, fold_B, 2),
                                                                 wide_sched, wide_words, stream())),
        }
        compare = {}
        kernel_of = {"pt_ladder_schnorr": "pt_ladder"}  # another shape of a kernel above
        for label, (out0, args) in cases.items():
            name = kernel_of.get(label, label)
            source = f"{parent_tree}/acvm_tpu_torch/csrc/{build.VARIANTS.get(name, (name,))[0]}.cu"
            fns = {"parent": build.load_variant(name, [], source=source),
                   "change": build.load_variant(name, [])}
            sass = [sass_instructions(build.lib_path(name, [], Path(source))),
                    sass_instructions(build.lib_path(name))]
            outs = {}
            for side, fn in fns.items():
                outs[side] = out_like(out0)
                assert fn(*args(outs[side])) == 0, (label, side)
            torch.cuda.synchronize()
            assert torch.equal(outs["parent"], outs["change"]), label
            row = {f"{side}_{how}": [] for side in ("parent", "change")
                   for how in ("ms", "ms_queued", "ms_graph")}
            row.update({"sass_instructions": [None if t is None else len(t) for t in sass],
                        "sass_identical": None if None in sass else sass[0] == sass[1]})
            for side in ("parent", "change", "change", "parent"):
                o = outs[side]
                run = lambda fn=fns[side], o=o: fn(*args(o))  # noqa: E731
                row[f"{side}_ms"].append(time_ms(run))
                row[f"{side}_ms_queued"].append(time_ms(run, calls=10))
                row[f"{side}_ms_graph"].append(graph_ms(run, launches=5))
            if name == "batch_inv":   # each tree at each chunk
                for side in ("parent", "change"):
                    row[f"{side}_ms_queued_by_chunk"] = {g: time_ms(lambda g=g, f=fns[side], o=outs[side]: f(
                        inv_in.data_ptr(), o.data_ptr(), 2048, 2048, *inv_plan_args(2048, 2048, g),
                        sched, words, stream()), calls=10) for g in (32, 64, 128, 256)}
            compare[label] = row
        # This tree's inv_wide beside the parent's pow_wide at the s^-1 shape
        # (8,192 values, e = n - 2 of secp256k1): equal outputs, then timed
        # parent, change, change, parent.
        k1_n = gpu_ecdsa.curve_fields("secp256k1")[1]
        s_in = random_elements((8192,), k1_n, 78)
        parent_pow = build.load_variant("pow_wide", [], source=f"{parent_tree}/acvm_tpu_torch/csrc/pow.cu")
        n_args = (fk._host_ptr(fk.pow_schedule_words(k1_n.modulus - 2)), fk._host_ptr(fk.field_words(k1_n)))
        p_out = torch.empty_like(s_in)
        sides = {"parent": lambda: parent_pow(s_in.data_ptr(), p_out.data_ptr(), 8192, *n_args, stream()),
                 "change": lambda: fk.mont_inv(s_in, k1_n)}
        assert sides["parent"]() == 0
        assert torch.equal(p_out, sides["change"]()), "inv_wide against the parent's pow_wide"
        row = {f"{side}_{how}": [] for side in ("parent", "change") for how in ("ms_queued", "ms_graph")}
        for side in ("parent", "change", "change", "parent"):
            row[f"{side}_ms_queued"].append(time_ms(sides[side], calls=10))
            row[f"{side}_ms_graph"].append(graph_ms(sides[side]))
        compare["inv_wide_vs_parent_pow_wide"] = {"shape": "N=8192, secp256k1 n", **row}
        del s_in, p_out
        compare["ecdsa_mul"] = ecdsa_parent
        compare.update(hash_parent)
        emit({"parent_compare": {"card": smi, "parent": parent_tree, "equal_outputs": True,
                                 "order": "parent, change, change, parent", "kernels": compare}})
        del a, b, inv_in, ex, P_pts, Q_pts, k_lad, cases, wa, wb, wide_inv_in, sch_panel, sch_k
        torch.cuda.empty_cache()

    # -- 16b. path_api: the product surface -------------------------------------------
    # The JAX package's north-star shape (bench.py:326-354, 10,240 instances of
    # the 2^16-gate circuit) through the serialized circuit, EngineConfig and
    # api.execute_circuit_batched: streamed in passes of 2,048 and in one pass;
    # the same circuit compiled to width 3 (what nargo hands a PLONK backend);
    # the CLI on the acvm_js addition fixture; the compiled BLAKE2s and
    # Keccak-256 fallbacks.  Each drive's launches are counted from 0.
    import contextlib
    import io
    import tempfile
    from collections import Counter

    from acvm_tpu_torch import api, cli
    from acvm_tpu_torch.blackbox import hashes as host_hashes
    from acvm_tpu_torch.acir import Circuit as AcirCircuit
    from acvm_tpu_torch.acir.serialization import serialize_circuit
    from acvm_tpu_torch.config import EngineConfig
    from acvm_tpu_torch.gpu.batch_solver import PASS_PEAK_OVER_ESTIMATE

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from golden_vectors import ADDITION_CIRCUIT

    torch.cuda.empty_cache()
    api_launches, api_report = {}, {"card": smi}
    api_t0 = time.perf_counter()

    def counted(label, fn):
        build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        api_launches[label] = dict(build.LAUNCHES)
        return out

    def stdout_of(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return buf.getvalue()

    with tempfile.TemporaryDirectory(prefix="acvm_path_api_") as tmp:
        tmp = Path(tmp)
        # (a) b10k: serialize, write, read back; five passes of 2,048, then one.
        b10k, b10k_pass = 10240, 2048
        circuit = build_wide_arith_circuit()
        gates = len(circuit.opcodes)
        t0 = time.perf_counter()
        data = serialize_circuit(circuit)
        serialize_seconds = time.perf_counter() - t0
        (tmp / "wide.acir.gz").write_bytes(data)
        t0 = time.perf_counter()
        circuit_read = AcirCircuit.read((tmp / "wide.acir.gz").read_bytes())
        read_seconds = time.perf_counter() - t0
        assert len(circuit_read.opcodes) == gates
        assert circuit_read.current_witness_index == circuit.current_witness_index
        inputs = random_inputs(circuit_read, b10k)
        config = EngineConfig()
        t0 = time.perf_counter()
        streamed = counted("api_b10k", lambda: pass_peak("b10k_streamed_2048", lambda: api.execute_circuit_batched(
            data, inputs, config, max_batch_per_pass=b10k_pass), b10k_pass))
        api_streamed_seconds = time.perf_counter() - t0
        assert streamed.ok.shape == (b10k,) and streamed.ok.all() and (streamed.fail == FAIL_NONE).all()
        assert api_launches["api_b10k"]["level"] == 8 * b10k // b10k_pass, api_launches["api_b10k"]
        one = pass_peak("b10k_one_pass", lambda: api.execute_circuit_batched(data, inputs, config), b10k)
        assert one.solver.max_batch_per_pass() >= b10k and one.panel.shape[1] == b10k
        assert np.array_equal(one.ok, streamed.ok) and np.array_equal(one.fail, streamed.fail)
        # solve_chunks: chunks 0 and 4 equal the one-pass panel's columns.
        plan = config.plan(circuit_read)
        stream_solver = config.solver(plan, max_batch_per_pass=b10k_pass)
        one_solver = config.solver(plan)
        chunks_checked = []
        for k, chunk in enumerate(stream_solver.solve_chunks(inputs)):
            if k in (0, 4):
                lo = k * b10k_pass
                assert torch.equal(chunk.panel, one.panel[:, lo : lo + b10k_pass]), k
                chunks_checked.append(k)
            chunk.release()
        assert chunks_checked == [0, 4]
        keep = (0, 5000, b10k - 1)
        b10k_values = {b: one.instance_ints(b) for b in keep}  # held to the evaluator in (b)
        del one, chunk
        torch.cuda.empty_cache()
        # The rate as bench.py:326-354 defines it: gates x instances / wall of
        # one solve() of the whole batch, packing included, planning not.
        stream_solver.solve(inputs[:b10k_pass])  # warm-up
        rate_streamed, secs_streamed = timed_rate(lambda: stream_solver.solve(inputs), gates * b10k, reps=2)
        rate_one, secs_one = timed_rate(lambda: one_solver.solve(inputs).ok, gates * b10k, reps=2)
        stats = SolveStats()
        stream_solver.solve(inputs, stats=stats)
        busy = profile(lambda: stream_solver.solve(inputs), secs_streamed)
        api_report["b10k"] = {
            "gates": gates, "instances": b10k, "serialized_bytes": len(data),
            "serialize_seconds": serialize_seconds, "read_seconds": read_seconds,
            "pass_instances": b10k_pass, "passes": stats.passes,
            "default_pass_instances": one_solver.max_batch_per_pass(),
            "flags_streamed_equal_one_pass": True, "chunk_panels_equal": chunks_checked,
            "checked_instances": list(keep), "api_call_seconds_streamed": api_streamed_seconds,
            "b10k_solves_per_sec": rate_streamed, "solve_seconds": secs_streamed,
            "b10k_solves_per_sec_one_pass": rate_one, "solve_seconds_one_pass": secs_one,
            "solve_stats_streamed": stats.summary(), "segment_seconds": stats.segment_seconds,
            "device_busy_share_streamed": busy["device_busy_share"],
            "device_busy_ms_streamed": busy["device_busy_ms"], "profile_streamed_top": busy["top"][:4],
            "upload": "pinned host buffer, non_blocking copy on a second stream",
            "panel_bytes_one_pass": one_solver.panel_bytes(b10k)}
        del stream_solver, one_solver, plan, streamed
        torch.cuda.empty_cache()

        # (b) the nargo path: compiled to width 3, serialized, read, solved
        # in one pass at the default pass size.
        t0 = time.perf_counter()
        compiled, _ = config.compile(circuit_read)
        compile_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled_data = compiled.write()
        compiled_serialize_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = AcirCircuit.read(compiled_data)
        compiled_read_seconds = time.perf_counter() - t0
        cres = counted("api_compiled", lambda: pass_peak(
            "compiled_one_pass", lambda: api.execute_circuit_batched(compiled_data, inputs, config), b10k))
        csolver = cres.solver
        assert cres.ok.all() and (cres.fail == FAIL_NONE).all() and cres.panel.shape[1] == b10k
        n_orig = circuit.current_witness_index + 1
        for b in keep:
            assert cres.instance_ints(b)[:n_orig] == b10k_values[b][:n_orig], b
        check_instances(circuit, inputs, cres, keep)  # the original witnesses
        # The level kernel's instantiation on each compiled level: <2, 1> for
        # a level of (t1, t2) = (2, 1), else the runtime-count <-1, -1>.
        clevels = [lv["arith_static"] for seg in cres.solver.segments for lv in seg.levels
                   if lv.get("arith_static")]
        inst = Counter("<2, 1>" if (lv["t1"], lv["t2"]) == (2, 1) else "<-1, -1>" for lv in clevels)
        widest = max(clevels, key=lambda lv: lv["desc"].shape[0])
        cW = cres.panel  # re-solving a level writes the values it holds
        wdesc, wt1, wt2 = widest["desc"], widest["t1"], widest["t2"]
        widest_ms = time_ms(lambda: fused_level_call(cW, wdesc, BN254_FR, wt1, wt2), reps=3)
        # Its bound as path_static's: live terms' distinct operand rows read
        # and the outputs written once, the live terms' products.
        wE, wo = wdesc.shape[0], wt1 + 2 * wt2 + 1
        w_lin = (wdesc[:, wo : wo + 8 * wt1].reshape(wE, wt1, 8) != 0).any(-1)
        w_mul = (wdesc[:, wo + 8 * wt1 : wo + 8 * (wt1 + wt2)].reshape(wE, wt2, 8) != 0).any(-1)
        w_rows = torch.unique(torch.cat([
            wdesc[:, :wt1][w_lin], wdesc[:, wt1 : wt1 + 2 * wt2].reshape(wE, wt2, 2)[w_mul].reshape(-1)])).numel()
        widest_bound, widest_by = bound(32 * b10k * (w_rows + wE) + wdesc.numel() * 4,
                                        int(w_lin.sum() + 2 * w_mul.sum()) * MADDS_PER_MONT_MUL * b10k)
        del cW
        rate_c, secs_c = timed_rate(lambda: csolver.solve(inputs).ok, len(compiled.opcodes) * b10k, reps=2)
        api_report["compiled"] = {
            "opcodes_in": gates, "opcodes": len(compiled.opcodes),
            "current_witness_index": compiled.current_witness_index, "instances": b10k,
            "compile_seconds": compile_seconds, "serialize_seconds": compiled_serialize_seconds,
            "read_seconds": compiled_read_seconds, "serialized_bytes": len(compiled_data),
            "passes": 1, "panel_bytes": csolver.panel_bytes(b10k), "levels": len(clevels),
            "level_instantiations": dict(inst),
            "widest_level": {"E": wE, "t1": wt1, "t2": wt2,
                             "instantiation": "<2, 1>" if (wt1, wt2) == (2, 1) else "<-1, -1>",
                             "ms": widest_ms, "bound_ms": widest_bound, "bound_by": widest_by},
            "original_witnesses_equal_b10k_and_evaluator": list(keep),
            "compiled_solves_per_sec": rate_c, "solve_seconds": secs_c,
            "compiled_gate_solves_per_sec_original_gates": gates * b10k / secs_c}
        del cres, csolver, compiled, circuit_read, inputs
        torch.cuda.empty_cache()

        # (c) the CLI on the acvm_js addition fixture.
        add = tmp / "addition.acir.gz"
        add.write_bytes(ADDITION_CIRCUIT)
        out = counted("api_cli", lambda: json.loads(stdout_of(
            ["solve", "--circuit", str(add), "--witness-json", '{"1": 1, "2": 2}', "--batch", "4096"])))
        assert out["satisfied"] == 4096 and out["device"].startswith("cuda"), out
        executed = json.loads(stdout_of(["execute", "--circuit", str(add), "--witness-json",
                                         '{"1": 1, "2": "0x02"}']))
        assert int(executed["3"], 16) == 3
        info = json.loads(stdout_of(["info", "--circuit", str(add)]))
        assert info["opcodes"] == 1 and info["return_values"] == [3]
        comp = json.loads(stdout_of(["compile", "--circuit", str(add), "--output", str(tmp / "c.gz")]))
        assert comp["opcodes_out"] >= 1 and (tmp / "c.gz").stat().st_size > 0
        api_report["cli"] = {"solve": out, "execute_w3": executed["3"], "info": info, "compile": comp}

    # (d) the compiled hash fallbacks: the hash black boxes refused, solved at
    # path_sha's 4,096 random messages as a uint8 matrix on the card.
    fallback_B = 4096
    hash_calls = (ops.BBSha256, ops.BBBlake2s, ops.BBKeccak256, ops.BBKeccak256VariableLength,
                  ops.BBHashToField128Security)

    def refuse_hashes(op):
        return not (isinstance(op, ops.OpcodeBlackBoxFuncCall) and isinstance(op.call, hash_calls))

    for kind, host in (("blake2s", hashlib.blake2s), ("keccak256", None)):
        gadget = build_gadget_circuit(kind, 1, 32)
        t0 = time.perf_counter()
        fallback, _ = config.compile(gadget, refuse_hashes)
        compile_seconds = time.perf_counter() - t0
        assert not any(isinstance(op, ops.OpcodeBlackBoxFuncCall) and isinstance(op.call, hash_calls)
                       for op in fallback.opcodes)
        call = gadget.opcodes[0].call
        ins = [int(fi.witness) for fi in call.inputs]
        matrix = torch.from_numpy(np.random.default_rng(23).integers(
            0, 256, size=(fallback_B, len(ins)), dtype=np.uint8)).to(dev)
        fsolver = config.solver(config.plan(fallback))
        t0 = time.perf_counter()
        fstats = SolveStats()
        fres = counted(f"api_{kind}_fallback", lambda: pass_peak(
            f"{kind}_fallback", lambda: fsolver.solve((ins, matrix), stats=fstats), fallback_B,
            inputs=(ins, matrix)))
        wall = time.perf_counter() - t0
        assert fres.ok.all() and (fres.fail == FAIL_NONE).all(), kind
        out_rows = torch.tensor([int(w) for w in call.outputs], device=dev)
        digests = fres.panel.index_select(0, out_rows)[..., 0].cpu().numpy().astype(np.uint8)
        messages = matrix.cpu().numpy()
        for b in range(fallback_B):
            want = (host(messages[b].tobytes()).digest() if host else
                    host_hashes.keccak256(messages[b].tobytes()))
            assert digests[:, b].tobytes() == want, (kind, b)
        api_report[f"{kind}_fallback"] = {
            "message_bytes": 32, "instances": fallback_B, "opcodes": len(fallback.opcodes),
            "compile_seconds": compile_seconds, "levels": len(fsolver.plan.levels),
            "solve_seconds": wall, "digests_checked": fallback_B,
            "launches": {k: v for k, v in api_launches[f"api_{kind}_fallback"].items() if v},
            "host_stages": sum(len(seg.host_stages) for seg in fsolver.segments),
            "host_per_instance_stages": fstats.host_per_instance_stages}
        del fres, fsolver, matrix
        torch.cuda.empty_cache()
    kernels["level"]["compiled_levels"] = {
        "instantiations": api_report["compiled"]["level_instantiations"],
        "widest": api_report["compiled"]["widest_level"]}
    # Every path's first solve against the solver's estimate of a pass: the
    # default pass size holds only if no peak passes it.
    api_report["pass_peaks"] = PASS_PEAKS
    api_report["pass_peak_over_estimate_limit"] = PASS_PEAK_OVER_ESTIMATE
    worst = max(PASS_PEAKS, key=lambda k: PASS_PEAKS[k]["peak_over_estimate"])
    api_report["worst_peak_over_estimate"] = {"path": worst, **PASS_PEAKS[worst]}
    if STEP_PEAKS:
        api_report["step_peaks"] = step_peak_summary(STEP_PEAKS)
        out_file = next((a.split("=", 1)[1] for a in sys.argv if a.startswith("--step-peaks=")), None)
        if out_file:
            Path(out_file).write_text(json.dumps(STEP_PEAKS))
    emit({"path_api": {"ok": True, "passed": ["a", "b", "c", "d"],
                       "phase_seconds": time.perf_counter() - api_t0, **api_report,
                       "launches": {label: {k: v for k, v in c.items() if v}
                                    for label, c in api_launches.items()}}})
    assert PASS_PEAKS[worst]["peak_over_estimate"] <= PASS_PEAK_OVER_ESTIMATE, (
        worst, PASS_PEAKS[worst])

    # -- 16c. native, dot_mxu, path_dyn_mxu, path_mesh -------------------------------
    # The last modules of the port: the host Grumpkin library, the tensor-core
    # expression dot and the batch sharded over a mesh.  Each drive's launches
    # are counted from 0.
    import random
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from acvm_tpu_torch import native
    from acvm_tpu_torch.fields import mxu_ops
    from acvm_tpu_torch.parallel import launcher, make_mesh

    last_t0 = time.perf_counter()
    torch.cuda.empty_cache()

    # native: g++ builds the library (timed into a scratch directory), then it
    # is held against the pure-Python curve: scalar multiples at the edges,
    # additions through infinity, an MSM, the window tables, the host black
    # boxes; one 64-window table and each gadget solver's plan and tables,
    # native and plain, in turns (plain, native, native, plain).
    build_dir = native.BUILD_DIR
    with tempfile.TemporaryDirectory(prefix="acvm_native_") as tmp:
        native.BUILD_DIR = Path(tmp)
        t0 = time.perf_counter()
        native.build()
        native_build_seconds = time.perf_counter() - t0
        native.BUILD_DIR = build_dir
    curve = host_gk.grumpkin
    G = curve.generator()
    rng_n = random.Random(18)
    scalars_n = [0, 1, 2, N_ORDER - 1, N_ORDER, (1 << 256) - 1] + [rng_n.randrange(N_ORDER)
                                                                  for _ in range(10)]
    for k in scalars_n:
        assert native.grumpkin_mul(G, k) == curve.mul(k % N_ORDER, G), k
    pts_n = [curve.mul(rng_n.randrange(N_ORDER), G) for _ in range(6)] + [None]
    for a in pts_n:
        for b in (pts_n[0], a, None if a is None else curve.neg(a), None):
            assert native.grumpkin_add(a, b) == curve.add(a, b)
    want = None
    for p_i, k in zip(pts_n, scalars_n):
        want = curve.add(want, curve.mul(k % N_ORDER, p_i))
    assert native.grumpkin_msm(pts_n, scalars_n[:len(pts_n)]) == want
    assert native.grumpkin_mul_batch(G, scalars_n) == [curve.mul(k % N_ORDER, G) for k in scalars_n]
    for i in range(2):
        gen = host_gk.derive_generator(0, i)
        assert np.array_equal(ec._window_table_np(gen), ec._window_table_np(gen, native=False))
    low, high = fe(rng_n.randrange(1 << 128)), fe(rng_n.randrange(1 << 120))
    assert host_gk.fixed_base_scalar_mul(low, high) == host_gk.fixed_base_scalar_mul(
        low, high, native=False)
    ins = [fe(rng_n.randrange(P)) for _ in range(3)]
    assert host_gk.pedersen_commit(ins, 0) == host_gk.pedersen_commit(ins, 0, native=False)
    key = rng_n.randrange(1, N_ORDER)
    pub = host_gk.schnorr_public_key(key)
    sig = host_gk.schnorr_sign(key, b"native")
    for use in (True, False):
        assert host_gk.schnorr_verify(pub[0], pub[1], sig, b"native", native=use)
        assert not host_gk.schnorr_verify(pub[0], pub[1], sig, b"nativf", native=use)

    def table_ms(use_native, reps=5):
        times = []
        for _ in range(reps):
            ec._window_table_np.cache_clear()
            t0 = time.perf_counter()
            ec._window_table_np(G, ec.NUM_WINDOWS, use_native)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    window_window = ec.window_table

    def plan_and_tables(circuit, use_native):
        """plan_circuit + BatchSolver (which builds the window tables), the
        tables' cache emptied first; the plain tables by the solver's own
        calls to ec.window_table with native=False."""
        ec._window_table_np.cache_clear()
        if not use_native:
            ec.window_table = lambda p, windows=ec.NUM_WINDOWS, device="cuda", native=True: \
                window_window(p, windows, device, False)
        try:
            t0 = time.perf_counter()
            BatchSolver(plan_circuit(circuit))
            return time.perf_counter() - t0
        finally:
            ec.window_table = window_window

    tables_report = {"table_ms": {}, "plan_and_tables_seconds": {}}
    for order in ("plain", "native", "native", "plain"):
        tables_report["table_ms"].setdefault(order, []).append(table_ms(order == "native"))
    for kind, n in (("fixed_base", 4), ("pedersen", 2), ("schnorr", 2)):
        gadget_circuit = build_gadget_circuit(kind, n, msg_len=32)
        secs = {}
        for order in ("plain", "native", "native", "plain"):
            secs.setdefault(order, []).append(plan_and_tables(gadget_circuit, order == "native"))
        tables_report["plan_and_tables_seconds"][kind] = secs
    ec._window_table_np.cache_clear()
    emit({"native": {"card": smi, "ok": True, "library": native.library_path().name,
                     "build_seconds": native_build_seconds,
                     "checked": {"scalars": len(scalars_n), "points": len(pts_n),
                                 "tables": 2, "black_boxes": 3},
                     **tables_report}})

    # dot_mxu against its plain version: every term count 1-8 at the edges
    # (zeros, ones, p - 1, a zero coefficient: a padding term; 300 instances,
    # a ragged last block; one instance), then the timed panels: row 4's shape
    # without scale (E = B = 2,048, T = 3) and the wide panels the JAX gate's
    # docstring names (T = 4 and 8 at E = 8,192, B = 2,048); each also
    # against the v2 dot on the same panel, which is timed beside it.
    top_limb = (P >> 224) - 1

    def card_elements(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        raw = torch.randint(0, 1 << 32, (*shape, 8), dtype=torch.int64, device=dev, generator=g)
        raw[..., 7] %= top_limb
        return fk.wrap_i32(raw)

    def limb_row(v):
        return torch.from_numpy(fk.int_to_limbs32(v).copy()).to(dev)

    ctx_mxu = LimbContext(BN254_FR, dev)
    errs = []
    for T in range(1, 9):
        for E, B in ((16, 300), (3, 1)):
            vals = card_elements((E, T, B), 100 + T)
            coeffs = card_elements((E, T), 200 + T)
            qc = card_elements((E,), 300 + T)
            vals[0] = 0
            vals[-1] = limb_row(P - 1)
            vals[:, 0, :1] = limb_row(1)
            coeffs[-1] = limb_row(P - 1)
            qc[-1] = limb_row(P - 1)
            if E > 3:
                coeffs[1, T - 1] = 0
                coeffs[2] = 0
                qc[2] = 0
            got = mxu_ops.mont_dot_mxu(vals, coeffs, qc)
            errs.append(max_abs_err(got, mxu_ops.mont_dot_mxu_plain(vals, coeffs, qc)))
            want_v2 = fk.mont_dot(vals, coeffs, None, None, None, ctx_mxu.from_mont(qc), None)
            errs.append(max_abs_err(got, want_v2))
    mxu_shapes = {}
    for label, E, T, B in (("row4_t3", 2048, 3, 2048), ("wide_t4", 8192, 4, 2048),
                           ("wide_t8", 8192, 8, 2048)):
        vals = torch.cat([card_elements((E, 1, B), 400 + 10 * T + t) for t in range(T)], dim=1)
        coeffs = card_elements((E, T), 500 + T)
        qc = card_elements((E,), 600 + T)
        qc_std = ctx_mxu.from_mont(qc)
        got = mxu_ops.mont_dot_mxu(vals, coeffs, qc)
        checked = E if label == "row4_t3" else 256
        errs.append(max_abs_err(got[:checked], mxu_ops.mont_dot_mxu_plain(
            vals[:checked], coeffs[:checked], qc[:checked])))
        errs.append(max_abs_err(got, fk.mont_dot(vals, coeffs, None, None, None, qc_std, None)))
        run_mxu = lambda: mxu_ops.mont_dot_mxu(vals, coeffs, qc)  # noqa: E731
        run_dot = lambda: fk.mont_dot(vals, coeffs, None, None, None, qc_std, None)  # noqa: E731
        need = mxu_ops.panel_ops(E, T, B)
        t_bytes = need["bytes"] / MEM_BYTES_PER_S * 1e3
        t_ops = (2 * need["u8_macs"] / U8_OPS_PER_S + need["madds"] / INT32_MADDS_PER_S) * 1e3
        dot_b_ms, dot_b_by = bound(32 * E * B * (T + 1) + 32 * E * (T + 1),
                                   T * MADDS_PER_MONT_MUL * E * B)
        row = {"E": E, "T": T, "B": B, "checked_gates_against_plain": checked,
               "ms": time_ms(run_mxu), "ms_queued": time_ms(run_mxu, calls=10),
               "ms_graph": graph_ms(run_mxu),
               "dot_ms": time_ms(run_dot), "dot_ms_queued": time_ms(run_dot, calls=10),
               "dot_ms_graph": graph_ms(run_dot),
               "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_ops_ms": t_ops, "dot_bound_ms": dot_b_ms, "dot_bound_by": dot_b_by}
        if label == "row4_t3":
            row["plain_ms"] = time_ms(lambda: mxu_ops.mont_dot_mxu_plain(vals, coeffs, qc),
                                      reps=3, warmup=1)
        mxu_shapes[label] = row
        del vals, coeffs, qc, qc_std, got
        torch.cuda.empty_cache()
    shared_fn = ctypes.CDLL(str(build.lib_path("dot_mxu"))).acvm_dot_mxu_shared_bytes
    main_row = mxu_shapes["row4_t3"]
    kernels["dot_mxu"] = dict(
        name="dot_mxu", route="cuda", source="acvm_tpu_torch/csrc/dot_mxu.cu",
        replaces="acvm_tpu/fields/mxu_ops.py:157",
        shape="E=2048, T=3, B=2048 (row 4's shape, no scale)", max_abs_err=max(errs),
        edge_cases=len(errs), ms=main_row["ms"], ms_queued=main_row["ms_queued"],
        ms_graph=main_row["ms_graph"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"], library_ms=None,
        library_ms_reason="no PyTorch call computes a modular expression dot; the v2 dot "
                          "(a hand-written kernel) is timed beside it as dot_ms",
        shapes=mxu_shapes, shared_bytes_by_terms={T: shared_fn(T) for T in range(1, 9)})

    # path_dyn_mxu: path_dyn's circuit under dot_kernel="mxu": the flags and
    # the whole panel equal to the v2 solve's; device solves v2, mxu, mxu, v2.
    circuit = build_wide_arith_circuit(num_inputs=128, num_levels=4, gates_per_level=4096,
                                       dyn_fraction=0.5, seed=1234)
    plan = plan_circuit(circuit)
    inputs = random_inputs(circuit, batch)
    v2_solver = BatchSolver(plan)
    res_v2 = v2_solver.solve(inputs)
    solver = BatchSolver(plan, dot_kernel="mxu")
    build.reset_launches()
    res = solver.solve(inputs)
    torch.cuda.synchronize()
    dyn_mxu_launches = dict(build.LAUNCHES)
    assert res.ok.all() and np.array_equal(res.ok, res_v2.ok) and np.array_equal(res.fail, res_v2.fail)
    assert torch.equal(res.panel, res_v2.panel)
    assert dyn_mxu_launches["dot_mxu"] > 0 and dyn_mxu_launches["dot"] > 0, dyn_mxu_launches
    check_instances(circuit, inputs, res, (0, batch - 1))
    mxu_panels = [(tuple(packed["arith_dyn"]["den"]["lin_idx"].shape),
                   tuple(packed["arith_dyn"]["den"]["mul_idx"].shape))
                  for segment in solver.segments for packed in segment.levels
                  if "arith_dyn" in packed["kinds"]]
    gates = len(circuit.opcodes)
    del res, res_v2
    states = {"v2": v2_solver.initial_state(inputs), "mxu": solver.initial_state(inputs)}
    solvers = {"v2": v2_solver, "mxu": solver}
    dyn_secs = {"v2": [], "mxu": []}
    for label in ("v2", "mxu", "mxu", "v2"):
        dyn_secs[label].append(timed_rate(device_solve_of(solvers[label], states[label], torch),
                                          batch * gates, reps=3)[1])
    emit({"path_dyn_mxu": {
        "card": smi, "gates": gates, "batch": batch, "dyn_fraction": 0.5, "dot_kernel": "mxu",
        "ok": True, "equals_v2_panel": True, "checked_instances": [0, batch - 1],
        "launches": dyn_mxu_launches, "den_panels_lin_and_mul_idx": mxu_panels,
        "solve_seconds_by_route": dyn_secs, "order": "v2, mxu, mxu, v2",
        "dyn_solves_per_sec": batch * gates / statistics.median(dyn_secs["mxu"]),
        "dyn_solves_per_sec_v2": batch * gates / statistics.median(dyn_secs["v2"])}})
    del states, solvers, solver, v2_solver
    torch.cuda.empty_cache()

    # path_mesh (a): the 2^16-gate circuit at B = 8,192 over four entries of
    # this card (four 2,048-instance shards) against one solve of the batch:
    # flags, the last witness row, two instances' witness maps a shard.
    circuit = build_wide_arith_circuit(num_inputs=128, num_levels=8, gates_per_level=8192,
                                       seed=1234)
    plan = plan_circuit(circuit)
    mesh_B, shards = 8192, 4
    inputs = random_inputs(circuit, mesh_B)
    last = plan.num_witnesses - 1
    watch = sorted({b for s in range(shards) for b in (s * 2048, s * 2048 + 1)} | {2047, 4095})
    one = BatchSolver(plan)
    t0 = time.perf_counter()
    res = one.solve(inputs)
    one_secs = [time.perf_counter() - t0]
    assert res.ok.all()
    want_ok, want_fail = res.ok.copy(), res.fail.copy()
    want_row = res.witness_ints(last)
    want_cols = {b: res.instance_ints(b) for b in watch}
    check_instances(circuit, inputs, res, (0, mesh_B - 1))
    res.release()
    del res
    mesh = make_mesh([dev] * shards)
    sharded = BatchSolver(plan, mesh=mesh)
    build.reset_launches()
    t0 = time.perf_counter()
    res = sharded.solve(inputs)
    mesh_secs = [time.perf_counter() - t0]
    torch.cuda.synchronize()
    mesh_a_launches = dict(build.LAUNCHES)
    assert len(res.parts) == shards and mesh_a_launches["level"] == 8 * shards, mesh_a_launches
    assert np.array_equal(res.ok, want_ok) and np.array_equal(res.fail, want_fail)
    assert res.witness_ints(last) == want_row
    assert all(res.instance_ints(b) == want_cols[b] for b in watch)
    res.release()
    del res
    for label in ("mesh", "one", "one", "mesh"):
        s = sharded if label == "mesh" else one
        t0 = time.perf_counter()
        r = s.solve(inputs)
        (mesh_secs if label == "mesh" else one_secs).append(time.perf_counter() - t0)
        assert np.array_equal(r.ok, want_ok)
        r.release()
        del r
    torch.cuda.empty_cache()

    # (b) pedersen_msm_sharded: 64 generators x B = 2,048 over four entries,
    # against msm_fixed_tables and, on two instances, the host library's MSM.
    ctx_ec = LimbContext(BN254_FR, dev)
    gens = [host_gk.derive_generator(0, i) for i in range(64)]
    ec._window_table_np.cache_clear()
    t0 = time.perf_counter()
    msm_tables = torch.stack([ec.window_table(g, device=dev) for g in gens])
    tables_seconds = time.perf_counter() - t0
    msm_scalars = card_elements((64, 2048), 700)
    want_xy = ec.pt_to_affine(ctx_ec, ec.msm_fixed_tables(ctx_ec, msm_tables, msm_scalars))
    build.reset_launches()
    got_xy = ec.pedersen_msm_sharded(ctx_ec, msm_tables, msm_scalars, mesh)
    torch.cuda.synchronize()
    mesh_b_launches = dict(build.LAUNCHES)
    assert all(torch.equal(a, b) for a, b in zip(got_xy, want_xy))
    host_scalars = msm_scalars[:, :2].cpu().numpy()
    for b in range(2):
        want_pt = native.grumpkin_msm(gens, fk.limbs32_to_ints(host_scalars[:, b]))
        assert (fk.limbs32_to_ints(got_xy[0][b].cpu().numpy())[0],
                fk.limbs32_to_ints(got_xy[1][b].cpu().numpy())[0]) == want_pt
    msm_ms = {"sharded": time_ms(lambda: ec.pedersen_msm_sharded(ctx_ec, msm_tables, msm_scalars, mesh), reps=3),
              "msm_fixed_tables": time_ms(lambda: ec.pt_to_affine(
                  ctx_ec, ec.msm_fixed_tables(ctx_ec, msm_tables, msm_scalars)), reps=3)}
    del msm_tables, msm_scalars, want_xy, got_xy
    torch.cuda.empty_cache()

    # (c) launch_local: two ranks on this card over gloo, each solving half of
    # B = 4,096 of the same circuit, and a one-rank NCCL group solving all of
    # it, side by side; each rank reads the gathered flags, the last witness
    # row and four instances' witness maps, equal to the one solve's.
    c_B = 4096
    c_watch = [0, 2047, 2048, 4095]

    def digest(obj):
        return hashlib.sha256(json.dumps(obj).encode()).hexdigest()

    want_c = {"ok": int(want_ok[:c_B].sum()), "fail": digest(want_fail[:c_B].tolist()),
              "row": digest(want_row[:c_B]), "cols": {str(b): digest(want_cols[b]) for b in c_watch}}
    worker = MESH_WORKER.format(repo=str(Path(__file__).resolve().parent), batch=c_B,
                                watch=c_watch, last=last)
    with ThreadPoolExecutor(max_workers=2) as pool:
        jobs = {"gloo_2_ranks": pool.submit(launcher.launch_local, 2, ["-c", worker],
                                            platform="cuda", timeout=400),
                "nccl_1_rank": pool.submit(launcher.launch_local, 1, ["-c", worker],
                                           platform="cuda", timeout=400)}
        ranks = {label: [json.loads(r.stdout.strip().splitlines()[-1]) for r in job.result()]
                 for label, job in jobs.items()}
    mesh_c_launches = {}
    for label, lines in ranks.items():
        backend = "gloo" if label.startswith("gloo") else "nccl"
        assert [line["rank"] for line in lines] == list(range(len(lines))), lines
        counts = Counter()
        for line in lines:
            assert line["backend"] == backend and line["world"] == len(lines), line
            assert {k: line[k] for k in want_c} == want_c, (label, line["rank"])
            counts.update(line["launches"])
        assert counts["level"] == 8 * len(lines), (label, counts)
        mesh_c_launches[label] = {name: counts[name] for name in build.KERNELS}
    emit({"path_mesh": {
        "card": smi, "ok": True,
        "a": {"gates": len(circuit.opcodes), "batch": mesh_B, "shards": shards,
              "mesh": [str(d) for d in mesh.devices], "shard_panel_bytes": sharded.panel_bytes(2048),
              "checked_instances": watch, "launches": mesh_a_launches,
              "solve_seconds_sharded": mesh_secs, "solve_seconds_one": one_secs,
              "order": "one, mesh, then mesh, one, one, mesh"},
        "b": {"generators": 64, "batch": 2048, "entries": shards, "launches": mesh_b_launches,
              "tables_seconds": tables_seconds, "ms": msm_ms},
        "c": {"batch": c_B, "ranks": ranks},
        "phase_seconds": time.perf_counter() - last_t0}})
    del one, sharded, inputs, want_cols
    torch.cuda.empty_cache()

    # -- 17. kernels, 18. card, 19. verdict -------------------------------------------
    paths = {"static": static_launches, "dyn": dyn_launches, "dyn_v1": v1_launches,
             **{f"ec_{kind}": counts for kind, counts in ec_launches.items()}, "int": int_launches,
             "sha": sha_launches, "mem": mem_launches, "host": host_launches, "vm": vm_launches,
             "hash": hash_launches, **ecdsa_launches, **api_launches, "dyn_mxu": dyn_mxu_launches,
             "mesh_a": mesh_a_launches, "mesh_b": mesh_b_launches,
             **{f"mesh_c_{label}": counts for label, counts in mesh_c_launches.items()}}
    # Kernels that no path launches since another took their place: inv_wide
    # runs path_ecdsa's inversions where pow_wide did (pow_wide stays
    # mont_pow's wide route and inv_wide's yardstick above), and
    # batch_inv_wide runs only where fold_rows folds the 16,384-instance
    # solve's inversions.  Each is still held to its plain version above.
    off_path = {"pow_wide"} | (set() if folds else {"batch_inv_wide"})
    rows = []
    for name in build.KERNELS:
        row = kernels[name]
        row.update(ptxas[name])
        assert row["max_abs_err"] == 0, (name, row["max_abs_err"])
        for path, counts in paths.items():
            row[f"launches_{path}"] = counts[name]
        row["launches"] = sum(counts[name] for counts in paths.values())
        row["on_path"] = name not in off_path
        assert (row["launches"] > 0) == row["on_path"], (name, row["launches"])
        rows.append(row)
    emit({"kernels": rows})
    if want_profile:
        assert profile_vm["brillig_vm_launches_traced"] == vm_launches["brillig_vm"], (
            "the profiled path_vm solve traced", profile_vm["brillig_vm_launches_traced"],
            "brillig_vm launches of", vm_launches["brillig_vm"])
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def sass_instructions(lib):
    """The instructions of a built kernel library as ``cuobjdump -sass``
    (beside ``nvcc``) prints them, addresses and encodings left out; None
    where the tool cannot read it."""
    from acvm_tpu_torch import build

    tool = Path(build._nvcc()).with_name("cuobjdump")
    done = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True)
    if done.returncode != 0:
        return None
    found = (re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);?\s*/\*", line) for line in done.stdout.splitlines())
    return [m.group(1).strip() for m in found if m]


def ecdsa_chain_counts(u1_limbs, digits, dbl: int, warp: int = 32):
    """The products of ecdsa_mul's chain, from its scalars: ``u1_limbs`` the
    (B, 8) int32 u1, ``digits`` the (B, 65) signed windows of u2, ``dbl`` the
    doubling's products (7, or 8 for a = -3).  A lane's steps: u1 G's 64
    windows (a mixed addition, 11 products, for a nonzero digit after the
    first), the lane's table (2Q and six mixed additions), u2 Q's 64 windows
    (4 doublings once the accumulator is finite; an addition, 16, of a
    nonzero digit's entry to a finite accumulator) and the last addition
    where both parts are finite.  A warp runs a step where any of its lanes
    does, so its chain is the sum over the steps of the most its lanes run
    there (the rare branch inside an addition counted as generic).  Returns
    the products of all lanes, the longest lane's and the longest warp's."""
    import numpy as np

    u = u1_limbs.astype(np.int64) & 0xFFFFFFFF
    nib = ((u[:, :, None] >> (4 * np.arange(8))) & 15).reshape(len(u), 64)
    nz1 = nib != 0
    g1_add = nz1 & ((np.cumsum(nz1, axis=1) - nz1) > 0)
    finite = digits[:, 64] != 0
    doubles, adds = [], []
    for w in range(63, -1, -1):
        doubles.append(finite)
        nz = digits[:, w] != 0
        adds.append(nz & finite)
        finite = finite | nz
    last = nz1.any(axis=1) & finite
    B = len(u)
    table = np.ones((B, 1), dtype=bool)
    flags = np.concatenate([g1_add, table, np.stack(doubles, 1), np.stack(adds, 1), last[:, None]], axis=1)
    per_step = flags * np.asarray([11] * 64 + [dbl + 66] + [4 * dbl] * 64 + [16] * 64 + [16])
    warps = np.concatenate([per_step, np.zeros(((-B) % warp, per_step.shape[1]), per_step.dtype)])
    return {"products": int(per_step.sum()), "longest_lane": int(per_step.sum(axis=1).max()),
            "warp_chain": int(warps.reshape(-1, warp, per_step.shape[1]).max(axis=1).sum(axis=1).max())}


def division_census(brillig, col_of, batch):
    """The operands (a, b) of every UnsignedDiv the instances of one block
    execute, masked to the op's bit size as the kernel divides them: the
    port's sequential VM run instance by instance on the columns ``col_of``
    (witness -> (batch,) ints), its int-op evaluation watched."""
    from acvm_tpu_torch import brillig as br
    from acvm_tpu_torch.acir import Witness, WitnessMap
    from acvm_tpu_torch.blackbox import GrumpkinSolver
    from acvm_tpu_torch.brillig_vm import vm as seq_vm
    from acvm_tpu_torch.fields.field import FieldElement
    from acvm_tpu_torch.pwg.brillig_solver import BrilligSolver
    from acvm_tpu_torch.pwg.errors import OpcodeResolutionError

    seen = []
    evaluate = seq_vm.evaluate_binary_int_op

    def watch(op, a, b, bits):
        assert op != br.BinaryIntOp.SignedDiv, "count a SignedDiv's magnitudes"
        if op == br.BinaryIntOp.UnsignedDiv:
            seen.append((a % (1 << bits), b % (1 << bits)))
        return evaluate(op, a, b, bits)

    seq_vm.evaluate_binary_int_op = watch
    try:
        for i in range(batch):
            wm = WitnessMap({Witness(w): FieldElement(int(v[i])) for w, v in col_of.items()})
            try:
                BrilligSolver.solve(wm, brillig, GrumpkinSolver(), 0)
            except (OpcodeResolutionError, ZeroDivisionError):
                pass  # a trap: the divisions before it count
    finally:
        seq_vm.evaluate_binary_int_op = evaluate
    return seen


def sequential_solve(circuit, assignment, handler):
    """The port's sequential engine (pwg.ACVM) on one instance, answering
    foreign calls with ``handler``: (status, acvm)."""
    from acvm_tpu_torch.acir import Witness, WitnessMap
    from acvm_tpu_torch.blackbox import GrumpkinSolver
    from acvm_tpu_torch.fields.field import FieldElement
    from acvm_tpu_torch.gpu.batch_solver import _decode_foreign_call_result
    from acvm_tpu_torch.pwg import ACVM, ACVMStatus

    wm = WitnessMap({Witness(w): FieldElement(v) for w, v in assignment.items()})
    acvm = ACVM(GrumpkinSolver(), circuit.opcodes, wm)
    while acvm.solve() == ACVMStatus.REQUIRES_FOREIGN_CALL:
        call = acvm.get_pending_foreign_call()
        acvm.resolve_pending_foreign_call(_decode_foreign_call_result(
            handler(call.function, [[v.to_field() for v in group] for group in call.inputs])))
    return acvm.status, acvm


def device_solve_of(solver, state, torch):
    def run():
        solver.run_segments(state)
        torch.cuda.synchronize()
    return run


# One rank of path_mesh (c), run by ``launcher.launch_local`` as ``python -c``:
# the whole batch on every rank, its own slice solved, the gathered result
# read back (each read a collective, the same on every rank) and printed.
MESH_WORKER = """
import hashlib, json, sys, time
sys.path.insert(0, {repo!r})
import torch
from acvm_tpu_torch.parallel import distributed
distributed.initialize_from_env()
import torch.distributed as dist
from acvm_tpu_torch import build
from acvm_tpu_torch.gpu import BatchSolver, plan_circuit
from acvm_tpu_torch.utils import build_wide_arith_circuit, random_inputs

def digest(obj):
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()

circuit = build_wide_arith_circuit(num_inputs=128, num_levels=8, gates_per_level=8192, seed=1234)
solver = BatchSolver(plan_circuit(circuit), mesh=distributed.global_mesh())
inputs = random_inputs(circuit, {batch})
mine = distributed.process_batch_slice({batch})
dist.barrier()
build.reset_launches()
t0 = time.perf_counter()
res = solver.solve(inputs)
seconds = time.perf_counter() - t0
launches = {{k: v for k, v in build.LAUNCHES.items() if v}}
line = {{"rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(),
        "device": str(solver.device), "slice": [mine.start, mine.stop], "solve_seconds": seconds,
        "ok": int(res.ok.sum()), "fail": digest(res.fail.tolist()),
        "row": digest(res.witness_ints({last})),
        "cols": {{str(b): digest(res.instance_ints(b)) for b in {watch}}}, "launches": launches}}
print(json.dumps(line), flush=True)
dist.destroy_process_group()
"""


if __name__ == "__main__":
    sys.exit(main())
