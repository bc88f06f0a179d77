"""The device Brillig VM: a branchy Brillig block run for every instance at once.

Straight-line hint blocks run as traced limb operations
(:mod:`acvm_tpu_torch.gpu.brillig_trace`); a block with jumps, calls, memory,
array inputs or outputs, or ``Trap`` (:func:`device_vm_eligible`) is a host
stage, and the solver's host stage runs it here: its inputs are evaluated on
the host (:func:`host_batch.eval_expr_batch`), loaded into registers and
memory on the device, run to halt by one ``brillig_vm`` launch
(``csrc/brillig_vm.cu``: a thread an instance, each with its own program
counter, a warp a block, the state in shared memory where
:func:`vm_launch_plan` finds room), and read back in one copy.

The counterpart of the JAX package's ``tpu/brillig_vm_device.py``, with its
capacity rules unchanged, so that the same instances escape: at most
:data:`MAX_REGISTERS` registers, :data:`CALL_STACK_DEPTH` open calls, a memory
of ``max(32, 2 * array input words + 32)`` cells and :func:`step_budget`
opcodes an instance.  An instance past one of them *escapes*: the whole block
raises :class:`HostBatchFallback` and the caller reruns it instance by
instance on the sequential VM, so a capacity limit never changes a result.

Semantics are the sequential VM's (``brillig_vm/vm.py``) where the two JAX
routes disagree, as in the port's trace: a 254- or 256-bit int result is
reduced mod p, and ``SignedDiv`` reads an operand at or above 2^bit_size as it
is.  Where only the device VM defines a result, it is the JAX device VM's: an
``UnsignedDiv`` by zero traps the instance, memory never written reads 0, and
``Shl`` / ``Shr`` above 128 bits are computed (ROADMAP queue 3 lists each).

:func:`run_vm` launches the kernel on CUDA tensors and runs
:func:`run_vm_plain`, a SIMD interpreter over the batch in plain PyTorch, on
CPU tensors.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import brillig as br
from .. import build
from ..acir import opcodes as ops
from ..fields.kernels import (
    LIMBS,
    M32,
    _host_ptr,
    field_words,
    half_field,
    int_to_limbs32,
    join_half,
    mont_mul_plain,
    mont_pow_plain,
    pow_schedule_words,
    require_narrow,
    split_half,
    wrap_i32,
)
from ..fields.params import BN254_FR, FieldParams
from . import intops
from .brillig_trace import _bool_to_limbs
from .host_batch import (
    DEVICE_VM_MAX_REGISTERS as MAX_REGISTERS,
    HostBatchFallback,
    GetCol,
    cols_to_limbs,
    device_vm_eligible,
    eval_expr_batch,
    limb_cols_to_object,
)

__all__ = ["MAX_REGISTERS", "CALL_STACK_DEPTH", "device_vm_eligible", "step_budget",
           "program_for", "initial_state", "vm_launch_plan", "vm_plan_for", "run_vm", "run_vm_plain",
           "read_outputs", "run_brillig_vm_batch"]

CALL_STACK_DEPTH = 32

# Opcode kinds (the rows of the instruction table; csrc/brillig_vm.cu uses the
# same numbers).
K_BIN_FIELD, K_BIN_INT, K_JUMP, K_JUMP_IF, K_JUMP_IF_NOT, K_CALL, K_RETURN = range(7)
K_CONST, K_MOV, K_LOAD, K_STORE, K_TRAP, K_STOP = range(7, 13)
# An instance's state after the run.
HALTED, TRAPPED, ESCAPED = 0, 1, 2
_RUNNING = -1  # the plain version's live instances

WORDS = 16  # int32 words an instruction: kind, sub-op, dst, lhs, rhs, loc, bits, 0, constant (8)


def step_budget(n_pc: int) -> int:
    """Opcodes an instance may execute before it escapes (the JAX device VM's
    ``64 n_pc + 1024``).  The JAX loop tests its budget every 4 unrolled steps,
    so it may let an instance run up to 3 steps past a budget that is not a
    multiple of 4 (this one always is); an escape never changes a result, so
    the per-thread budget here does not emulate that."""
    return 64 * n_pc + 1024


class Program:
    """The instruction table of one bytecode: (n_pc, 16) int32, uploaded once
    a device.  Register operands: BinaryFieldOp / BinaryIntOp read lhs and rhs
    into dst; JumpIf / JumpIfNot test lhs; Mov copies lhs; Load reads the
    pointer in lhs; Store writes lhs at the pointer in rhs."""

    def __init__(self, bytecode: List[br.BrilligOpcode], p: int):
        n = len(bytecode)
        self.n_pc = n
        table = np.zeros((n, WORDS), dtype=np.int64)
        table[:, 0] = K_STOP
        self.max_reg = 0
        self.max_bits = 0  # the widest BinaryIntOp

        def reg(x) -> int:
            self.max_reg = max(self.max_reg, int(x))
            return int(x)

        for pc, op in enumerate(bytecode):
            row = table[pc]
            if isinstance(op, (br.OpBinaryFieldOp, br.OpBinaryIntOp)):
                row[0] = K_BIN_FIELD if isinstance(op, br.OpBinaryFieldOp) else K_BIN_INT
                row[1:5] = int(op.op), reg(op.destination), reg(op.lhs), reg(op.rhs)
                if isinstance(op, br.OpBinaryIntOp):
                    row[6] = int(op.bit_size)
                    self.max_bits = max(self.max_bits, int(op.bit_size))
            elif isinstance(op, (br.OpJump, br.OpCall)):
                row[0] = K_JUMP if isinstance(op, br.OpJump) else K_CALL
                row[5] = int(op.location)
            elif isinstance(op, (br.OpJumpIf, br.OpJumpIfNot)):
                row[0] = K_JUMP_IF if isinstance(op, br.OpJumpIf) else K_JUMP_IF_NOT
                row[3], row[5] = reg(op.condition), int(op.location)
            elif isinstance(op, br.OpConst):
                row[0], row[2] = K_CONST, reg(op.destination)
                row[8:] = int_to_limbs32(int(op.value.to_field()) % p)
            elif isinstance(op, br.OpMov):
                row[0], row[2], row[3] = K_MOV, reg(op.destination), reg(op.source)
            elif isinstance(op, br.OpLoad):
                row[0], row[2], row[3] = K_LOAD, reg(op.destination), reg(op.source_pointer)
            elif isinstance(op, br.OpStore):
                row[0], row[3], row[4] = K_STORE, reg(op.source), reg(op.destination_pointer)
            elif isinstance(op, (br.OpReturn, br.OpTrap, br.OpStop)):
                row[0] = {br.OpReturn: K_RETURN, br.OpTrap: K_TRAP, br.OpStop: K_STOP}[type(op)]
            else:  # guarded by device_vm_eligible
                raise TypeError(f"the device VM does not run {type(op).__name__}")
        self.table = table.astype(np.int32)
        self.touches_memory = bool(np.isin(table[:, 0], (K_LOAD, K_STORE)).any())
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = torch.from_numpy(self.table).to(device)
        return self._on[device]


# id(brillig) -> (brillig, Program): one table a bytecode block, as the JAX
# package's _program_for keeps one jitted program a block.  The block is held
# so that its id is not reused while the entry lives.
_PROGRAMS: Dict[int, Tuple[ops.Brillig, Program]] = {}


def program_for(brillig: ops.Brillig, p: int) -> Program:
    entry = _PROGRAMS.get(id(brillig))
    if entry is None or entry[0] is not brillig:
        entry = (brillig, Program(brillig.bytecode, p))
        _PROGRAMS[id(brillig)] = entry
    return entry[1]


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _vm_words(params: FieldParams) -> np.ndarray:
    """[p | R | n0 | R^2 | p's bit length]: what the launcher takes."""
    require_narrow(params, "brillig_vm")
    return np.concatenate([field_words(params), int_to_limbs32(params.r2).view(np.uint32),
                           np.array([params.modulus.bit_length()], dtype=np.uint32)])


# What the H100 gives one block: csrc/brillig_vm.cu keeps the same numbers and
# refuses a plan it would lay out otherwise.
VM_THREADS = 32  # instances a block: one warp
SHARED_BYTES_MAX = 232_448  # shared memory a block may opt in to (227 KB)
TABLE_ON_CHIP_BYTES = 49_152  # an instruction table up to this size is copied on chip


class VmLaunchPlan(NamedTuple):
    threads: int  # a block
    blocks: int
    table_on_chip: bool
    regs_on_chip: bool
    mem_on_chip: bool
    shared_bytes: int  # a block: table, call stacks, and the state on chip


def vm_launch_plan(n_regs: int, mem_cap: int, n_pc: int, B: int) -> VmLaunchPlan:
    """Where ``brillig_vm`` keeps each part of a block's state, by its size
    alone: a block is one warp, so ``B`` instances spread over ``ceil(B / 32)``
    blocks; the instruction table goes on chip up to 48 KB, the call stacks
    always (4 KB), then the registers (1 KB a row: 32 bytes x 32 lanes), the
    most touched, and then the memory, each where it still fits in
    :data:`SHARED_BYTES_MAX`.  What does not fit stays in its ``(rows, 8, B)``
    panel in device memory, and so does a memory of ``mem_cap = 0`` rows (a
    program with no ``Load`` or ``Store``: nothing to copy)."""
    row = LIMBS * 4 * VM_THREADS
    table = n_pc * WORDS * 4
    table_on_chip = 0 < table <= TABLE_ON_CHIP_BYTES
    shared = (table if table_on_chip else 0) + CALL_STACK_DEPTH * 4 * VM_THREADS
    regs_on_chip = shared + n_regs * row <= SHARED_BYTES_MAX
    shared += n_regs * row if regs_on_chip else 0
    mem_on_chip = regs_on_chip and 0 < mem_cap and shared + mem_cap * row <= SHARED_BYTES_MAX
    shared += mem_cap * row if mem_on_chip else 0
    return VmLaunchPlan(VM_THREADS, -(-B // VM_THREADS), table_on_chip, regs_on_chip, mem_on_chip,
                        shared)


def vm_plan_for(program: Program, regs: torch.Tensor, mem: torch.Tensor) -> VmLaunchPlan:
    """The plan :func:`run_vm` launches ``program`` under on this state."""
    mem_cap = mem.shape[0] if program.touches_memory else 0
    return vm_launch_plan(regs.shape[0], mem_cap, program.n_pc, regs.shape[2])


def vm_launch_args(program: Program, regs: torch.Tensor, mem: torch.Tensor, max_steps: int,
                   plan: VmLaunchPlan, params: FieldParams = BN254_FR):
    """``(args, status, steps)``: the C launcher's arguments for one run of
    ``program`` on CUDA tensors under ``plan``, and the (B,) outputs they
    point at."""
    B = regs.shape[2]
    status = torch.empty(B, dtype=torch.int32, device=regs.device)
    steps = torch.empty_like(status)
    args = (program.on(regs.device).data_ptr(), program.n_pc, regs.data_ptr(), mem.data_ptr(),
            status.data_ptr(), steps.data_ptr(), B, regs.shape[0], mem.shape[0], max_steps,
            _host_ptr(_vm_words(params)), _host_ptr(pow_schedule_words(params.modulus - 2)),
            plan.threads, plan.table_on_chip, plan.regs_on_chip, plan.mem_on_chip, plan.shared_bytes,
            torch.cuda.current_stream(regs.device).cuda_stream)
    return args, status, steps


def run_vm(program: Program, regs: torch.Tensor, mem: torch.Tensor, max_steps: int,
           params: FieldParams = BN254_FR) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``program`` from pc 0 for every instance.  ``regs`` (NR, 8, B) and
    ``mem`` (M, 8, B) int32, contiguous, hold the initial registers and memory
    and are updated in place.  Returns ``(status, steps)``, (B,) int32: HALTED,
    TRAPPED or ESCAPED, and the opcodes each instance executed.

    CUDA tensors: one ``brillig_vm`` launch under :func:`vm_plan_for`, or an
    error; CPU tensors: :func:`run_vm_plain`.  Both give the same bits."""
    for t, name in ((regs, "regs"), (mem, "mem")):
        if t.dtype != torch.int32 or t.dim() != 3 or t.shape[1] != LIMBS or not t.is_contiguous():
            raise TypeError(f"run_vm {name}: expected a contiguous (rows, {LIMBS}, B) int32 "
                            f"tensor, got {tuple(t.shape)} {t.dtype}")
    if regs.shape[2] != mem.shape[2] or regs.device != mem.device:
        raise ValueError("run_vm: regs and mem must share the batch and the device")
    if not regs.is_cuda:
        return run_vm_plain(program, regs, mem, max_steps, params)
    args, status, steps = vm_launch_args(program, regs, mem, max_steps,
                                         vm_plan_for(program, regs, mem), params)
    build.launch("brillig_vm", *args)
    return status, steps


def _mask_of(bits: torch.Tensor) -> torch.Tensor:
    """(n,) bit counts -> (n, 8) int32 limbs of 2^bits - 1 (all ones past 256)."""
    keep = (bits[:, None] - 32 * torch.arange(LIMBS, device=bits.device)).clamp(0, 32)
    return wrap_i32(torch.bitwise_left_shift(torch.ones_like(keep), keep) - 1)


def _pow2(bits: torch.Tensor) -> torch.Tensor:
    """(n,) bit positions -> (n, 8) int32 limbs of 2^bits (0 at 256 and above)."""
    one = torch.zeros((bits.shape[0], LIMBS), dtype=torch.int32, device=bits.device)
    one[:, 0] = 1
    return intops.shl_dynamic(one, bits)


def _reduce_full(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x mod p for (n, 8) limbs below 2^256."""
    while True:
        over = ~intops.int_lt(x, p)
        if not bool(over.any()):
            return x
        x = torch.where(over[:, None], intops.int_sub(x, p), x)


def _signed_magnitude(x: torch.Tensor, bits: torch.Tensor, mask: torch.Tensor):
    """(|to_signed(x)|, to_signed(x) < 0) at per-row ``bits``, on the value as
    it is: below 2^(bits-1) itself, at or above 2^bits x - 2^bits, else
    2^bits - x, negative."""
    low = intops.int_lt(x, _pow2(bits - 1))
    top = _pow2(bits)
    high = (bits < 256) & ~intops.int_lt(x, top)
    neg = ~low & ~high
    mag = torch.where(high[:, None], intops.int_sub(x, top),
                      intops.int_sub(torch.zeros_like(x), x) & mask)
    return torch.where(low[:, None], x, mag), neg


def _int_ops(sub, bits, a, b, p_limbs, p_bits):
    """One BinaryIntOp for each row: (result (n, 8), trapped (n,))."""
    n = a.shape[0]
    mask = _mask_of(bits)
    am, bm = a & mask, b & mask
    res = torch.zeros_like(a)
    trap = torch.zeros(n, dtype=torch.bool, device=a.device)
    I = br.BinaryIntOp
    for op in torch.unique(sub).tolist():
        rows = (sub == op).nonzero()[:, 0]
        x, y, xm, ym, k = a[rows], b[rows], am[rows], bm[rows], bits[rows]
        if op == I.Add:
            out = intops.int_add(xm, ym)
        elif op == I.Sub:
            out = intops.int_sub(xm, ym)
        elif op == I.Mul:
            out = intops.int_mul(xm, ym)
        elif op == I.UnsignedDiv:
            trap[rows] = intops.is_zero(ym)
            out = intops.long_divmod_plain(xm, ym, min(int(k.max()), 256))[0]
        elif op == I.SignedDiv:
            ma, neg_a = _signed_magnitude(x, k, mask[rows])
            mb, neg_b = _signed_magnitude(y, k, mask[rows])
            q = intops.long_divmod_plain(ma, mb, 256)[0]
            out = torch.where((neg_a ^ neg_b)[:, None], intops.int_sub(torch.zeros_like(q), q), q)
        elif op in (I.Equals, I.LessThan, I.LessThanEquals):
            flag = (xm == ym).all(dim=1) if op == I.Equals else (
                intops.int_lt(xm, ym) if op == I.LessThan else ~intops.int_lt(ym, xm))
            res[rows] = _bool_to_limbs(flag)  # 0 or 1 at any bit size
            continue
        elif op in (I.And, I.Or, I.Xor):
            out = xm & ym if op == I.And else (xm | ym if op == I.Or else xm ^ ym)
        else:  # Shl, Shr: by the low 32 bits of b; 2^32 or more shifts everything out
            s = y[:, 0].to(torch.int64) & M32
            s = torch.where((y[:, 1:] != 0).any(dim=1), M32, s)
            if op == I.Shl:
                out = intops.shl_dynamic(xm, torch.minimum(s, k.clamp(max=256)))
            else:
                out = intops.shr_dynamic(x, s.clamp(max=256))
        out = out & mask[rows]
        wide = k >= p_bits
        if bool(wide.any()):
            out[wide] = _reduce_full(out[wide], p_limbs)
        res[rows] = out
    return res, trap


def _field_ops(sub, a, b, params, r2):
    """One BinaryFieldOp for each row (canonical operands)."""
    hf = half_field(params, a.device)
    res = torch.zeros_like(a)
    F = br.BinaryFieldOp
    for op in torch.unique(sub).tolist():
        rows = (sub == op).nonzero()[:, 0]
        x, y = a[rows], b[rows]
        if op == F.Add:
            res[rows] = join_half(hf.add(split_half(x), split_half(y)))
        elif op == F.Sub:
            res[rows] = join_half(hf.sub(split_half(x), split_half(y)))
        elif op == F.Mul:
            res[rows] = mont_mul_plain(mont_mul_plain(x, y, params), r2, params)
        elif op == F.Div:
            inv = mont_pow_plain(mont_mul_plain(y, r2, params), params.modulus - 2, params)
            res[rows] = mont_mul_plain(x, inv, params)
        else:
            res[rows] = _bool_to_limbs((x == y).all(dim=1))
    return res


def run_vm_plain(program: Program, regs: torch.Tensor, mem: torch.Tensor, max_steps: int,
                 params: FieldParams = BN254_FR, pc_counts: Optional[torch.Tensor] = None):
    """Plain version of :func:`run_vm`: the JAX device VM's design, a SIMD
    interpreter over the batch.  Each step fetches every live instance's
    opcode and runs each opcode kind (and sub-op) that some live instance is
    at over those instances, registers ``(B, NR, 8)``; int ops over 16-bit
    half-limbs (:mod:`.intops`), field ops over the plain field versions.

    ``pc_counts`` (optional, (n_pc,) int64 on the device of ``regs``) gains
    one at each executed opcode's pc."""
    dev = regs.device
    B = regs.shape[2]
    R = regs.permute(2, 0, 1).contiguous()  # (B, NR, 8)
    Mm = mem.permute(2, 0, 1).contiguous()  # (B, M, 8)
    mem_cap = Mm.shape[1]
    table = program.on(dev).to(torch.int64)
    r2 = torch.from_numpy(int_to_limbs32(params.r2).copy()).to(dev)
    p_limbs = torch.from_numpy(int_to_limbs32(params.modulus).copy()).to(dev)
    p_bits = params.modulus.bit_length()
    pc = torch.zeros(B, dtype=torch.int64, device=dev)
    sp = torch.zeros_like(pc)
    stack = torch.zeros((B, CALL_STACK_DEPTH), dtype=torch.int64, device=dev)
    state = torch.full((B,), _RUNNING, dtype=torch.int64, device=dev)
    steps = torch.zeros_like(pc)
    step = 0
    while True:
        state[(state == _RUNNING) & (pc >= program.n_pc)] = HALTED
        live = (state == _RUNNING).nonzero()[:, 0]
        if live.numel() == 0:
            break
        if step >= max_steps:
            state[live] = ESCAPED
            break
        step += 1
        steps[live] += 1
        if pc_counts is not None:
            pc_counts.index_add_(0, pc[live], torch.ones_like(live))
        ins = table[pc[live]]  # (n, 16)
        kind = ins[:, 0]
        nxt = pc[live] + 1
        for k in torch.unique(kind).tolist():
            sel = (kind == k).nonzero()[:, 0]
            lanes, op = live[sel], ins[sel]
            a = R[lanes, op[:, 3]]
            if k in (K_BIN_FIELD, K_BIN_INT):
                b = R[lanes, op[:, 4]]
                if k == K_BIN_FIELD:
                    R[lanes, op[:, 2]] = _field_ops(op[:, 1], a, b, params, r2)
                    continue
                res, trap = _int_ops(op[:, 1], op[:, 6], a, b, p_limbs, p_bits)
                state[lanes[trap]] = TRAPPED
                keep = ~trap
                R[lanes[keep], op[keep, 2]] = res[keep]
            elif k == K_JUMP:
                nxt[sel] = op[:, 5]
            elif k in (K_JUMP_IF, K_JUMP_IF_NOT):
                zero = (a == 0).all(dim=1)
                take = ~zero if k == K_JUMP_IF else zero
                nxt[sel] = torch.where(take, op[:, 5], nxt[sel])
            elif k == K_CALL:
                full = sp[lanes] >= CALL_STACK_DEPTH
                state[lanes[full]] = ESCAPED
                ok = lanes[~full]
                stack[ok, sp[ok]] = pc[ok]
                sp[ok] += 1
                nxt[sel] = op[:, 5]
            elif k == K_RETURN:
                empty = sp[lanes] == 0
                state[lanes[empty]] = TRAPPED
                ok = lanes[~empty]
                sp[ok] -= 1
                back = torch.zeros_like(lanes)
                back[~empty] = stack[ok, sp[ok]] + 1
                nxt[sel] = back
            elif k == K_CONST:
                R[lanes, op[:, 2]] = op[:, 8:].to(torch.int32)
            elif k == K_MOV:
                R[lanes, op[:, 2]] = a
            elif k in (K_LOAD, K_STORE):
                ptr_reg = a if k == K_LOAD else R[lanes, op[:, 4]]
                ptr = ptr_reg[:, 0].to(torch.int64) & M32
                bad = (ptr_reg[:, 1:] != 0).any(dim=1) | (ptr >= mem_cap)
                state[lanes[bad]] = ESCAPED
                ok, ptr = lanes[~bad], ptr[~bad]
                if k == K_LOAD:
                    R[ok, op[~bad, 2]] = Mm[ok, ptr]
                else:
                    Mm[ok, ptr] = R[ok, op[~bad, 3]]
            elif k == K_TRAP:
                state[lanes] = TRAPPED
            else:  # K_STOP
                state[lanes] = HALTED
        running = state[live] == _RUNNING
        pc[live[running]] = nxt[running]
    regs.copy_(R.permute(1, 2, 0))
    mem.copy_(Mm.permute(1, 2, 0))
    return state.to(torch.int32), steps.to(torch.int32)


# ---------------------------------------------------------------------------
# A block over the batch
# ---------------------------------------------------------------------------


def initial_state(brillig: ops.Brillig, get_col: GetCol, batch: int, p: int, device="cuda"):
    """``(program, regs, mem)`` of a block before its run, as
    ``BrilligSolver.solve`` loads them: single inputs in registers 0..n-1,
    array inputs flattened into memory from 0 upward with the input's
    register holding the base pointer; ``regs`` (NR, 8, B) and ``mem``
    (mem_cap, 8, B) int32 on ``device``.  Raises :class:`HostBatchFallback`
    where the register file passes :data:`MAX_REGISTERS`."""
    program = program_for(brillig, p)
    input_cols: List[np.ndarray] = []
    mem_cols: List[np.ndarray] = []
    for inp in brillig.inputs:
        if isinstance(inp, ops.BrilligInputSingle):
            input_cols.append(eval_expr_batch(inp.expr, get_col, batch, p))
        elif isinstance(inp, ops.BrilligInputArray):
            input_cols.append(np.full(batch, len(mem_cols), dtype=object))
            mem_cols.extend(eval_expr_batch(e, get_col, batch, p) for e in inp.exprs)
        else:  # pragma: no cover
            raise HostBatchFallback(f"unknown input {inp!r}")
    n_regs = max(program.max_reg + 1, len(input_cols), len(brillig.outputs), 1)
    if n_regs > MAX_REGISTERS:
        raise HostBatchFallback("the register file exceeds the device bound")
    dev = torch.device(device)
    regs = torch.zeros((n_regs, LIMBS, batch), dtype=torch.int32, device=dev)
    mem = torch.zeros((max(32, 2 * len(mem_cols) + 32), LIMBS, batch), dtype=torch.int32,
                      device=dev)
    for panel, cols in ((regs, input_cols), (mem, mem_cols)):
        if cols:
            limbs = np.ascontiguousarray(cols_to_limbs(cols, p).transpose(0, 2, 1))
            panel[: len(cols)] = torch.from_numpy(limbs).to(dev)
    return program, regs, mem


def run_brillig_vm_batch(
    brillig: ops.Brillig,
    get_col: GetCol,
    batch: int,
    p: int,
    device="cuda",
    max_steps: Optional[int] = None,
) -> Tuple[Dict[int, np.ndarray], np.ndarray]:
    """Run a device-VM-eligible Brillig block for every instance.

    Returns ``({witness: (B,) object ints}, trapped)``, ``trapped`` a (B,)
    bool mask of the instances that fail at the block (a Trap, a Return on an
    empty stack, an UnsignedDiv by zero) where the predicate holds; their
    outputs are 0.  Mirrors ``BrilligSolver.solve``: a predicate of 0 on every
    instance writes zeros and runs nothing, else the outputs are multiplied by
    it; the inputs are loaded by :func:`initial_state`, the block runs by
    :func:`run_vm` and its outputs are read back by :func:`read_outputs`.

    Raises :class:`HostBatchFallback` (the caller reruns the block instance by
    instance) for a field other than BN254, an int op wider than 256 bits, a
    register file past :data:`MAX_REGISTERS`, and any capacity escape.
    ``max_steps`` overrides :func:`step_budget` (tests)."""
    if p != BN254_FR.modulus:
        raise HostBatchFallback("the device VM runs the default field only")
    if program_for(brillig, p).max_bits > 256:
        raise HostBatchFallback("an int op wider than 256 bits")
    pred = None
    if brillig.predicate is not None:
        pred = eval_expr_batch(brillig.predicate, get_col, batch, p)
        if not any(pred):
            zero = np.zeros(batch, dtype=object)
            return ({int(w): zero.copy() for out in brillig.outputs for w in _output_witnesses(out)},
                    np.zeros(batch, dtype=bool))
    program, regs, mem = initial_state(brillig, get_col, batch, p, device)
    if max_steps is None:
        max_steps = step_budget(program.n_pc)
    status, _ = run_vm(program, regs, mem, max_steps)
    return read_outputs(brillig, regs, mem, status, pred)


def read_outputs(brillig: ops.Brillig, regs: torch.Tensor, mem: torch.Tensor,
                 status: torch.Tensor, pred: Optional[np.ndarray] = None):
    """The outputs of a block after :func:`run_vm`, as
    :func:`run_brillig_vm_batch` returns them: output i is register i, or
    ``len`` words of memory from the pointer in register i; ``pred`` the
    predicate's (B,) values, if the block has one.  Raises
    :class:`HostBatchFallback` where an instance escaped or an array output
    lies past the memory cap."""
    outputs = brillig.outputs
    batch, dev, mem_cap = regs.shape[2], regs.device, mem.shape[0]
    # One copy back: the status, each output's pointer check, the output
    # registers and, for an array output, its words gathered on the device.
    parts = [status, torch.zeros_like(status), regs[: len(outputs)].reshape(-1)]
    for i, out in enumerate(outputs):
        if isinstance(out, ops.BrilligOutputArray):
            base = regs[i, 0].to(torch.int64) & M32
            beyond = (regs[i, 1:] != 0).any(dim=0) | (base + len(out.witnesses) > mem_cap)
            parts[1] = parts[1] | beyond.to(torch.int32)
            rows = (base[None] + torch.arange(len(out.witnesses), device=dev)[:, None]).clamp(max=mem_cap - 1)
            parts.append(mem.gather(0, rows[:, None, :].expand(-1, LIMBS, -1)).reshape(-1))
        elif not isinstance(out, ops.BrilligOutputSimple):  # pragma: no cover
            raise HostBatchFallback(f"unknown output {out!r}")
    host = torch.cat(parts).cpu().numpy()
    status_np, beyond_np = host[:batch], host[batch : 2 * batch]
    if (status_np == ESCAPED).any():
        raise HostBatchFallback("device VM capacity escape (memory, call stack or step budget)")
    if beyond_np.any():
        raise HostBatchFallback("an array output beyond the memory cap")
    off = 2 * batch
    out_regs = host[off : off + len(outputs) * LIMBS * batch].reshape(len(outputs), LIMBS, batch)
    off += out_regs.size
    trapped = status_np == TRAPPED
    keep = None
    if pred is not None or trapped.any():
        keep = ~trapped if pred is None else ~trapped & np.array([bool(v) for v in pred])
        keep = keep.astype(object)
    values: Dict[int, np.ndarray] = {}
    for i, out in enumerate(outputs):
        if isinstance(out, ops.BrilligOutputSimple):
            cols = out_regs[i : i + 1]
        else:
            n = len(out.witnesses)
            cols = host[off : off + n * LIMBS * batch].reshape(n, LIMBS, batch)
            off += cols.size
        ints = limb_cols_to_object(np.ascontiguousarray(cols.transpose(0, 2, 1)))
        for j, w in enumerate(_output_witnesses(out)):
            values[int(w)] = ints[:, j] if keep is None else ints[:, j] * keep
    if pred is not None:
        trapped = trapped & np.array([bool(v) for v in pred])
    return values, trapped


def _output_witnesses(out) -> list:
    return [out.witness] if isinstance(out, ops.BrilligOutputSimple) else list(out.witnesses)
