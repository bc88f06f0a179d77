"""Batched Brillig execution for straight-line bytecode.

The Brillig VM is a sequential interpreter; the hint blocks the stdlib emits
(uint arithmetic helpers: one Const or a few BinaryIntOps, reference
stdlib/src/blackbox_fallbacks/uint.rs:43-92,213-264) are straight-line
register programs with no data-dependent control flow.  Those run here over
limb tensors of any leading shape, ``(G, B, 8)`` for G blocks of one bytecode
over B instances.

The register file is resolved once, on the host (:func:`resolve_brillig`):
``Const`` and ``Mov`` only rename values, so what is left is a list of binary
operations on input values, earlier results and constant limb rows, each
made on the device at packing time.  :func:`trace_brillig` then only launches
the operations.

Semantics are the VM's (``brillig_vm/src/arithmetic.rs``): an int op reads
each register as the integer of its field value, computes mod 2^bit_size and
stores the result as a field element, so a result at or above p (possible
where 2^bit_size > p) is reduced mod p; ``SignedDiv`` takes the two's
complement of the register value as it is, truncates toward zero, and gives
0 for a zero divisor; ``Shr`` shifts the register value before the mask.
``UnsignedDiv`` by zero gives 0 (the VM raises there).  Bytecode with jumps,
calls, memory or foreign calls is planned as a host stage instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import torch

from .. import brillig as br
from ..fields.kernels import LIMBS, int_to_limbs32
from ..fields.torch_ops import LimbContext
from . import intops


class BrilligTraceError(Exception):
    pass


@dataclass(frozen=True)
class _Const:
    """A register holding the same field value in every instance."""

    value: int


# A resolved operand: the index of a traced value (the inputs first, then the
# steps' results in order) or a constant (8,) limb row on the device.
Operand = Union[int, torch.Tensor]


@dataclass
class Step:
    op: Union[br.BinaryFieldOp, br.BinaryIntOp]
    bit_size: Optional[int]  # None: a field op
    lhs: Operand
    rhs: Operand
    rhs_const: Optional[int]  # the right operand as a host int, where it is constant
    # Limb rows an int op reads, made at packing time: 2^bit_size - 1, and for
    # SignedDiv 2^(bit_size-1) and 2^bit_size (None at 256 bits).
    mask: Optional[torch.Tensor] = None
    half: Optional[torch.Tensor] = None
    modulus: Optional[torch.Tensor] = None


@dataclass
class BrilligProgram:
    steps: List[Step]
    outputs: List[Operand]  # the values of the output registers


def resolve_brillig(
    ctx: LimbContext, bytecode, num_inputs: int, output_registers
) -> BrilligProgram:
    """Resolve straight-line bytecode into steps over traced values.

    Inputs are loaded into registers 0..num_inputs-1 (Registers::load); an
    unset register reads 0; execution ends at the first ``Stop`` or at the
    end of the bytecode.  The program's outputs are the values of
    ``output_registers`` at the end (output i of a block is register i,
    pwg/brillig.rs)."""
    p = ctx.params.modulus
    regs: Dict[int, Union[int, _Const]] = {i: i for i in range(num_inputs)}
    steps: List[Step] = []
    rows: Dict[int, torch.Tensor] = {}

    def row(value: int) -> torch.Tensor:
        if value not in rows:
            rows[value] = torch.from_numpy(int_to_limbs32(value).copy()).to(ctx.device)
        return rows[value]

    def operand(reg) -> Operand:
        v = regs.get(int(reg), _Const(0))
        return v if isinstance(v, int) else row(v.value)

    for pc, op in enumerate(bytecode):
        if isinstance(op, br.OpStop):
            break
        if isinstance(op, br.OpConst):
            regs[int(op.destination)] = _Const(int(op.value.inner) % p)
        elif isinstance(op, br.OpMov):
            regs[int(op.destination)] = regs.get(int(op.source), _Const(0))
        elif isinstance(op, (br.OpBinaryFieldOp, br.OpBinaryIntOp)):
            bit_size = None
            if isinstance(op, br.OpBinaryIntOp):
                bit_size = op.bit_size
                if bit_size > 256:
                    raise BrilligTraceError(
                        f"BinaryIntOp at {bit_size} bits (pc {pc}): integers wider "
                        "than the 256-bit limbs are not traced"
                    )
            rhs = regs.get(int(op.rhs), _Const(0))
            if op.op in (br.BinaryIntOp.Shl, br.BinaryIntOp.Shr) and bit_size is not None \
                    and not isinstance(rhs, _Const):
                raise BrilligTraceError(
                    f"shift by a register value (pc {pc}): dynamic shift amounts "
                    "take the host VM path"
                )
            step = Step(op.op, bit_size, operand(op.lhs), operand(op.rhs),
                        rhs.value if isinstance(rhs, _Const) else None)
            if bit_size is not None:
                step.mask = row((1 << bit_size) - 1)
                if op.op == br.BinaryIntOp.SignedDiv:
                    step.half = row(1 << (bit_size - 1))
                    step.modulus = row(1 << bit_size) if bit_size < 256 else None
            steps.append(step)
            regs[int(op.destination)] = num_inputs + len(steps) - 1
        else:
            raise BrilligTraceError(
                f"opcode {type(op).__name__} at pc {pc} is not traceable; "
                "it takes the host VM path"
            )
    return BrilligProgram(steps, [operand(r) for r in output_registers])


def trace_brillig(
    ctx: LimbContext, program: BrilligProgram, inputs: List[torch.Tensor]
) -> List[torch.Tensor]:
    """Run a resolved program over ``inputs`` (one ``(..., 8)`` limb tensor a
    register, canonical field values).  Returns the output registers; a
    constant output is its (8,) row, which broadcasts."""
    values = list(inputs)
    for s in program.steps:
        a = values[s.lhs] if isinstance(s.lhs, int) else s.lhs
        b = values[s.rhs] if isinstance(s.rhs, int) else s.rhs
        if s.bit_size is None:
            values.append(_field_binary(ctx, s.op, a, b))
        else:
            values.append(_int_binary(ctx, s, a, b))
    return [values[o] if isinstance(o, int) else o for o in program.outputs]


def _field_binary(ctx: LimbContext, op: br.BinaryFieldOp, a, b):
    if op == br.BinaryFieldOp.Add:
        return ctx.add(a, b)
    if op == br.BinaryFieldOp.Sub:
        return ctx.sub(a, b)
    if op == br.BinaryFieldOp.Mul:
        return ctx.mont_mul(ctx.to_mont(a), b)
    if op == br.BinaryFieldOp.Div:
        # a / b in standard form: (aR) * (b^-1 R) * R^-1 = a b^-1 R, then strip R.
        num_m = ctx.to_mont(a)
        inv_m = ctx.mont_inv_grouped(ctx.to_mont(b))
        return ctx.from_mont(ctx.mont_mul(num_m, inv_m))
    if op == br.BinaryFieldOp.Equals:
        return _bool_to_limbs(ctx.eq(a, b))
    raise BrilligTraceError(f"unsupported field op {op}")


def _bool_to_limbs(flag: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(flag.shape + (LIMBS,), dtype=torch.int32, device=flag.device)
    out[..., 0] = flag.to(torch.int32)
    return out


def _int_binary(ctx: LimbContext, step: Step, a, b):
    """One int op on canonical field values (arithmetic.rs:23-99)."""
    op, bit_size = step.op, step.bit_size
    m = lambda x: x & step.mask  # noqa: E731  (x mod 2^bit_size)
    if op == br.BinaryIntOp.Equals:
        return _bool_to_limbs((m(a) == m(b)).all(dim=-1))
    if op == br.BinaryIntOp.LessThan:
        return _bool_to_limbs(intops.int_lt(m(a), m(b)))
    if op == br.BinaryIntOp.LessThanEquals:
        return _bool_to_limbs(~intops.int_lt(m(b), m(a)))
    if op == br.BinaryIntOp.UnsignedDiv:
        return intops.long_divmod(m(a), m(b), num_bits=bit_size)[0]
    if op == br.BinaryIntOp.And:
        return m(a) & m(b)
    if op == br.BinaryIntOp.Shr:
        # The register value is shifted before the mask (arithmetic.rs:75-79
        # applies the modulo to the shifted result).
        return m(intops.shr_static(a, step.rhs_const))
    if op == br.BinaryIntOp.Add:
        out = m(intops.int_add(a, b))
    elif op == br.BinaryIntOp.Sub:
        out = m(intops.int_sub(a, b))
    elif op == br.BinaryIntOp.Mul:
        out = m(intops.int_mul(a, b))
    elif op == br.BinaryIntOp.Shl:
        out = m(intops.shl_static(a, step.rhs_const))
    elif op == br.BinaryIntOp.Or:
        out = m(a | b)
    elif op == br.BinaryIntOp.Xor:
        out = m(a ^ b)
    elif op == br.BinaryIntOp.SignedDiv:
        out = _signed_div(ctx, step, a, b)
    else:
        raise BrilligTraceError(f"unsupported int op {op}")
    if 1 << bit_size > ctx.params.modulus:
        # The result lands in a field register: at or above p it is reduced.
        out = intops.long_divmod(out, ctx.p_limbs, num_bits=256)[1]
    return out


def _signed_div(ctx: LimbContext, step: Step, a, b):
    """to_unsigned(to_signed(a) / to_signed(b)) with truncation toward zero
    and 0 for b = 0.  ``to_signed`` reads the register value as it is: below
    2^(bit_size-1) it is itself, else itself minus 2^bit_size (so a value at
    or above 2^bit_size stays positive)."""
    m = lambda x: x & step.mask  # noqa: E731

    def magnitude(x):
        """(|to_signed(x)|, to_signed(x) < 0)."""
        low = intops.int_lt(x, step.half)
        mag = m(intops.int_sub(torch.zeros_like(x), x))  # 2^bit_size - x
        if step.modulus is None:
            neg = ~low
        else:
            high = ~intops.int_lt(x, step.modulus)
            neg = ~low & ~high
            mag = torch.where(high[..., None], intops.int_sub(x, step.modulus), mag)
        return torch.where(low[..., None], x, mag), neg

    a, b = torch.broadcast_tensors(a, b)
    abs_a, neg_a = magnitude(a)
    abs_b, neg_b = magnitude(b)
    # |to_signed(x)| is at most 2^(bit_size-1), or below p.
    num_bits = min(max(step.bit_size, ctx.params.modulus.bit_length()), 256)
    q, _ = intops.long_divmod(abs_a, abs_b, num_bits=num_bits)
    return torch.where((neg_a ^ neg_b)[..., None], m(intops.int_sub(torch.zeros_like(q), q)), m(q))
