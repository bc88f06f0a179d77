// The Brillig VM over a batch: every instance runs a block's bytecode from
// pc 0 until it stops, traps or escapes.
//
// Replaces the JAX package's `tpu/brillig_vm_device.py::_run_vm`, a
// `lax.while_loop` of SIMD steps: each step gathers every instance's
// instruction, evaluates every opcode kind the bytecode holds over the whole
// batch and selects per instance, until no instance is live.  On a card that
// is hundreds of small vector operations a step; here it is one launch a
// block run.  A thread is an instance, with its own program counter: it loops
// fetch -> execute -> write back -> next pc with no batch-wide step, so an
// instance that halts early is done and one with a long loop runs on.
//
// State.  A block is one warp of 32 instances.  Its shared memory holds the
// instruction table (16 words an opcode, `Program` in
// `gpu/brillig_vm_device.py`; read from device memory through the read-only
// cache when it is larger than 48 KB), the 32 lanes' call stacks (32 ints
// each), and, where they fit in the 227 KB a block may have, the registers
// and then the memory, copied in from the (rows, 8, B) panels at the start and
// written back whole at the end.  On chip the layout is [row][limb][lane], so
// a warp reading one row touches 32 consecutive words, one a bank; state that
// does not fit stays in its panel, read and written there (a warp's 32 lanes
// on 32 consecutive words too).  `vm_launch_plan` chooses, by the state's
// size alone: the two tiers are this kernel's own code paths.  Values are
// canonical integers below p, not Montgomery form.
//
// Semantics (held to the JAX device VM and the sequential VM by
// tests/test_torch_brillig_vm.py):
// * field ops: Add and Sub mod p; Mul as two Montgomery products (a b R^-1,
//   then times R^2); Div as a times the inverse of b from `pow.cuh`'s chain for
//   p - 2 (0^-1 = 0); Equals.
// * int ops at bit_size <= 256 on operands masked to bit_size: Add, Sub, Mul
//   (low 256 bits), UnsignedDiv (word-level long division, `divmod.cuh`; a
//   zero divisor traps), SignedDiv (on the register values as they are, as
//   the sequential VM reads them: a value at or above 2^bit_size stays
//   positive; 0 for a zero divisor), Equals, LessThan, LessThanEquals, And,
//   Or, Xor; Shl of the masked value and Shr of the register value, by the low
//   32 bits of b (a b of 2^32 or more shifts everything out), at any bit size.
//   A result at a bit size where 2^bit_size > p is reduced mod p (the VM
//   stores it as a field element).
// * control: Jump, JumpIf, JumpIfNot, Call (an escape when 32 calls are
//   open), Return (a trap on an empty stack), Trap, Stop; a pc at or past the
//   end halts.
// * data: Const, Mov, Load and Store; a pointer of 2^32 or more, or at or past
//   mem_cap, escapes.  Memory never written reads 0.
// * the step budget: an instance still running after max_steps opcodes
//   escapes.  An escape is a capacity limit, not a result: the caller reruns
//   the block instance by instance.
//
// Bound.  The bytes are the state the instances touch, read and written once,
// the operations those of the opcodes they execute (136 multiply-adds a
// Montgomery product, 313 products a field Div, a few dozen for an int op,
// one for control flow).  On path_vm's sort block (8,192 instances) that is
// 0.0041 ms (bytes) and 0.0030 ms (operations); but each instance is a chain
// of dependent steps (fetch, decode, operands, op, write-back, next pc), and
// the slowest one takes 1,656: at one warp a scheduler nothing hides a step's
// latency, so the kernel is bound by the slowest warp's rounds times a
// round's latency.  What each part of the design does about it (chip_smoke.py
// --vm-variants, NVIDIA H100 80GB HBM3 at 700 W, ms queued on the sort block,
// one launch on the others; the earlier design, a thread an instance in
// blocks of 128 with its state in device memory, 2.17 in the same call):
// * one warp a block: 256 blocks over the 132 SMs, not 64.  Alone (state in
//   device memory, no regrouping, 256-bit int ops) it moves nothing: 2.15,
//   the warps were never short of SMs.
// * int ops at 64 bits or fewer on the two low limbs: the generic 256-bit op
//   was most of a step's instructions.  2.15 -> 1.20.
// * state on chip (shared memory, [row][limb][lane], one bank a lane):
//   1.20 -> 0.98.  A step waits on shared memory, not L2.
// * regrouping (VM_REGROUP): each round only the lanes with the warp's lowest
//   key step, the key being backward jumps taken, then pc, so lanes split by
//   an if / else meet again at the loop head: 0.61 (keyed by pc alone it was
//   0.82, and the isqrt block, whose else-branch lanes then wait for the
//   loop's end, 0.084 -> 0.28).  Regrouped, the isqrt takes 0.11 (the
//   reduction costs a converged warp each round), the inverse is unchanged
//   (0.18, its 313-product chain ~0.14 at 0.45 us a product).
#include <atomic>

#include "divmod.cuh"
#include "pow.cuh"

#define VM_WORDS 16          // words an instruction
#define VM_CALL_DEPTH 32     // CALL_STACK_DEPTH of the JAX device VM
#define VM_SHARED_LIMIT 232448       // the H100's shared memory a block, opted in above 48 KB
#define VM_TABLE_ON_CHIP_BYTES 49152  // an instruction table up to this size goes to shared memory
#define VM_MAX_DEVICES 64             // devices a process may launch the kernel on
#define VM_THREADS 32  // one warp: the regrouping's __reduce_min_sync covers the block
#ifndef VM_REGROUP
#define VM_REGROUP 1  // 1: a warp's lanes step by (backward jumps, pc); 0: every running lane each round
#endif

// Opcode kinds and status codes: gpu/brillig_vm_device.py keeps the same numbers.
#define K_BIN_FIELD 0
#define K_BIN_INT 1
#define K_JUMP 2
#define K_JUMP_IF 3
#define K_JUMP_IF_NOT 4
#define K_CALL 5
#define K_RETURN 6
#define K_CONST 7
#define K_MOV 8
#define K_LOAD 9
#define K_STORE 10
#define K_TRAP 11
#define K_STOP 12

#define VM_HALTED 0
#define VM_TRAPPED 1
#define VM_ESCAPED 2

// Sub-ops: the values of brillig.BinaryFieldOp and brillig.BinaryIntOp.
enum { F_ADD, F_SUB, F_MUL, F_DIV, F_EQ };
enum { I_ADD, I_SUB, I_MUL, I_SDIV, I_UDIV, I_EQ, I_LT, I_LTE, I_AND, I_OR, I_XOR, I_SHL, I_SHR };

struct VmField {
    Field f;
    uint32_t r2[ACVM_LIMBS];  // R^2 mod p
    int p_bits;               // an int result at this many bits or more is reduced mod p
};

__device__ __forceinline__ void set_word(uint32_t x[ACVM_LIMBS], uint32_t w) {
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) x[j] = j ? 0u : w;
}

// x mod 2^bits.
__device__ __forceinline__ void mask_bits(uint32_t x[ACVM_LIMBS], int bits) {
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) {
        const int keep = bits - 32 * j;
        x[j] = keep >= 32 ? x[j] : (keep <= 0 ? 0u : x[j] & ((1u << keep) - 1u));
    }
}

// No bit of x at position k or above.
__device__ __forceinline__ bool below_pow2(const uint32_t x[ACVM_LIMBS], int k) {
    uint32_t high = 0;
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) {
        const int from = k - 32 * j;  // the first bit of limb j at or above k
        high |= from <= 0 ? x[j] : (from >= 32 ? 0u : x[j] >> from);
    }
    return high == 0;
}

__device__ __forceinline__ bool less_than(const uint32_t a[ACVM_LIMBS], const uint32_t b[ACVM_LIMBS]) {
    uint32_t d[ACVM_LIMBS];
    return sub_limbs(d, a, b) != 0;
}

__device__ __forceinline__ bool equal(const uint32_t a[ACVM_LIMBS], const uint32_t b[ACVM_LIMBS]) {
    uint32_t diff = 0;
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) diff |= a[j] ^ b[j];
    return diff == 0;
}

// The low 256 bits of a * b.
__device__ __forceinline__ void mul_low(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                        const uint32_t b[ACVM_LIMBS]) {
    uint32_t acc[ACVM_LIMBS] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        uint32_t carry = 0;
#pragma unroll
        for (int j = 0; i + j < ACVM_LIMBS; ++j) {
            const uint64_t t = (uint64_t)a[i] * b[j] + acc[i + j] + carry;
            acc[i + j] = (uint32_t)t;
            carry = (uint32_t)(t >> 32);
        }
    }
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) r[j] = acc[j];
}

// (a << s) mod 2^256 and a >> s for 0 <= s <= 256.
__device__ __forceinline__ void shift_left(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS], int s) {
    const int words = s >> 5, bits = s & 31;
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) {
        const int k = j - words;  // the limb of a that lands on limb j
        const uint32_t hi = k >= 0 && k < ACVM_LIMBS ? a[k] : 0u;
        const uint32_t lo = k >= 1 && k <= ACVM_LIMBS ? a[k - 1] : 0u;
        r[j] = __funnelshift_l(lo, hi, bits);
    }
}

__device__ __forceinline__ void shift_right(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS], int s) {
    const int words = s >> 5, bits = s & 31;
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) {
        const int k = j + words;
        const uint32_t lo = k < ACVM_LIMBS ? a[k] : 0u;
        const uint32_t hi = k + 1 < ACVM_LIMBS ? a[k + 1] : 0u;
        r[j] = __funnelshift_r(lo, hi, bits);
    }
}

// x mod p for any x < 2^256 (at most 5 subtractions for BN254).
__device__ __forceinline__ void reduce_full(uint32_t x[ACVM_LIMBS], const Field& f) {
#pragma unroll 1
    while (!less_than(x, f.p)) sub_limbs(x, x, f.p);
}

// q = a / b for b != 0: Algorithm D of `divmod.cuh`, as `divmod.cu` drives it.
__device__ void udiv256(uint32_t quo[ACVM_LIMBS], const uint32_t x[ACVM_LIMBS],
                        const uint32_t y[ACVM_LIMBS]) {
    int m = 0, len = 0;
    uint32_t ytop = 0;
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) {
        quo[j] = 0;
        m = x[j] ? j + 1 : m;
        len = y[j] ? j + 1 : len;
        ytop = y[j] ? y[j] : ytop;
    }
    if (m < len) return;  // a < b
    const uint32_t s = __clz(ytop);
    uint32_t u[ACVM_LIMBS + 1], v[ACVM_LIMBS];
    u[ACVM_LIMBS] = __funnelshift_l(x[ACVM_LIMBS - 1], 0u, s);
#pragma unroll
    for (int j = ACVM_LIMBS - 1; j > 0; --j) {
        u[j] = __funnelshift_l(x[j - 1], x[j], s);
        v[j] = __funnelshift_l(y[j - 1], y[j], s);
    }
    u[0] = x[0] << s;
    v[0] = y[0] << s;
    if (len == 1) {
        uint32_t rem = m == ACVM_LIMBS ? u[ACVM_LIMBS] : 0u;
#pragma unroll
        for (int j = ACVM_LIMBS - 1; j >= 0; --j) {
            if (j > m) continue;
            if (j == m) {
                rem = u[j];
                continue;
            }
            quo[j] = div_2by1(rem, u[j], v[0], rem);
        }
        return;
    }
    switch (len) {
        case 2: long_division<2>(u, v, m, quo); break;
        case 3: long_division<3>(u, v, m, quo); break;
        case 4: long_division<4>(u, v, m, quo); break;
        case 5: long_division<5>(u, v, m, quo); break;
        case 6: long_division<6>(u, v, m, quo); break;
        case 7: long_division<7>(u, v, m, quo); break;
        default: long_division<8>(u, v, m, quo); break;
    }
}

// |to_signed(x)| at `bits` and its sign: x below 2^(bits-1) is itself, x at
// or above 2^bits is x - 2^bits (positive), the rest 2^bits - x (negative).
__device__ __forceinline__ bool signed_magnitude(uint32_t mag[ACVM_LIMBS], const uint32_t x[ACVM_LIMBS],
                                                 int bits) {
    if (below_pow2(x, bits - 1)) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) mag[j] = x[j];
        return false;
    }
    uint32_t top[ACVM_LIMBS];  // 2^bits, or 0 (= 2^256 mod 2^256) at 256 bits
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) top[j] = (bits < 256 && j == (bits >> 5)) ? 1u << (bits & 31) : 0u;
    const bool neg = bits == 256 || below_pow2(x, bits);
    if (neg) {
        uint32_t zero[ACVM_LIMBS] = {0, 0, 0, 0, 0, 0, 0, 0};
        sub_limbs(mag, zero, x);
        mask_bits(mag, bits);
    } else {
        sub_limbs(mag, x, top);
    }
    return neg;
}

// One BinaryIntOp; false where it traps (an UnsignedDiv by zero).
__device__ bool int_op(uint32_t r[ACVM_LIMBS], int sub, int bits, const uint32_t a[ACVM_LIMBS],
                       const uint32_t b[ACVM_LIMBS], const VmField& vf) {
    uint32_t am[ACVM_LIMBS], bm[ACVM_LIMBS];
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) {
        am[j] = a[j];
        bm[j] = b[j];
    }
    mask_bits(am, bits);
    mask_bits(bm, bits);
    switch (sub) {
        case I_ADD: add_limbs(r, am, bm); break;
        case I_SUB: sub_limbs(r, am, bm); break;
        case I_MUL: mul_low(r, am, bm); break;
        case I_UDIV: {
            if (is_zero(bm)) return false;
            udiv256(r, am, bm);
            break;
        }
        case I_SDIV: {
            uint32_t ma[ACVM_LIMBS], mb[ACVM_LIMBS], q[ACVM_LIMBS];
            const bool neg = signed_magnitude(ma, a, bits) != signed_magnitude(mb, b, bits);
            if (is_zero(mb)) {
                set_word(q, 0);
            } else {
                udiv256(q, ma, mb);
            }
            if (neg) {
                uint32_t zero[ACVM_LIMBS] = {0, 0, 0, 0, 0, 0, 0, 0};
                sub_limbs(r, zero, q);
            } else {
#pragma unroll
                for (int j = 0; j < ACVM_LIMBS; ++j) r[j] = q[j];
            }
            break;
        }
        case I_EQ: set_word(r, equal(am, bm)); return true;  // 0 or 1 at any bit size
        case I_LT: set_word(r, less_than(am, bm)); return true;
        case I_LTE: set_word(r, !less_than(bm, am)); return true;
        case I_AND:
        case I_OR:
        case I_XOR:
#pragma unroll
            for (int j = 0; j < ACVM_LIMBS; ++j)
                r[j] = sub == I_AND ? am[j] & bm[j] : (sub == I_OR ? am[j] | bm[j] : am[j] ^ bm[j]);
            break;
        default: {  // I_SHL, I_SHR: by the low 32 bits of b; 2^32 or more is "everything"
            bool huge = false;
#pragma unroll
            for (int j = 1; j < ACVM_LIMBS; ++j) huge |= b[j] != 0;
            const uint32_t s = huge ? 0xFFFFFFFFu : b[0];
            if (sub == I_SHL) shift_left(r, am, (int)min(s, (uint32_t)min(bits, 256)));
            else shift_right(r, a, (int)min(s, 256u));
            break;
        }
    }
    mask_bits(r, bits);
    if (bits >= vf.p_bits) reduce_full(r, vf.f);
    return true;
}

__device__ void field_op(uint32_t r[ACVM_LIMBS], int sub, const uint32_t a[ACVM_LIMBS],
                         const uint32_t b[ACVM_LIMBS], const VmField& vf, const PowSchedule& inv) {
    switch (sub) {
        case F_ADD: add_mod(r, a, b, vf.f); break;
        case F_SUB: sub_mod(r, a, b, vf.f); break;
        case F_MUL: {
            uint32_t t[ACVM_LIMBS];
            mont_mul(t, a, b, vf.f);    // a b R^-1
            mont_mul(r, t, vf.r2, vf.f);  // a b
            break;
        }
        case F_DIV: {
            uint32_t bm[ACVM_LIMBS], bi[ACVM_LIMBS];
            mont_mul(bm, b, vf.r2, vf.f);  // b R
            pow_chain(bi, bm, inv, vf.f);  // b^-1 R (0 for b = 0)
            mont_mul(r, a, bi, vf.f);      // a b^-1
            break;
        }
        default: set_word(r, equal(a, b)); break;
    }
}

// A 64-bit-clean pointer below 2^32 (the JAX device VM's test), or -1.
__device__ __forceinline__ long long pointer_of(const uint32_t x[ACVM_LIMBS]) {
    uint32_t high = 0;
#pragma unroll
    for (int j = 1; j < ACVM_LIMBS; ++j) high |= x[j];
    return high ? -1 : (long long)x[0];
}

// The state of one instance: element (row, limb) of its registers or memory.
// On chip it is the lane's column of a block's [row][limb][lane] array in
// shared memory, so the 32 lanes of a warp reading one row touch 32
// consecutive words, one a bank; in device memory it is the instance's column
// of the (rows, 8, B) panel.
template <bool ON_CHIP>
struct Rows {
    uint32_t* base;  // element (0, 0) of this instance
    long long B;     // the panel's instance stride (device memory only)

    __device__ __forceinline__ void load(uint32_t x[ACVM_LIMBS], int row) const {
        if constexpr (ON_CHIP) {
            const uint32_t* src = base + row * ACVM_LIMBS * VM_THREADS;
#pragma unroll
            for (int j = 0; j < ACVM_LIMBS; ++j) x[j] = src[j * VM_THREADS];
        } else {
            const uint32_t* src = base + (long long)row * ACVM_LIMBS * B;
#pragma unroll
            for (int j = 0; j < ACVM_LIMBS; ++j) x[j] = src[j * B];
        }
    }
    __device__ __forceinline__ uint64_t load64(int row) const {  // limbs 0 and 1
        if constexpr (ON_CHIP) {
            const uint32_t* src = base + row * ACVM_LIMBS * VM_THREADS;
            return (uint64_t)src[VM_THREADS] << 32 | src[0];
        } else {
            const uint32_t* src = base + (long long)row * ACVM_LIMBS * B;
            return (uint64_t)src[B] << 32 | src[0];
        }
    }
    __device__ __forceinline__ void store64(int row, uint64_t z) const {  // limbs 2-7 zero
        const uint32_t x[ACVM_LIMBS] = {(uint32_t)z, (uint32_t)(z >> 32), 0, 0, 0, 0, 0, 0};
        store(row, x);
    }
    __device__ __forceinline__ void store(int row, const uint32_t x[ACVM_LIMBS]) const {
        if constexpr (ON_CHIP) {
            uint32_t* dst = base + row * ACVM_LIMBS * VM_THREADS;
#pragma unroll
            for (int j = 0; j < ACVM_LIMBS; ++j) dst[j * VM_THREADS] = x[j];
        } else {
            uint32_t* dst = base + (long long)row * ACVM_LIMBS * B;
#pragma unroll
            for (int j = 0; j < ACVM_LIMBS; ++j) dst[j * B] = x[j];
        }
    }
};

// Copy `rows` rows of one instance between the (rows, 8, B) panel and its
// lane of the block's [row][limb][lane] array: every load independent.
__device__ __forceinline__ void panel_to_chip(uint32_t* chip, const uint32_t* panel, int rows,
                                              long long B) {
#pragma unroll 8
    for (int k = 0; k < rows * ACVM_LIMBS; ++k) chip[k * VM_THREADS] = panel[(long long)k * B];
}

__device__ __forceinline__ void chip_to_panel(uint32_t* panel, const uint32_t* chip, int rows,
                                              long long B) {
#pragma unroll 8
    for (int k = 0; k < rows * ACVM_LIMBS; ++k) panel[(long long)k * B] = chip[k * VM_THREADS];
}

// A BinaryIntOp at bit_size <= 64 on the low two limbs, for the ops that read
// their operands masked (not SignedDiv, Shl or Shr): the same result as
// int_op, with no reduction mod p at these widths.  ok is false where an
// UnsignedDiv divides by zero.
__device__ __forceinline__ uint64_t narrow_int_op(int sub, int bits, uint64_t a, uint64_t b, bool& ok) {
    const uint64_t mask = bits >= 64 ? ~0ull : (1ull << bits) - 1;
    a &= mask;
    b &= mask;
    ok = true;
    switch (sub) {
        case I_ADD: return (a + b) & mask;
        case I_SUB: return (a - b) & mask;
        case I_MUL: return (a * b) & mask;
        case I_UDIV:
            ok = b != 0;
            if (!ok) return 0;
            return bits <= 32 ? (uint64_t)((uint32_t)a / (uint32_t)b) : a / b;
        case I_EQ: return a == b;  // 0 or 1 at any bit size
        case I_LT: return a < b;
        case I_LTE: return a <= b;
        case I_AND: return a & b;
        case I_OR: return a | b;
        default: return a ^ b;  // I_XOR
    }
}

// One instance's interpreter state.
struct Lane {
    int pc = 0, sp = 0, steps = 0;
    int back_edges = 0;  // jumps taken to a pc at or before their own
    int mem_top = 0;     // 1 + the highest memory cell stored: the rows to write back
    int state = VM_HALTED;
};

struct VmProgram {
    const int* table;  // (n_pc, 16): in shared memory, or read-only in device memory
    int n_pc, mem_cap, max_steps;
};

// One opcode of one instance: its step counted against the budget, executed,
// and the next pc taken.  False once the instance stops (lane.state says how).
template <bool TABLE_ON_CHIP, bool REGS_ON_CHIP, bool MEM_ON_CHIP>
__device__ __forceinline__ bool vm_step(const VmProgram& prog, const Rows<REGS_ON_CHIP>& regs,
                                        const Rows<MEM_ON_CHIP>& mem, int* stack, Lane& lane,
                                        const VmField& vf, const PowSchedule& inv) {
    if (lane.steps >= prog.max_steps) {
        lane.state = VM_ESCAPED;
        return false;
    }
    ++lane.steps;
    const int pc = lane.pc;
    const int4* word = reinterpret_cast<const int4*>(prog.table + pc * VM_WORDS);
    const int4 w0 = TABLE_ON_CHIP ? word[0] : __ldg(word);
    const int4 w1 = TABLE_ON_CHIP ? word[1] : __ldg(word + 1);
    const int kind = w0.x, sub = w0.y, dst = w0.z, lhs = w0.w, rhs = w1.x, loc = w1.y;
    uint32_t a[ACVM_LIMBS], b[ACVM_LIMBS], r[ACVM_LIMBS];
    int next = pc + 1;
    switch (kind) {
        case K_BIN_FIELD:
        case K_BIN_INT:
            if (kind == K_BIN_INT && w1.z <= 64 && sub != I_SDIV && sub < I_SHL) {
                bool ok;
                const uint64_t z = narrow_int_op(sub, w1.z, regs.load64(lhs), regs.load64(rhs), ok);
                if (!ok) {
                    lane.state = VM_TRAPPED;
                    return false;
                }
                regs.store64(dst, z);
                break;
            }
            regs.load(a, lhs);
            regs.load(b, rhs);
            if (kind == K_BIN_FIELD) {
                field_op(r, sub, a, b, vf, inv);
            } else if (!int_op(r, sub, w1.z, a, b, vf)) {
                lane.state = VM_TRAPPED;
                return false;
            }
            regs.store(dst, r);
            break;
        case K_JUMP:
            next = loc;
            lane.back_edges += next <= pc;
            break;
        case K_JUMP_IF:
        case K_JUMP_IF_NOT:
            regs.load(a, lhs);
            if (is_zero(a) == (kind == K_JUMP_IF_NOT)) {
                next = loc;
                lane.back_edges += next <= pc;
            }
            break;
        case K_CALL:
            if (lane.sp >= VM_CALL_DEPTH) {
                lane.state = VM_ESCAPED;
                return false;
            }
            stack[lane.sp++ * VM_THREADS] = pc;
            next = loc;
            break;
        case K_RETURN:
            if (lane.sp == 0) {
                lane.state = VM_TRAPPED;
                return false;
            }
            next = stack[--lane.sp * VM_THREADS] + 1;
            break;
        case K_CONST: {
            const int4 c0 = TABLE_ON_CHIP ? word[2] : __ldg(word + 2);
            const int4 c1 = TABLE_ON_CHIP ? word[3] : __ldg(word + 3);
            const uint32_t c[ACVM_LIMBS] = {(uint32_t)c0.x, (uint32_t)c0.y, (uint32_t)c0.z, (uint32_t)c0.w,
                                            (uint32_t)c1.x, (uint32_t)c1.y, (uint32_t)c1.z, (uint32_t)c1.w};
            regs.store(dst, c);
            break;
        }
        case K_MOV:
            regs.load(a, lhs);
            regs.store(dst, a);
            break;
        case K_LOAD:
        case K_STORE: {
            regs.load(a, kind == K_LOAD ? lhs : rhs);  // the pointer
            const long long ptr = pointer_of(a);
            if (ptr < 0 || ptr >= prog.mem_cap) {
                lane.state = VM_ESCAPED;
                return false;
            }
            if (kind == K_LOAD) {
                mem.load(r, (int)ptr);
                regs.store(dst, r);
            } else {
                regs.load(r, lhs);
                mem.store((int)ptr, r);
                lane.mem_top = max(lane.mem_top, (int)ptr + 1);
            }
            break;
        }
        case K_TRAP: lane.state = VM_TRAPPED; return false;
        default: return false;  // K_STOP
    }
    lane.pc = next;
    return next < prog.n_pc;  // a pc at or past the end halts
}

// Shared memory of a block, in this order: the instruction table where it is
// on chip, the call stacks ([depth][lane] ints), the registers where they are
// on chip and the memory where it is ([row][limb][lane] words).  Memory goes
// back to its panel up to the highest cell stored: the rows above hold what
// they were given.
template <bool TABLE_ON_CHIP, bool REGS_ON_CHIP, bool MEM_ON_CHIP>
__global__ void __launch_bounds__(VM_THREADS)
brillig_vm_kernel(const int* __restrict__ prog, int n_pc, uint32_t* __restrict__ regs_g,
                  uint32_t* __restrict__ mem_g, int* __restrict__ status, int* __restrict__ steps_out,
                  long long B, int n_regs, int mem_cap, int max_steps,
                  const __grid_constant__ VmField vf, const __grid_constant__ PowSchedule inv) {
    extern __shared__ __align__(16) int shared[];
    const int lane_id = threadIdx.x;
    const int table_words = TABLE_ON_CHIP ? n_pc * VM_WORDS : 0;
    if constexpr (TABLE_ON_CHIP) {
        for (int k = lane_id; k < table_words; k += VM_THREADS) shared[k] = prog[k];
        __syncthreads();
    }
    int* stack = shared + table_words + lane_id;
    uint32_t* chip =
        reinterpret_cast<uint32_t*>(shared + table_words + VM_CALL_DEPTH * VM_THREADS) + lane_id;
    uint32_t* regs_chip = chip;
    uint32_t* mem_chip = chip + (REGS_ON_CHIP ? n_regs * ACVM_LIMBS * VM_THREADS : 0);
    const long long i = (long long)blockIdx.x * VM_THREADS + lane_id;
    const bool in_batch = i < B;  // a lane past B loads, runs and stores nothing
    if (in_batch) {
        if constexpr (REGS_ON_CHIP) panel_to_chip(regs_chip, regs_g + i, n_regs, B);
        if constexpr (MEM_ON_CHIP) panel_to_chip(mem_chip, mem_g + i, mem_cap, B);
    }
    const Rows<REGS_ON_CHIP> regs{REGS_ON_CHIP ? regs_chip : regs_g + i, B};
    const Rows<MEM_ON_CHIP> mem{MEM_ON_CHIP ? mem_chip : mem_g + i, B};
    const VmProgram program{TABLE_ON_CHIP ? shared : prog, n_pc, mem_cap, max_steps};

    Lane lane;
    bool running = in_batch && n_pc > 0;
#if VM_REGROUP
    // Each round the lanes with the warp's lowest key take one step; the
    // others wait and count no step.  The key is the backward jumps taken,
    // then the pc: lanes split by an if / else meet again at the loop head, and
    // a lane that left a loop does not wait for the others to finish it.  Any
    // key gives the same results, only another order; past 2^15 jumps or 2^16
    // opcodes the key is cut.  Every lane stays in the loop until the whole
    // warp is done, so the full-mask reduction sees all 32.
#pragma unroll 1
    for (;;) {
        const unsigned key = (unsigned)min(lane.back_edges, 0x7FFF) << 16 | (unsigned)(lane.pc & 0xFFFF);
        const unsigned first = __reduce_min_sync(0xFFFFFFFFu, running ? key : 0xFFFFFFFFu);
        if (first == 0xFFFFFFFFu) break;
        if (running && key == first)
            running = vm_step<TABLE_ON_CHIP>(program, regs, mem, stack, lane, vf, inv);
    }
#else
#pragma unroll 1
    while (running) running = vm_step<TABLE_ON_CHIP>(program, regs, mem, stack, lane, vf, inv);
#endif
    if (!in_batch) return;
    if constexpr (REGS_ON_CHIP) chip_to_panel(regs_g + i, regs_chip, n_regs, B);
    if constexpr (MEM_ON_CHIP) chip_to_panel(mem_g + i, mem_chip, lane.mem_top, B);
    status[i] = lane.state;
    steps_out[i] = lane.steps;
}

template <bool TABLE_ON_CHIP, bool REGS_ON_CHIP, bool MEM_ON_CHIP>
static cudaError_t launch_vm(long long B, int shared_bytes, cudaStream_t stream, const int* prog,
                             int n_pc, uint32_t* regs, uint32_t* mem, int* status, int* steps,
                             int n_regs, int mem_cap, int max_steps, const VmField& vf,
                             const PowSchedule& inv) {
    auto kernel = brillig_vm_kernel<TABLE_ON_CHIP, REGS_ON_CHIP, MEM_ON_CHIP>;
    if (shared_bytes > 48 * 1024) {  // above 48 KB a kernel must opt in, once on each device
        static std::atomic<bool> opted_in[VM_MAX_DEVICES];
        int device = 0;
        cudaError_t err = cudaGetDevice(&device);
        if (err != cudaSuccess) return err;
        if (device >= VM_MAX_DEVICES) return cudaErrorInvalidDevice;
        if (!opted_in[device].load()) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, VM_SHARED_LIMIT);
            if (err != cudaSuccess) return err;
            opted_in[device].store(true);
        }
    }
    const long long blocks = (B + VM_THREADS - 1) / VM_THREADS;
    kernel<<<(unsigned)blocks, VM_THREADS, shared_bytes, stream>>>(
        prog, n_pc, regs, mem, status, steps, B, n_regs, mem_cap, max_steps, vf, inv);
    return cudaGetLastError();
}

// prog: (n_pc, 16) int32 instruction table; regs (n_regs, 8, B) and mem
// (mem_cap, 8, B) uint32, updated in place; status, steps: (B,) int32 out.
// field_words: [p | R | n0 | R^2 | p's bit length]; schedule: p - 2's chain.
// The launch plan (gpu/brillig_vm_device.py::vm_launch_plan): threads a
// block, which of the table, registers and memory are on chip, and the shared
// bytes that implies; a plan this source would lay out otherwise is refused
// (cudaErrorInvalidValue) before anything runs.
extern "C" int acvm_brillig_vm(const void* prog, int n_pc, void* regs, void* mem, void* status,
                               void* steps, long long B, int n_regs, int mem_cap, int max_steps,
                               const uint32_t* field_words, const uint32_t* schedule_words,
                               int threads, int table_on_chip, int regs_on_chip, int mem_on_chip,
                               int shared_bytes, void* stream) {
    if (B <= 0) return 0;
    const long long row = (long long)ACVM_LIMBS * sizeof(uint32_t) * VM_THREADS;
    const long long table = (long long)n_pc * VM_WORDS * sizeof(int);
    const long long want = (table_on_chip ? table : 0) + (long long)VM_CALL_DEPTH * sizeof(int) * VM_THREADS +
                           (regs_on_chip ? n_regs * row : 0) + (mem_on_chip ? mem_cap * row : 0);
    if (threads != VM_THREADS || want != shared_bytes || want > VM_SHARED_LIMIT ||
        (table_on_chip && table > VM_TABLE_ON_CHIP_BYTES) || (mem_on_chip && !regs_on_chip))
        return (int)cudaErrorInvalidValue;
    VmField vf;
    vf.f = field_from_words(field_words);
    for (int j = 0; j < ACVM_LIMBS; ++j) vf.r2[j] = field_words[2 * ACVM_LIMBS + 1 + j];
    vf.p_bits = (int)field_words[3 * ACVM_LIMBS + 1];
    const PowSchedule inv = pow_schedule_from_words(schedule_words);
    auto* launch = table_on_chip
        ? (mem_on_chip ? launch_vm<true, true, true>
                       : (regs_on_chip ? launch_vm<true, true, false> : launch_vm<true, false, false>))
        : (mem_on_chip ? launch_vm<false, true, true>
                       : (regs_on_chip ? launch_vm<false, true, false> : launch_vm<false, false, false>));
    return (int)launch(B, shared_bytes, (cudaStream_t)stream, (const int*)prog, n_pc, (uint32_t*)regs,
                       (uint32_t*)mem, (int*)status, (int*)steps, n_regs, mem_cap, max_steps, vf, inv);
}
