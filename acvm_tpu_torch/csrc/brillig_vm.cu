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
// State.  The instruction table (16 words an opcode, `_Program` in
// `gpu/brillig_vm_device.py`) is copied into shared memory once a block of
// threads, or read from device memory through the read-only cache when it is
// larger than 48 KB.  The registers (NR x 8 words) and the memory (mem_cap x 8
// words) of every instance live in device memory as (NR, 8, B) and (mem_cap,
// 8, B): the 32 lanes of a warp reading one register at one pc touch 32
// consecutive words.  The call stack (32 ints) is the thread's, in local
// memory.  Values are canonical integers below p, not Montgomery form.
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
// Bound.  The bytes are the state read and written once (registers, memory,
// flags); the operations those of the opcodes the instances execute (136
// multiply-adds a Montgomery product, 311 + 2 products a Div, a few dozen for
// an int op, one for control flow): both far below what one thread an
// instance takes, because a step waits on its loads and lanes of a warp at
// different pcs run one after the other.  Counting that divergence is
// `chip_smoke.py`'s (steps an instance, mean and max); keeping registers on
// chip and regrouping instances by pc are later work (ROADMAP queue 2.B).
#include "divmod.cuh"
#include "pow.cuh"

#define VM_WORDS 16          // words an instruction
#define VM_CALL_DEPTH 32     // CALL_STACK_DEPTH of the JAX device VM
#define VM_THREADS 128
#define VM_SHARED_BYTES 49152  // an instruction table up to this size goes to shared memory

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

// Element `row` of a (rows, 8, B) panel, for instance i.
__device__ __forceinline__ void load_lane(uint32_t x[ACVM_LIMBS], const uint32_t* panel, int row,
                                          long long B, long long i) {
    const uint32_t* src = panel + (long long)row * ACVM_LIMBS * B + i;
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) x[j] = src[j * B];
}

__device__ __forceinline__ void store_lane(uint32_t* panel, int row, long long B, long long i,
                                           const uint32_t x[ACVM_LIMBS]) {
    uint32_t* dst = panel + (long long)row * ACVM_LIMBS * B + i;
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) dst[j * B] = x[j];
}

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

__global__ void __launch_bounds__(VM_THREADS)
brillig_vm_kernel(const int* __restrict__ prog, int n_pc, bool shared_table,
                  uint32_t* __restrict__ regs, uint32_t* __restrict__ mem, int* __restrict__ status,
                  int* __restrict__ steps_out, long long B, int mem_cap, int max_steps,
                  const __grid_constant__ VmField vf, const __grid_constant__ PowSchedule inv) {
    extern __shared__ int table[];
    if (shared_table) {
        for (int k = threadIdx.x; k < n_pc * VM_WORDS; k += blockDim.x) table[k] = prog[k];
        __syncthreads();
    }
    const int* code = shared_table ? table : prog;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;

    int stack[VM_CALL_DEPTH];
    int pc = 0, sp = 0, steps = 0, state = VM_HALTED;
    uint32_t a[ACVM_LIMBS], b[ACVM_LIMBS], r[ACVM_LIMBS];
#pragma unroll 1
    while (pc < n_pc) {
        if (steps >= max_steps) {
            state = VM_ESCAPED;
            break;
        }
        ++steps;
        const int* op = code + pc * VM_WORDS;
        const int kind = op[0], sub = op[1], dst = op[2], lhs = op[3], rhs = op[4], loc = op[5];
        int next = pc + 1;
        if (kind == K_BIN_FIELD || kind == K_BIN_INT) {
            load_lane(a, regs, lhs, B, i);
            load_lane(b, regs, rhs, B, i);
            if (kind == K_BIN_FIELD) {
                field_op(r, sub, a, b, vf, inv);
            } else if (!int_op(r, sub, op[6], a, b, vf)) {
                state = VM_TRAPPED;
                break;
            }
            store_lane(regs, dst, B, i, r);
        } else if (kind == K_JUMP) {
            next = loc;
        } else if (kind == K_JUMP_IF || kind == K_JUMP_IF_NOT) {
            load_lane(a, regs, lhs, B, i);
            if (is_zero(a) == (kind == K_JUMP_IF_NOT)) next = loc;
        } else if (kind == K_CALL) {
            if (sp >= VM_CALL_DEPTH) {
                state = VM_ESCAPED;
                break;
            }
            stack[sp++] = pc;
            next = loc;
        } else if (kind == K_RETURN) {
            if (sp == 0) {
                state = VM_TRAPPED;
                break;
            }
            next = stack[--sp] + 1;
        } else if (kind == K_CONST) {
#pragma unroll
            for (int j = 0; j < ACVM_LIMBS; ++j) r[j] = (uint32_t)op[8 + j];
            store_lane(regs, dst, B, i, r);
        } else if (kind == K_MOV) {
            load_lane(a, regs, lhs, B, i);
            store_lane(regs, dst, B, i, a);
        } else if (kind == K_LOAD || kind == K_STORE) {
            load_lane(a, regs, kind == K_LOAD ? lhs : rhs, B, i);  // the pointer
            const long long ptr = pointer_of(a);
            if (ptr < 0 || ptr >= mem_cap) {
                state = VM_ESCAPED;
                break;
            }
            if (kind == K_LOAD) {
                load_lane(r, mem, (int)ptr, B, i);
                store_lane(regs, dst, B, i, r);
            } else {
                load_lane(r, regs, lhs, B, i);
                store_lane(mem, (int)ptr, B, i, r);
            }
        } else if (kind == K_TRAP) {
            state = VM_TRAPPED;
            break;
        } else {  // K_STOP
            break;
        }
        pc = next;
    }
    status[i] = state;
    steps_out[i] = steps;
}

// prog: (n_pc, 16) int32 instruction table; regs (n_regs, 8, B) and mem
// (mem_cap, 8, B) uint32, updated in place; status, steps: (B,) int32 out.
// field_words: [p | R | n0 | R^2 | p's bit length]; schedule: p - 2's chain.
extern "C" int acvm_brillig_vm(const void* prog, int n_pc, void* regs, void* mem, void* status,
                               void* steps, long long B, int mem_cap, int max_steps,
                               const uint32_t* field_words, const uint32_t* schedule_words,
                               void* stream) {
    if (B <= 0) return 0;
    VmField vf;
    vf.f = field_from_words(field_words);
    for (int j = 0; j < ACVM_LIMBS; ++j) vf.r2[j] = field_words[2 * ACVM_LIMBS + 1 + j];
    vf.p_bits = (int)field_words[3 * ACVM_LIMBS + 1];
    const size_t table_bytes = (size_t)n_pc * VM_WORDS * sizeof(int);
    const bool shared_table = table_bytes <= VM_SHARED_BYTES;
    const long long blocks = (B + VM_THREADS - 1) / VM_THREADS;
    brillig_vm_kernel<<<(unsigned)blocks, VM_THREADS, shared_table ? table_bytes : 0,
                        (cudaStream_t)stream>>>(
        (const int*)prog, n_pc, shared_table, (uint32_t*)regs, (uint32_t*)mem, (int*)status,
        (int*)steps, B, mem_cap, max_steps, vf, pow_schedule_from_words(schedule_words));
    return (int)cudaGetLastError();
}
