// Variable-base scalar multiplication on an a = 0 curve (Grumpkin), the whole
// double-and-add ladder in one launch: out[:, b] = scalar[b] * base[:, b].
//
// Replaces the ladder of acvm_tpu/tpu/ec_pallas.py::scalar_mul_fused, a scan
// of 256 steps that each call the complete-addition kernel twice and select.
// A sequential grid cannot keep a point in registers from one step to the
// next; a thread can.  One thread owns one instance: the accumulator (X, Y, Z)
// lives in registers for all 256 steps, MSB first,
//
//     acc = acc + acc;   if (bit) acc = acc + base;
//
// with the group law of ec.cuh, the one pt_add.cu runs.  acc + acc is the
// complete addition's equal-points branch, which reads one operand only, so
// ec_dbl gives its bits without the eight products that would find out that
// the operands are equal; acc + base for a clear bit is never used, so it is
// not computed.  X, Y and Z equal the reference ladder's limb for limb.  While
// the accumulator is at infinity a step costs no product: leading zero bits
// are free.  The scalar is taken as it comes, all 256 bits, not reduced.
//
// The base never changes and is read from memory when an addition needs a
// coordinate (it stays in L1), so it holds no registers across the loop.
// What bounds the kernel: a batch is 1,024-4,096 threads, under one warp a
// scheduler, so each warp waits out its own chain of about 256 x (7 + 8)
// dependent Montgomery products.  Blocks of 32 threads spread the warps over
// every SM; the time is the chain's latency, which field.cuh's product sets.
#include "ec.cuh"

__global__ void __launch_bounds__(32)
pt_ladder_kernel(const uint32_t* __restrict__ base, long long b_coord, long long b_inst,
                 const uint32_t* __restrict__ scalars, uint32_t* __restrict__ out,
                 long long o_coord, long long o_inst, long long B, const Field f) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const uint32_t* q = base + b * b_inst;
    const uint32_t* k = scalars + b * ACVM_LIMBS;

    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS], z[ACVM_LIMBS];
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) x[i] = y[i] = z[i] = 0;
#pragma unroll 1
    for (int limb = ACVM_LIMBS - 1; limb >= 0; --limb) {
        const uint32_t word = k[limb];
#pragma unroll 1
        for (int bit = 31; bit >= 0; --bit) {
            ec_dbl<0>(x, y, z, f);
            if ((word >> bit) & 1u) ec_add<0>(x, y, z, q, q + b_coord, q + 2 * b_coord, f);
        }
    }
    uint32_t* o = out + b * o_inst;
    store_fe(o, x);
    store_fe(o + o_coord, y);
    store_fe(o + 2 * o_coord, z);
}

extern "C" int acvm_pt_ladder(const void* base, long long b_coord, long long b_inst,
                              const void* scalars, void* out, long long o_coord,
                              long long o_inst, long long B, const uint32_t* field_words,
                              void* stream) {
    if (B <= 0) return 0;
    const int threads = 32;
    pt_ladder_kernel<<<(unsigned)((B + threads - 1) / threads), threads, 0,
                       (cudaStream_t)stream>>>(
        (const uint32_t*)base, b_coord, b_inst, (const uint32_t*)scalars, (uint32_t*)out,
        o_coord, o_inst, B, field_from_words(field_words));
    return (int)cudaGetLastError();
}
