// One arith-static level, in place on the witness-major panel (NW, B, 8):
//
//   panel[out_idx[g], b] = qc[g] + sum_t lc[g, t] * panel[lin_idx[g, t], b]
//                        + sum_k mc[g, k] * (panel[m1[g, k], b] * panel[m2[g, k], b])
//
// One thread owns one (gate g, instance b).  The block stages its gate's
// descriptor row
//   [lin_idx t1 | mul_idx 2*t2 | out_idx | lin_coeff 8*t1 | mul_coeff 8*t2 | qc 8]
// in shared memory, then every thread gathers its operand limbs straight from
// the panel rows (contiguous across the warp: the instance is the fastest
// axis) and writes its result row.  Blocks run in any order: a level's reads
// never alias its writes, because the planner solves each witness exactly
// once, before any use.  Terms join the sum with one modular add each, so any
// term count is exact.  Gates of one level are packed to the widest; a term
// with a zero coefficient is such padding and is skipped, operand loads and
// all (the coefficient is the same for the whole block, so no warp diverges).  Per (gate, instance): 32 bytes per operand in, 32 out,
// 136 multiply-adds per product; both bounds are close at 2-3 terms.
#include "field.cuh"

__global__ void fused_level_kernel(uint32_t* __restrict__ panel, const int32_t* __restrict__ desc,
                                   long long E, long long B, int t1, int t2, int dw,
                                   const Field f) {
    extern __shared__ uint32_t row[];
    const long long g = blockIdx.y + (long long)blockIdx.z * gridDim.y;
    if (g >= E) return;
    for (int i = threadIdx.x; i < dw; i += blockDim.x) row[i] = (uint32_t)desc[g * dw + i];
    __syncthreads();
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const uint32_t* lin_idx = row;
    const uint32_t* mul_idx = row + t1;
    const uint32_t out_idx = row[t1 + 2 * t2];
    const uint32_t* lin_coeff = row + t1 + 2 * t2 + 1;
    const uint32_t* mul_coeff = lin_coeff + ACVM_LIMBS * t1;
    const uint32_t* qc = mul_coeff + ACVM_LIMBS * t2;

    uint32_t acc[ACVM_LIMBS], c[ACVM_LIMBS], v[ACVM_LIMBS], w[ACVM_LIMBS];
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) acc[j] = qc[j];
    for (int t = 0; t < t1; ++t) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) c[j] = lin_coeff[t * ACVM_LIMBS + j];
        if (is_zero(c)) continue;   // a padding term; the whole block skips it
        load_fe(v, panel + ((long long)lin_idx[t] * B + b) * ACVM_LIMBS);
        mont_mul(v, c, v, f);
        add_mod(acc, acc, v, f);
    }
    for (int t = 0; t < t2; ++t) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) c[j] = mul_coeff[t * ACVM_LIMBS + j];
        if (is_zero(c)) continue;
        load_fe(v, panel + ((long long)mul_idx[2 * t] * B + b) * ACVM_LIMBS);
        load_fe(w, panel + ((long long)mul_idx[2 * t + 1] * B + b) * ACVM_LIMBS);
        mont_mul(v, v, w, f, false);   // < 2p, and c < p: the next product is < 2p
        mont_mul(v, c, v, f);
        add_mod(acc, acc, v, f);
    }
    store_fe(panel + ((long long)out_idx * B + b) * ACVM_LIMBS, acc);
}

extern "C" int acvm_fused_level(void* panel, const void* desc, long long E, long long B, int t1,
                                int t2, const uint32_t* field_words, void* stream) {
    if (E <= 0 || B <= 0) return 0;
    const int dw = t1 + 2 * t2 + 1 + ACVM_LIMBS * (t1 + t2 + 1);
    const size_t smem = (size_t)dw * sizeof(uint32_t);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;   // > 1,300 terms a gate
    const int threads = 128;
    const long long ey = E < 32768 ? E : 32768;
    dim3 grid((unsigned)((B + threads - 1) / threads), (unsigned)ey,
              (unsigned)((E + ey - 1) / ey));
    fused_level_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (uint32_t*)panel, (const int32_t*)desc, E, B, t1, t2, dw, field_from_words(field_words));
    return (int)cudaGetLastError();
}
