// Expression-panel dot over gathered operands:
//
//   out[e, b] = [scale[e] *] ( qc[e] + sum_t lc[e, t] * lv[e, t, b]
//                                    + sum_k mc[e, k] * (m1[e, k, b] * m2[e, k, b]) )
//
// `*` is the Montgomery product, every result canonical.  One thread owns one
// (gate e, instance b); the instance is the fastest axis, so a warp's loads
// are contiguous.  Per-gate coefficients are the same for the whole block
// (blockIdx.y = gate), read through the read-only cache.  Terms join the sum
// with one modular add each, so any term count is exact: no lazy bound to
// overflow.  A term with a zero coefficient (padding to the widest gate) is
// skipped, operand loads and all.  Moves 32 bytes per operand per thread against 136 multiply-adds
// per product: at 2-3 terms the integer pipes bound it.
#include "field.cuh"

__global__ void mont_dot_kernel(const uint32_t* __restrict__ lin_vals,   // (E, T1, B, 8)
                                const uint32_t* __restrict__ lin_coeff,  // (E, T1, 8)
                                const uint32_t* __restrict__ mul_vals1,  // (E, T2, B, 8)
                                const uint32_t* __restrict__ mul_vals2,  // (E, T2, B, 8)
                                const uint32_t* __restrict__ mul_coeff,  // (E, T2, 8)
                                const uint32_t* __restrict__ qc,         // (E, 8)
                                const uint32_t* __restrict__ scale,      // (E, 8) or null
                                uint32_t* __restrict__ out,              // (E, B, 8)
                                long long E, long long B, int t1, int t2, const Field f) {
    const long long e = blockIdx.y + (long long)blockIdx.z * gridDim.y;
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E || b >= B) return;

    uint32_t acc[ACVM_LIMBS], c[ACVM_LIMBS], v[ACVM_LIMBS], w[ACVM_LIMBS];
    load_fe(acc, qc + e * ACVM_LIMBS);
    for (int t = 0; t < t1; ++t) {
        load_fe(c, lin_coeff + (e * t1 + t) * ACVM_LIMBS);
        if (is_zero(c)) continue;   // a padding term; the whole block skips it
        load_fe(v, lin_vals + ((e * t1 + t) * B + b) * ACVM_LIMBS);
        mont_mul(v, c, v, f);
        add_mod(acc, acc, v, f);
    }
    for (int t = 0; t < t2; ++t) {
        load_fe(c, mul_coeff + (e * t2 + t) * ACVM_LIMBS);
        if (is_zero(c)) continue;
        load_fe(v, mul_vals1 + ((e * t2 + t) * B + b) * ACVM_LIMBS);
        load_fe(w, mul_vals2 + ((e * t2 + t) * B + b) * ACVM_LIMBS);
        mont_mul(v, v, w, f, false);   // < 2p, and c < p: the next product is < 2p
        mont_mul(v, c, v, f);
        add_mod(acc, acc, v, f);
    }
    if (scale != nullptr) {
        load_fe(c, scale + e * ACVM_LIMBS);
        mont_mul(acc, c, acc, f);
    }
    store_fe(out + (e * B + b) * ACVM_LIMBS, acc);
}

extern "C" int acvm_mont_dot(const void* lin_vals, const void* lin_coeff, const void* mul_vals1,
                             const void* mul_vals2, const void* mul_coeff, const void* qc,
                             const void* scale, void* out, long long E, long long B, int t1,
                             int t2, const uint32_t* field_words, void* stream) {
    if (E <= 0 || B <= 0) return 0;
    const int threads = 128;
    const long long ey = E < 32768 ? E : 32768;
    dim3 grid((unsigned)((B + threads - 1) / threads), (unsigned)ey,
              (unsigned)((E + ey - 1) / ey));
    mont_dot_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)lin_vals, (const uint32_t*)lin_coeff, (const uint32_t*)mul_vals1,
        (const uint32_t*)mul_vals2, (const uint32_t*)mul_coeff, (const uint32_t*)qc,
        (const uint32_t*)scale, (uint32_t*)out, E, B, t1, t2, field_from_words(field_words));
    return (int)cudaGetLastError();
}
