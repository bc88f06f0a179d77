// First-generation expression-panel dot: the products of quadratic terms are
// multiplied before the call (mul_v1.cu) and arrive as one more operand panel.
//
//   out[e, b] = [scale[e] *] ( qc[e] + sum_t coeff[e, t] * vals[e, t, b] )
//
// Replaces acvm_tpu/fields/pallas_mul.py::_make_dot_kernel (mont_dot_pallas).
// `*` is the Montgomery product, every result canonical; qc is added as
// given.  One thread owns one (gate e, instance b), the instance the fastest
// axis; each term joins the sum with one modular add, so any term count is
// exact.  A term with a zero coefficient (padding to the widest gate) is
// skipped, operand load and all.  Moves 32 bytes per operand against 136
// multiply-adds: the integer pipes bound it.
#include "field.cuh"

__global__ void mont_dot_v1_kernel(const uint32_t* __restrict__ vals,    // (E, T, B, 8)
                                   const uint32_t* __restrict__ coeff,   // (E, T, 8)
                                   const uint32_t* __restrict__ qc,      // (E, 8)
                                   const uint32_t* __restrict__ scale,   // (E, 8) or null
                                   uint32_t* __restrict__ out,           // (E, B, 8)
                                   long long E, long long B, int T, const Field f) {
    const long long e = blockIdx.y + (long long)blockIdx.z * gridDim.y;
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E || b >= B) return;

    uint32_t acc[ACVM_LIMBS], c[ACVM_LIMBS], v[ACVM_LIMBS];
    load_fe(acc, qc + e * ACVM_LIMBS);
    for (int t = 0; t < T; ++t) {
        load_fe(c, coeff + (e * T + t) * ACVM_LIMBS);
        if (is_zero(c)) continue;   // a padding term; the whole block skips it
        load_fe(v, vals + ((e * T + t) * B + b) * ACVM_LIMBS);
        mont_mul(v, c, v, f);
        add_mod(acc, acc, v, f);
    }
    if (scale != nullptr) {
        load_fe(c, scale + e * ACVM_LIMBS);
        mont_mul(acc, c, acc, f);
    }
    store_fe(out + (e * B + b) * ACVM_LIMBS, acc);
}

extern "C" int acvm_mont_dot_v1(const void* vals, const void* coeff, const void* qc,
                                const void* scale, void* out, long long E, long long B, int T,
                                const uint32_t* field_words, void* stream) {
    if (E <= 0 || B <= 0) return 0;
    const int threads = 128;
    const long long ey = E < 32768 ? E : 32768;
    dim3 grid((unsigned)((B + threads - 1) / threads), (unsigned)ey,
              (unsigned)((E + ey - 1) / ey));
    mont_dot_v1_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)vals, (const uint32_t*)coeff, (const uint32_t*)qc,
        (const uint32_t*)scale, (uint32_t*)out, E, B, T, field_from_words(field_words));
    return (int)cudaGetLastError();
}
