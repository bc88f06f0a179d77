// Fixed-exponent power: out[i] = a[i]^e in Montgomery form, 0 -> 0.
//
// Replaces the JAX package's `fields/pallas_mul.py::_make_pow_kernel`
// (`mont_pow_pallas`).  One thread owns one element and runs the whole chain of
// `pow.cuh`: a sliding window over the odd powers a .. a^15, its schedule built
// on the host and passed in the constant bank.  About 311 products per 64 bytes
// moved: bound by the integer pipes once the card is full (n above ~2^15), by
// one chain's latency below that.  With e = p - 2 this is the field inverse.
// Built twice: as `pow` over the narrow field and, with -DACVM_WIDE, as
// `pow_wide` over a wide one (a general exponent; a wide field's inverse is
// `inv.cu`'s divsteps).
#include "pow.cuh"

__global__ void __launch_bounds__(ACVM_POW_THREADS)
mont_pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n,
                const __grid_constant__ PowSchedule s, const KernelField f) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t base[ACVM_LIMBS], acc[ACVM_LIMBS];
    load_fe(base, a + i * ACVM_LIMBS);
    pow_chain(acc, base, s, f);
    if (is_zero(base)) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) acc[j] = 0;
    }
    store_fe(out + i * ACVM_LIMBS, acc);
}

extern "C" int acvm_mont_pow(const void* a, void* out, long long n,
                             const uint32_t* schedule_words, const uint32_t* field_words,
                             void* stream) {
    if (n <= 0) return 0;
    const int threads = ACVM_POW_THREADS;
    const long long blocks = (n + threads - 1) / threads;
    mont_pow_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, n, pow_schedule_from_words(schedule_words),
        field_from_words_as<KernelField>(field_words));
    return (int)cudaGetLastError();
}
