// Elementwise Montgomery multiply: out[i] = a[i] * b[i] * R^-1 mod p.
//
// One thread owns one element: two 16-byte loads per operand, 136
// multiply-adds, two 16-byte stores.  At 96 bytes and 136 multiply-adds per
// element the card's integer pipes, not its memory, bound it.
// `b_broadcast` multiplies every a[i] by the single element b[0] (to_mont /
// from_mont).  `reduce == 0` leaves the redundant result < 2p.
//
// Built twice: as `mul` over the narrow field and, with -DACVM_WIDE, as
// `mul_wide` over a wide one (p > 2^255: secp256k1 and secp256r1), whose
// product carries a ninth word and always reduces (a result < 2p does not fit
// eight limbs there).
#include "field.cuh"

template <class F>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long n, int b_broadcast,
                                int reduce, const F f) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS];
    load_fe(x, a + i * ACVM_LIMBS);
    load_fe(y, b + (b_broadcast ? 0 : i * ACVM_LIMBS));
    if constexpr (F::wide) {
        mont_mul(x, x, y, f);
    } else {
        mont_mul(x, x, y, f, reduce != 0);
    }
    store_fe(out + i * ACVM_LIMBS, x);
}

extern "C" int acvm_mont_mul(const void* a, const void* b, void* out, long long n,
                             int b_broadcast, int reduce, const uint32_t* field_words,
                             void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    mont_mul_kernel<KernelField><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, b_broadcast, reduce,
        field_from_words_as<KernelField>(field_words));
    return (int)cudaGetLastError();
}
