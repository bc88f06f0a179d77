// Elementwise Montgomery multiply: out[i] = a[i] * b[i] * R^-1 mod p.
//
// One thread owns one element: two 16-byte loads per operand, 136
// multiply-adds, two 16-byte stores.  At 96 bytes and 136 multiply-adds per
// element the card's integer pipes, not its memory, bound it.
// `b_broadcast` multiplies every a[i] by the single element b[0] (to_mont /
// from_mont).  `reduce == 0` leaves the redundant result < 2p.
#include "field.cuh"

__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long n, int b_broadcast,
                                int reduce, const Field f) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS];
    load_fe(x, a + i * ACVM_LIMBS);
    load_fe(y, b + (b_broadcast ? 0 : i * ACVM_LIMBS));
    mont_mul(x, x, y, f, reduce != 0);
    store_fe(out + i * ACVM_LIMBS, x);
}

extern "C" int acvm_mont_mul(const void* a, const void* b, void* out, long long n,
                             int b_broadcast, int reduce, const uint32_t* field_words,
                             void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, b_broadcast, reduce,
        field_from_words(field_words));
    return (int)cudaGetLastError();
}
