// Fixed-exponent power: out[i] = a[i]^e in Montgomery form, 0 -> 0.
//
// One thread owns one element and runs the whole chain: a 16-entry table of
// powers a^0..a^15, then 64 windows of 4 bits, MSB first, each 4 squarings and
// one multiply by the table entry the window's digit selects.  The exponent
// is a kernel argument (constant bank); every thread reads the same digit, so
// the table lookup does not diverge.  The table lives in local memory (128
// words a thread); 335 multiplies per 64 bytes moved make this kernel bound by
// the integer pipes.  With e = p - 2 this is the field inverse.
#include "field.cuh"

struct Exponent {
    uint32_t w[ACVM_LIMBS];   // little-endian 32-bit words of e
};

__global__ void mont_pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                                long long n, const Exponent e, const Field f) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t base[ACVM_LIMBS];
    load_fe(base, a + i * ACVM_LIMBS);
    const bool zero = is_zero(base);

    uint32_t table[16][ACVM_LIMBS];
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) table[0][j] = f.r[j];
#pragma unroll 1
    for (int k = 1; k < 16; ++k) mont_mul(table[k], table[k - 1], base, f);

    uint32_t acc[ACVM_LIMBS];
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) acc[j] = f.r[j];
#pragma unroll 1
    for (int w = 8 * ACVM_LIMBS - 1; w >= 0; --w) {
#pragma unroll 1
        for (int s = 0; s < 4; ++s) mont_mul(acc, acc, acc, f);
        const uint32_t digit = (e.w[w >> 3] >> ((w & 7) * 4)) & 0xFu;
        mont_mul(acc, acc, table[digit], f);
    }
    if (zero) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) acc[j] = 0;
    }
    store_fe(out + i * ACVM_LIMBS, acc);
}

extern "C" int acvm_mont_pow(const void* a, void* out, long long n,
                             const uint32_t* exponent_words, const uint32_t* field_words,
                             void* stream) {
    if (n <= 0) return 0;
    Exponent e;
    for (int i = 0; i < ACVM_LIMBS; ++i) e.w[i] = exponent_words[i];
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    mont_pow_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, n, e, field_from_words(field_words));
    return (int)cudaGetLastError();
}
