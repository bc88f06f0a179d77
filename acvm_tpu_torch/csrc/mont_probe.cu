// Probe, not a kernel of the solver: the candidate Montgomery products of
// field.cuh side by side.  Thread i starts from x = a[i] and runs `chain`
// dependent products x = x * b[i].  With chain = 1 over 2^20 elements the time
// reads the shape of mul.cu (memory as much as arithmetic), with chain = 32
// there the throughput of the integer pipes, and with one warp and a chain of
// 256 the latency of one product, which is what a ladder's lone warp waits for.  Variants: 0 the C product with 64-bit partial sums (one serial carry
// chain), 1 the carry-flag product over even and odd limbs, 2 the unreduced
// 512-bit product followed by one wide reduction.  All three give the same
// canonical values.  3 the wide carry-flag product (WideField, 2^255 < p) in
// the same chain: the time of a product in ecdsa_mul's chains.
#include "field.cuh"

// ---------------------------------------------------------------------------
// Candidate 0: CIOS (coarsely integrated operand scanning) in plain C with
// 64-bit partial sums, the product every kernel used before the carry-flag
// one.  Each inner step is one 32x32->64 multiply-add that waits for the step
// before it: 128 of them in one serial carry chain.  (2^32-1)^2 + 2(2^32-1) =
// 2^64-1, so a step never overflows.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mont_mul_cios(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                              const uint32_t b[ACVM_LIMBS], const Field& f,
                                              bool reduce = true) {
    uint32_t t[ACVM_LIMBS + 2];
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS + 2; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        uint64_t c = 0;
        const uint32_t bi = b[i];
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) {
            uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[ACVM_LIMBS] + c;
        t[ACVM_LIMBS] = (uint32_t)s;
        t[ACVM_LIMBS + 1] = (uint32_t)(s >> 32);

        const uint32_t m = t[0] * f.n0;
        s = (uint64_t)m * f.p[0] + t[0];
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < ACVM_LIMBS; ++j) {
            s = (uint64_t)m * f.p[j] + t[j] + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[ACVM_LIMBS] + c;
        t[ACVM_LIMBS - 1] = (uint32_t)s;
        t[ACVM_LIMBS] = t[ACVM_LIMBS + 1] + (uint32_t)(s >> 32);
    }
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) r[i] = t[i];
    if (reduce) cond_sub(r, f);
}

// ---------------------------------------------------------------------------
// Candidate 2: the unreduced product, then one reduction of the 16 limbs.
// ---------------------------------------------------------------------------

// acc (16 limbs) += a * b, the full 512-bit product.  The even/odd tiling of
// field.cuh's product without the reduction rows: row i adds the even limbs of a
// times b[i] on positions i.., the odd limbs one higher, each into the
// accumulator whose parity matches, and each chain's top limb is one no
// earlier row has touched, so no carry ripples further.  The caller keeps the
// sum below 2^512.
__device__ __forceinline__ void mad_wide(uint32_t acc[2 * ACVM_LIMBS],
                                         const uint32_t a[ACVM_LIMBS],
                                         const uint32_t b[ACVM_LIMBS]) {
    uint32_t ev[16], od[16];   // positions 0..15 and 1..16
#pragma unroll
    for (int k = 0; k < 16; ++k) ev[k] = od[k] = 0;
    mad_even(ev, a, b[0]);
    mad_even(od, a + 1, b[0]);
#pragma unroll
    for (int i = 1; i < ACVM_LIMBS; i += 2) {
        mad_even_top(od + (i - 1), od[i + 7], a, b[i]);       // odd row: even limbs -> od
        mad_even(ev + (i + 1), a + 1, b[i]);                  //          odd limbs  -> ev
        if (i + 1 < ACVM_LIMBS) {
            mad_even_top(ev + (i + 1), ev[i + 9], a, b[i + 1]);   // even row
            mad_even(od + (i + 1), a + 1, b[i + 1]);
        }
    }
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const uint64_t sum = (uint64_t)acc[k] + ev[k] + (k ? od[k - 1] : 0u) + carry;
        acc[k] = (uint32_t)sum;
        carry = (uint32_t)(sum >> 32);
    }
}

// One row of the Montgomery reduction of a 16-limb value: t[0..8] += m * p
// with m making t[0] zero, as a chain of high halves and a chain of low
// halves.  `extra` (0..2) is what the row before left to be added on limb 8;
// on exit it is what this row leaves for limb 9.
__device__ __forceinline__ void redc_row(uint32_t* t, uint32_t& extra, const Field& f) {
    const uint32_t m = t[0] * f.n0;
    uint32_t c1, c2;
    asm("mad.hi.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "=r"(c2)
        : "r"(m), "r"(f.p[0]), "r"(f.p[1]), "r"(f.p[2]), "r"(f.p[3]),
          "r"(f.p[4]), "r"(f.p[5]), "r"(f.p[6]), "r"(f.p[7]));
    asm("mad.lo.cc.u32 %0, %10, %11, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
        "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, %19;\n\t"
        "addc.u32 %9, 0, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "=r"(c1)
        : "r"(m), "r"(f.p[0]), "r"(f.p[1]), "r"(f.p[2]), "r"(f.p[3]),
          "r"(f.p[4]), "r"(f.p[5]), "r"(f.p[6]), "r"(f.p[7]), "r"(extra));
    extra = c1 + c2;
}

// r = t * R^-1 mod p for a 16-limb t < p * R (a sum of at most floor(R / p)
// products of canonical elements): r < 2p before the conditional subtract,
// canonical after it.  t is consumed.
__device__ __forceinline__ void redc_wide(uint32_t r[ACVM_LIMBS], uint32_t t[2 * ACVM_LIMBS],
                                          const Field& f) {
    uint32_t extra = 0;
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) redc_row(t + i, extra, f);
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) r[i] = t[ACVM_LIMBS + i];
    cond_sub(r, f);
}

template <int VARIANT>
__global__ void mont_probe_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out, long long n, int chain,
                                  const Field f) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS];
    load_fe(x, a + i * ACVM_LIMBS);
    load_fe(y, b + i * ACVM_LIMBS);
#pragma unroll 1
    for (int k = 0; k < chain; ++k) {
        if (VARIANT == 0) {
            mont_mul_cios(x, x, y, f);
        } else if (VARIANT == 1) {
            mont_mul(x, x, y, f);
        } else {
            uint32_t t[2 * ACVM_LIMBS];
#pragma unroll
            for (int j = 0; j < 2 * ACVM_LIMBS; ++j) t[j] = 0;
            mad_wide(t, x, y);
            redc_wide(x, t, f);
        }
    }
    store_fe(out + i * ACVM_LIMBS, x);
}

// ---------------------------------------------------------------------------
// Variant 3: the wide product (field.cuh's mont_mul over a WideField) in the
// same chain, x = x * b[i].
__global__ void mont_probe_wide_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                       uint32_t* __restrict__ out, long long n, int chain,
                                       const WideField f) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS];
    load_fe(x, a + i * ACVM_LIMBS);
    load_fe(y, b + i * ACVM_LIMBS);
#pragma unroll 1
    for (int k = 0; k < chain; ++k) mont_mul(x, x, y, f);
    store_fe(out + i * ACVM_LIMBS, x);
}

extern "C" int acvm_mont_probe(const void* a, const void* b, void* out, long long n, int chain,
                               int variant, int threads, const uint32_t* field_words,
                               void* stream) {
    if (n <= 0 || threads <= 0 || variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    const uint32_t *pa = (const uint32_t*)a, *pb = (const uint32_t*)b;
    uint32_t* po = (uint32_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (variant == 3) {
        mont_probe_wide_kernel<<<blocks, threads, 0, s>>>(pa, pb, po, n, chain,
                                                         field_from_words_as<WideField>(field_words));
        return (int)cudaGetLastError();
    }
    const Field f = field_from_words(field_words);
    if (variant == 0) mont_probe_kernel<0><<<blocks, threads, 0, s>>>(pa, pb, po, n, chain, f);
    if (variant == 1) mont_probe_kernel<1><<<blocks, threads, 0, s>>>(pa, pb, po, n, chain, f);
    if (variant == 2) mont_probe_kernel<2><<<blocks, threads, 0, s>>>(pa, pb, po, n, chain, f);
    return (int)cudaGetLastError();
}
