// Euclidean division of 256-bit integers: q = a / b, r = a mod b for every
// element of two contiguous (n, 8) limb panels; q = r = 0 where b = 0 (the
// Quotient directive's convention).  Only bits below `num_bits` of a are read.
//
// Replaces the JAX package's `tpu/intops.py::long_divmod`, a `fori_loop` of
// num_bits restoring-division steps over the whole panel that XLA runs as one
// loop on the TPU.  The port's plain version keeps that loop (some 20 tensor
// ops a bit); this kernel does word-level long division instead, one thread an
// element, in registers from load to store.
//
// The algorithm is Knuth's Algorithm D (TAOCP vol. 2, 4.3.1) in base 2^32, as
// Hacker's Delight's `divmnu` writes it.  With m and n the lengths of a and b
// in 32-bit words: a shorter than b gives (0, a); b is shifted left until its
// top bit is set (s = clz of its top word, a by the same s into a ninth
// word), then each of the m - n + 1 quotient digits is estimated from the top
// two words of the running remainder over b's top word, corrected by b's
// second word (at most twice), multiplied back and subtracted over n + 1
// words, and added back in the rare case the subtraction borrowed (about
// 2 / 2^32 of random digits); n = 1 is one 2-by-1 division for each of a's
// m words.  An equal length a < b needs no case of its own: its one digit
// comes out 0.  Shifts
// are funnel shifts (`shf`), so s = 0 needs no case either (C's x >> 32 is
// undefined).
//
// Registers, not local memory: every array index is static.  The digit loop
// is a template on n (one body for each n = 2..8, picked once per thread) and
// runs over the fixed positions j = 8 - n .. 0, skipping those above m - n,
// so u[j + i] names a register.  The card has no integer divider: a 2-by-1
// division is C's 64-bit `/`, which nvcc makes a short software routine, one
// call a digit.  A reciprocal of the divisor's top word made once a thread
// (Moller and Granlund's 2-by-1 division) takes fewer instructions a digit
// but measured slower at both timed shapes (PERF.md, row 10), and is not used.
//
// Bound: 128 bytes an element (a, b in; q, r out) against the operations the
// data needs: per digit n multiply-adds and n + 1 subtractions for q^ b, and
// 3 operations for the estimate (the least a 2-by-1 division takes: one full
// and one low product by a reciprocal), 2n + 4 in all, plus the m + n + n
// words shifted.  The Quotient's dividends (below 2^64 but for a few) over
// 2^32 are one digit, 14 operations; 256-bit dividends over 128-bit divisors
// 5 digits, 76: the bytes bound both (PERF.md, row 10).
#include "divmod.cuh"

__global__ void divmod_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ q, uint32_t* __restrict__ r, long long n,
                              int num_bits) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS];
    uint32_t quo[ACVM_LIMBS] = {0, 0, 0, 0, 0, 0, 0, 0};
    load_fe(x, a + i * ACVM_LIMBS);
    load_fe(y, b + i * ACVM_LIMBS);
    int m = 0, len = 0;                       // words of a and of b
    uint32_t ytop = 0;                        // b's top word
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) {
        const int keep = num_bits - 32 * j;  // the bits of a below num_bits
        x[j] = keep >= 32 ? x[j] : (keep <= 0 ? 0u : x[j] & ((1u << keep) - 1u));
        m = x[j] ? j + 1 : m;
        len = y[j] ? j + 1 : len;
        ytop = y[j] ? y[j] : ytop;
    }
    if (len == 0 || m < len) {  // b = 0: (0, 0); a shorter than b: (0, a)
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) x[j] = len ? x[j] : 0u;
        store_fe(q + i * ACVM_LIMBS, quo);
        store_fe(r + i * ACVM_LIMBS, x);
        return;
    }
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
    if (len == 1) {  // one 2-by-1 division a word of a, from the top
        // u[m] < 2^s <= v[0]: the remainder starts there, and its digit is 0.
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
#pragma unroll
        for (int j = 1; j <= ACVM_LIMBS; ++j) u[j] = 0;
        u[0] = rem;
    } else {
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
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) x[j] = __funnelshift_r(u[j], u[j + 1], s);  // r = u >> s
    store_fe(q + i * ACVM_LIMBS, quo);
    store_fe(r + i * ACVM_LIMBS, x);
}

extern "C" int acvm_divmod(const void* a, const void* b, void* q, void* r, long long n,
                           int num_bits, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    divmod_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)q, (uint32_t*)r, n, num_bits);
    return (int)cudaGetLastError();
}
