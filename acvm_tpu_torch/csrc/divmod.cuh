// The word-level long division of one thread, shared by `divmod` and the
// Brillig VM (`brillig_vm.cu`): Knuth's Algorithm D in base 2^32 over 8-word
// operands, as `divmod.cu`'s note describes.  The caller normalises (shifts
// the divisor until its top bit is set) and handles the one-word divisor.
#pragma once

#include "field.cuh"

// (hi 2^32 + lo) / d for hi < d: the quotient word, and the remainder in r.
__device__ __forceinline__ uint32_t div_2by1(uint32_t hi, uint32_t lo, uint32_t d, uint32_t& r) {
    const uint32_t q = (uint32_t)((((uint64_t)hi << 32) | lo) / d);
    r = lo - q * d;
    return q;
}

// Algorithm D for a divisor v of N >= 2 words, normalised: u (a << s, 9
// words, m of them before the shift) becomes the remainder << s, q the
// quotient.
template <int N>
__device__ __forceinline__ void long_division(uint32_t u[ACVM_LIMBS + 1], const uint32_t v[ACVM_LIMBS],
                                              int m, uint32_t q[ACVM_LIMBS]) {
    const uint32_t d1 = v[N - 1], d0 = v[N - 2];
#pragma unroll
    for (int j = ACVM_LIMBS - N; j >= 0; --j) {
        if (j > m - N) continue;  // the remainder's window is above a: digit 0
        const uint32_t u2 = u[j + N], u1 = u[j + N - 1], u0 = u[j + N - 2];
        // The estimate, u2 <= d1 always: u2 = d1 would give 2^32 or more.
        uint32_t qhat, rhat;
        bool rhat_wide;  // rhat >= 2^32: the test below cannot hold
        if (u2 == d1) {
            qhat = 0xFFFFFFFFu;
            rhat = u1 + d1;
            rhat_wide = rhat < d1;
        } else {
            qhat = div_2by1(u2, u1, d1, rhat);
            rhat_wide = false;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // qhat (d1 2^32 + d0) > u2 2^64 + u1 2^32 + u0
            if (rhat_wide || (uint64_t)qhat * d0 <= (((uint64_t)rhat << 32) | u0)) break;
            --qhat;
            rhat += d1;
            rhat_wide = rhat < d1;
        }
        // u[j .. j + N] -= qhat v: the product's high word and the borrow in one carry word.
        uint32_t k = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const uint64_t p = (uint64_t)qhat * v[i] + k;
            const uint32_t w = u[j + i], lo = (uint32_t)p;
            u[j + i] = w - lo;
            k = (uint32_t)(p >> 32) + (w < lo ? 1u : 0u);
        }
        const uint32_t top = u[j + N];
        u[j + N] = top - k;
        if (top < k) {  // qhat was one too large: add v back
            --qhat;
            uint32_t c = 0;
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const uint64_t t = (uint64_t)u[j + i] + v[i] + c;
                u[j + i] = (uint32_t)t;
                c = (uint32_t)(t >> 32);
            }
            u[j + N] += c;
        }
        q[j] = qhat;
    }
}
