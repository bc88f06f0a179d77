// Prime-field arithmetic for one thread: a field element is 8 little-endian
// 32-bit limbs held in registers, Montgomery form with R = 2^256.
//
// The field (modulus, R mod p, -p^-1 mod 2^32) travels as a kernel argument,
// so it sits in the constant bank and every limb of p is an immediate-like
// operand after unrolling.  Works for any odd modulus p with 2p < 2^256
// (BN254 Fr and BLS12-381 Fr).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ACVM_LIMBS 8

struct Field {
    uint32_t p[ACVM_LIMBS];   // modulus
    uint32_t r[ACVM_LIMBS];   // R mod p: the Montgomery form of 1
    uint32_t n0;              // -p^-1 mod 2^32
};

// Host side: the wrapper passes 17 words [p | r | n0].
static inline Field field_from_words(const uint32_t* w) {
    Field f;
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        f.p[i] = w[i];
        f.r[i] = w[ACVM_LIMBS + i];
    }
    f.n0 = w[2 * ACVM_LIMBS];
    return f;
}

// Two 16-byte loads / stores per element (elements are 32-byte aligned).
__device__ __forceinline__ void load_fe(uint32_t x[ACVM_LIMBS], const uint32_t* src) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4 lo = s[0], hi = s[1];
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void store_fe(uint32_t* dst, const uint32_t x[ACVM_LIMBS]) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(x[0], x[1], x[2], x[3]);
    d[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ bool is_zero(const uint32_t x[ACVM_LIMBS]) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) acc |= x[i];
    return acc == 0;
}

// x -= p when x >= p.  x < 2p < 2^256 on entry, canonical on exit.
__device__ __forceinline__ void cond_sub(uint32_t x[ACVM_LIMBS], const Field& f) {
    uint32_t d[ACVM_LIMBS];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        uint64_t s = (uint64_t)x[i] - f.p[i] - borrow;
        d[i] = (uint32_t)s;
        borrow = (uint32_t)(s >> 63);
    }
    if (!borrow) {
#pragma unroll
        for (int i = 0; i < ACVM_LIMBS; ++i) x[i] = d[i];
    }
}

// r = a + b mod p for canonical a, b.  a + b < 2p < 2^256: no carry out.
__device__ __forceinline__ void add_mod(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                        const uint32_t b[ACVM_LIMBS], const Field& f) {
    uint32_t carry = 0;
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        uint64_t s = (uint64_t)a[i] + b[i] + carry;
        r[i] = (uint32_t)s;
        carry = (uint32_t)(s >> 32);
    }
    cond_sub(r, f);
}

// r = a - b mod p for canonical a, b.
__device__ __forceinline__ void sub_mod(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                        const uint32_t b[ACVM_LIMBS], const Field& f) {
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        uint64_t s = (uint64_t)a[i] - b[i] - borrow;
        r[i] = (uint32_t)s;
        borrow = (uint32_t)(s >> 63);
    }
    if (borrow) {
        uint32_t carry = 0;
#pragma unroll
        for (int i = 0; i < ACVM_LIMBS; ++i) {
            uint64_t s = (uint64_t)r[i] + f.p[i] + carry;
            r[i] = (uint32_t)s;
            carry = (uint32_t)(s >> 32);
        }
    }
}

// Montgomery product a * b * R^-1, CIOS (coarsely integrated operand
// scanning) over 32-bit limbs with 64-bit partial sums.  Each inner step is
// one 32x32->64 multiply-add: (2^32-1)^2 + 2(2^32-1) = 2^64-1, so the sum
// never overflows.  For a * b < p * R (true whenever a, b < p, and for
// a < 2p, b < p) the result is < 2p < 2^256 and the ninth word ends as zero.
// `reduce` adds the conditional subtract that makes it canonical.
// r may alias a or b.
__device__ __forceinline__ void mont_mul(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
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
