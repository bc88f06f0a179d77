// The fixed-exponent power chain of one thread, shared by `pow` and
// `batch_inv`: a^e in Montgomery form by a left-to-right sliding window over
// the odd powers a, a^3, ..., a^15.
//
// The schedule is built on the host from the exponent
// (`fields/kernels.py::pow_schedule`) and travels as a kernel argument, in the
// constant bank, so every thread of a launch reads the same window and the
// table lookup never diverges.  The chain starts from the top window's table
// entry (no squarings of R); for BN254's p - 2 it is 10 table products, 252
// squarings and 49 multiplies: 311 products, where 64 fixed 4-bit windows
// started from R take 335.  The table is built as a tree of depth 4 (a^2; a^3, a^4;
// a^5, a^7, a^8; a^9, a^11, a^13, a^15), so the dependent depth of the whole
// chain is about 305 products.
//
// The table of the eight odd powers (256 bytes a thread) lives in local
// memory, indexed by the schedule's entries.  On an H100 it was as fast as a
// table in shared memory laid out [entry][limb][thread] and 3-8 % faster than
// one in registers read through selects (PERF.md), so it is the only layout.
#pragma once

#include "field.cuh"

#define ACVM_POW_ENTRIES 8       // a^1, a^3, ..., a^15
#define ACVM_POW_MAX_WINDOWS 64  // a window starts at least 4 bits below the last

struct PowSchedule {
    int first;     // table entry of the top window (a^(2 first + 1)); -1 for e = 0
    int windows;   // windows after the first
    int tail;      // squarings after the last window
    uint32_t op[ACVM_POW_MAX_WINDOWS];   // squarings before window k << 16 | its entry
};

// Host side: the wrapper passes the 3 + 64 words [first | windows | tail | op].
static inline PowSchedule pow_schedule_from_words(const uint32_t* w) {
    PowSchedule s;
    s.first = (int)w[0];
    s.windows = (int)w[1];
    s.tail = (int)w[2];
    for (int k = 0; k < ACVM_POW_MAX_WINDOWS; ++k) s.op[k] = w[3 + k];
    return s;
}

// The threads of a block of `pow`.
#define ACVM_POW_THREADS 128

__device__ __forceinline__ void copy_fe(uint32_t dst[ACVM_LIMBS], const uint32_t src[ACVM_LIMBS]) {
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) dst[j] = src[j];
}

// acc = a^e for the schedule s of e; a canonical, acc canonical, acc != a.
// e = 0 gives R (a^0 = 1) whatever a is: callers that map 0 to 0 mask after.
// F is Field or WideField: the chain is the same, the product is the mode's.
template <class F>
__device__ __forceinline__ void pow_chain(uint32_t acc[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                          const PowSchedule& s, const F& f) {
    if (s.first < 0) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) acc[j] = f.r[j];
        return;
    }
    uint32_t table[ACVM_POW_ENTRIES][ACVM_LIMBS];
    {
        uint32_t a2[ACVM_LIMBS], a3[ACVM_LIMBS], a4[ACVM_LIMBS], a5[ACVM_LIMBS], a7[ACVM_LIMBS],
            a8[ACVM_LIMBS];
        mont_mul(a2, a, a, f);    // depth 1
        mont_mul(a3, a2, a, f);   // depth 2
        mont_mul(a4, a2, a2, f);
        mont_mul(a5, a4, a, f);   // depth 3
        mont_mul(a7, a4, a3, f);
        mont_mul(a8, a4, a4, f);
        copy_fe(table[0], a);
        copy_fe(table[1], a3);
        copy_fe(table[2], a5);
        copy_fe(table[3], a7);
        mont_mul(a2, a8, a, f);   // depth 4: a^9, a^11, a^13, a^15
        copy_fe(table[4], a2);
        mont_mul(a2, a8, a3, f);
        copy_fe(table[5], a2);
        mont_mul(a2, a8, a5, f);
        copy_fe(table[6], a2);
        mont_mul(a2, a8, a7, f);
        copy_fe(table[7], a2);
    }
    copy_fe(acc, table[s.first]);
#pragma unroll 1
    for (int k = 0; k < s.windows; ++k) {
        const uint32_t op = s.op[k];
#pragma unroll 1
        for (uint32_t j = op >> 16; j != 0; --j) mont_mul(acc, acc, acc, f);
        uint32_t y[ACVM_LIMBS];
        copy_fe(y, table[op & 0xFFFFu]);
        mont_mul(acc, acc, y, f);
    }
#pragma unroll 1
    for (int j = s.tail; j != 0; --j) mont_mul(acc, acc, acc, f);
}
