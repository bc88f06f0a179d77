// Prime-field arithmetic for one thread: a field element is 8 little-endian
// 32-bit limbs held in registers, Montgomery form with R = 2^256.
//
// The field (modulus, R mod p, -p^-1 mod 2^32) travels as a kernel argument,
// so it sits in the constant bank and every limb of p is an immediate-like
// operand after unrolling.
//
// Two modes, two types, so that a kernel states at compile time which one it
// runs and no value of one type converts to the other:
//
// * `Field`: any odd modulus p with 2p < 2^256 (BN254 Fr and BLS12-381 Fr).
//   A sum of two elements and a product's running sum fit eight limbs.
// * `WideField`: 2^255 < p < 2^256 (the base fields and the group orders of
//   secp256k1 and secp256r1).  a + b may carry out of limb 7, and so may the
//   product's running sum: the modular add and the product keep that carry
//   as a ninth word and hand it to the conditional subtract.  `mont_mul_sum`
//   has no wide form ((T + 1) p < 2^256 holds for no T).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ACVM_LIMBS 8

struct Field {
    static constexpr bool wide = false;
    uint32_t p[ACVM_LIMBS];   // modulus
    uint32_t r[ACVM_LIMBS];   // R mod p: the Montgomery form of 1
    uint32_t n0;              // -p^-1 mod 2^32
};

struct WideField {
    static constexpr bool wide = true;
    uint32_t p[ACVM_LIMBS];
    uint32_t r[ACVM_LIMBS];
    uint32_t n0;
};

// Host side: the wrapper passes 17 words [p | r | n0].
template <class F>
static inline F field_from_words_as(const uint32_t* w) {
    F f;
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        f.p[i] = w[i];
        f.r[i] = w[ACVM_LIMBS + i];
    }
    f.n0 = w[2 * ACVM_LIMBS];
    return f;
}

static inline Field field_from_words(const uint32_t* w) { return field_from_words_as<Field>(w); }

// The field type of a source built in both modes (mul, pow, batch_inv):
// `-DACVM_WIDE` selects the wide one.
#ifdef ACVM_WIDE
typedef WideField KernelField;
#else
typedef Field KernelField;
#endif

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

// Eight-limb add and subtract as one carry-flag chain each (add.cc / addc.cc,
// sub.cc / subc.cc): eight operations, where 64-bit sums in C cost three a
// limb.  `carry` / `borrow` is the bit that leaves the top limb, 0 or 1.
__device__ __forceinline__ uint32_t add_limbs(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                              const uint32_t b[ACVM_LIMBS]) {
    uint32_t r0, r1, r2, r3, r4, r5, r6, r7, carry;
    asm("add.cc.u32 %0, %9, %17;\n\t"
        "addc.cc.u32 %1, %10, %18;\n\t"
        "addc.cc.u32 %2, %11, %19;\n\t"
        "addc.cc.u32 %3, %12, %20;\n\t"
        "addc.cc.u32 %4, %13, %21;\n\t"
        "addc.cc.u32 %5, %14, %22;\n\t"
        "addc.cc.u32 %6, %15, %23;\n\t"
        "addc.cc.u32 %7, %16, %24;\n\t"
        "addc.u32 %8, 0, 0;"
        : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3), "=&r"(r4), "=&r"(r5), "=&r"(r6),
          "=&r"(r7), "=&r"(carry)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
    r[0] = r0; r[1] = r1; r[2] = r2; r[3] = r3; r[4] = r4; r[5] = r5; r[6] = r6; r[7] = r7;
    return carry;
}

__device__ __forceinline__ uint32_t sub_limbs(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                              const uint32_t b[ACVM_LIMBS]) {
#ifndef __CUDACC__
    // A CPU build of a kernel's C (tests/test_torch_hash_c.py): the same
    // borrow chain in plain C, the borrow the sign bit of a 64-bit difference.
    uint32_t borrow = 0;
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        const uint64_t d = (uint64_t)a[i] - b[i] - borrow;
        r[i] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
    }
    return borrow;
#else
    uint32_t r0, r1, r2, r3, r4, r5, r6, r7, borrow;
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, 0, 0;"   // 0 - 0 - borrow: all ones where the chain borrowed
        : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3), "=&r"(r4), "=&r"(r5), "=&r"(r6),
          "=&r"(r7), "=&r"(borrow)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
    r[0] = r0; r[1] = r1; r[2] = r2; r[3] = r3; r[4] = r4; r[5] = r5; r[6] = r6; r[7] = r7;
    return borrow & 1u;
#endif
}

// x -= p when x >= p.  x < 2p < 2^256 on entry, canonical on exit.
__device__ __forceinline__ void cond_sub(uint32_t x[ACVM_LIMBS], const Field& f) {
    uint32_t d[ACVM_LIMBS];
    const uint32_t borrow = sub_limbs(d, x, f.p);
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) x[i] = borrow ? x[i] : d[i];
}

// Wide mode: the value is top * 2^256 + x with top in {0, 1} and the value
// < 2p.  Where top is set the value is >= 2^256 > p, and the difference mod
// 2^256 is the value less p.
__device__ __forceinline__ void cond_sub(uint32_t x[ACVM_LIMBS], uint32_t top,
                                         const WideField& f) {
    uint32_t d[ACVM_LIMBS];
    const uint32_t borrow = sub_limbs(d, x, f.p);
    const bool keep = borrow && !top;
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) x[i] = keep ? x[i] : d[i];
}

// r = a + b mod p for canonical a, b.  a + b < 2p < 2^256: no carry out.
__device__ __forceinline__ void add_mod(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                        const uint32_t b[ACVM_LIMBS], const Field& f) {
    add_limbs(r, a, b);
    cond_sub(r, f);
}

// Wide mode: a + b < 2p may pass 2^256; the carry goes to the subtract.
__device__ __forceinline__ void add_mod(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                        const uint32_t b[ACVM_LIMBS], const WideField& f) {
    const uint32_t carry = add_limbs(r, a, b);
    cond_sub(r, carry, f);
}

// r = a - b mod p for canonical a, b (either mode: the difference plus p
// where it borrowed is < p, and the sum's carry out is the borrow's 2^256).
template <class F>
__device__ __forceinline__ void sub_mod(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                        const uint32_t b[ACVM_LIMBS], const F& f) {
    uint32_t d[ACVM_LIMBS], e[ACVM_LIMBS];
    const uint32_t borrow = sub_limbs(d, a, b);
    add_limbs(e, d, f.p);
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) r[i] = borrow ? e[i] : d[i];
}

// ---------------------------------------------------------------------------
// The Montgomery product: carry-flag chains over even and odd limbs.
//
// A 32x32->64 product of limb a[j] lands on limb positions j and j+1.  The
// products of the EVEN limbs of a (a0, a2, a4, a6) times one word therefore
// tile eight consecutive limbs without overlap, and so do those of the ODD
// limbs one position higher.  Each tiling is one chain of mad.lo.cc /
// madc.hi.cc pairs (one IMAD.WIDE with carry each): four wide multiply-adds
// that wait only on the carry flag, and the two chains of a row do not wait
// on each other at all.  The running sum is kept as two accumulators,
// `even` (limb positions 0..7) and `odd` (positions 1..8), which meet once, at
// the end.  A row costs 16 wide multiply-adds in four short chains, where CIOS
// written in C with 64-bit partial sums (mont_probe.cu keeps it as the
// yardstick) runs 16 in one chain with a 64-bit add between every two.
// ---------------------------------------------------------------------------

// acc[0..7] += (x[0], x[2], x[4], x[6]) * y, four 64-bit products side by side.
// The carry out of the top limb is dropped: the caller knows it is zero.
__device__ __forceinline__ void mad_even(uint32_t acc[8], const uint32_t* x, uint32_t y) {
    asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
        "madc.hi.u32 %7, %11, %12, %7;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7])
        : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// The same, and the carry out of acc[7] is added to `top`.
__device__ __forceinline__ void mad_even_top(uint32_t acc[8], uint32_t& top, const uint32_t* x,
                                             uint32_t y) {
    asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(top)
        : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// The shift of one Montgomery row, fused with the odd chain of the next.  On
// entry `lo` holds limb positions 0..7 with lo[0] == 0 (just reduced) and
// `hi0` is limb 1 of the other accumulator.  Dividing by 2^32 moves lo[1] onto
// hi0 and lo[j + 2] onto position j + 1, which is where the product of the
// odd limb x[j] (x = a + 1) lands: lo becomes the new odd accumulator,
//   lo[j], lo[j + 1] = x[j] * y + lo[j + 2], lo[j + 3]     (j = 0, 2, 4, 6),
// every read of a limb ahead of its overwrite, in one carry chain that starts
// with hi0 += lo[1].  The top product has nothing above it to carry into.
__device__ __forceinline__ void shift_mad_odd(uint32_t& hi0, uint32_t lo[8], const uint32_t* x,
                                              uint32_t y) {
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
        "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
        "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
        "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
        "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
        "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
        "madc.hi.u32 %8, %12, %13, 0;"
        : "+r"(hi0), "+r"(lo[0]), "+r"(lo[1]), "+r"(lo[2]), "+r"(lo[3]),
          "+r"(lo[4]), "+r"(lo[5]), "+r"(lo[6]), "+r"(lo[7])
        : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// One row: (even, odd) <- ((even, odd) / 2^32 + a * bi + m * p) with m chosen
// so that the new even[0] is zero.  The caller swaps the two names each row:
// after the division the old odd accumulator sits on positions 0..7.
template <bool FIRST>
__device__ __forceinline__ void mont_row(uint32_t even[8], uint32_t odd[8],
                                         const uint32_t a[ACVM_LIMBS], uint32_t bi,
                                         const Field& f) {
    if (FIRST) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; j += 2) {
            const uint64_t e = (uint64_t)a[j] * bi, o = (uint64_t)a[j + 1] * bi;
            even[j] = (uint32_t)e;
            even[j + 1] = (uint32_t)(e >> 32);
            odd[j] = (uint32_t)o;
            odd[j + 1] = (uint32_t)(o >> 32);
        }
    } else {
        shift_mad_odd(even[0], odd, a + 1, bi);
        mad_even_top(even, odd[7], a, bi);
    }
    const uint32_t m = even[0] * f.n0;
    mad_even(odd, f.p + 1, m);
    mad_even_top(even, odd[7], f.p, m);
}

// r = even + (odd >> 32): the accumulators of the last row meet.
__device__ __forceinline__ void merge_rows(uint32_t r[ACVM_LIMBS], const uint32_t even[8],
                                           const uint32_t odd[8]) {
    asm("add.cc.u32 %0, %8, %16;\n\t"
        "addc.cc.u32 %1, %9, %17;\n\t"
        "addc.cc.u32 %2, %10, %18;\n\t"
        "addc.cc.u32 %3, %11, %19;\n\t"
        "addc.cc.u32 %4, %12, %20;\n\t"
        "addc.cc.u32 %5, %13, %21;\n\t"
        "addc.cc.u32 %6, %14, %22;\n\t"
        "addc.u32 %7, %15, 0;"
        : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3]),
          "=&r"(r[4]), "=&r"(r[5]), "=&r"(r[6]), "=&r"(r[7])
        : "r"(even[0]), "r"(even[1]), "r"(even[2]), "r"(even[3]),
          "r"(even[4]), "r"(even[5]), "r"(even[6]), "r"(even[7]),
          "r"(odd[1]), "r"(odd[2]), "r"(odd[3]), "r"(odd[4]),
          "r"(odd[5]), "r"(odd[6]), "r"(odd[7]));
}

// Montgomery product a * b * R^-1.  The running sum never passes
// (a + p) * 2^32, so it fits its two accumulators whenever a + p < 2^256: any
// a < p, and a < 2p for BN254.  b may be any 256-bit value; where one operand
// is only known to be < 2p, pass it as b.  For a * b < p * R the result is
// < 2p < 2^256; `reduce` adds the conditional subtract that makes it
// canonical.  r may alias a or b.
__device__ __forceinline__ void mont_mul(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                         const uint32_t b[ACVM_LIMBS], const Field& f,
                                         bool reduce = true) {
    uint32_t even[8], odd[8];
    mont_row<true>(even, odd, a, b[0], f);
    mont_row<false>(odd, even, a, b[1], f);
#pragma unroll
    for (int i = 2; i < ACVM_LIMBS; i += 2) {
        mont_row<false>(even, odd, a, b[i], f);
        mont_row<false>(odd, even, a, b[i + 1], f);
    }
    // The last row ran with the names swapped: `odd` holds positions 0..7.
    merge_rows(r, even, odd);
    if (reduce) cond_sub(r, f);
}

// ---------------------------------------------------------------------------
// The wide product.  The same rows, and one more word: for p > 2^255 the
// running sum (< (a + p) * 2^32 before a row's division) may pass the nine
// limb positions 0..8 of the two accumulators, so a word `top` holds position
// 9.  Every chain that ended at position 8 now carries into it, and the shift
// moves it down to position 8, the top of the new odd accumulator.  The sum is
// < 2^289, so `top` is 0 or 1 and nothing leaves it.
// ---------------------------------------------------------------------------

// mad_even_top, with the carry out of acc_top passed on to `top`.
__device__ __forceinline__ void mad_even_top_w(uint32_t acc[8], uint32_t& acc_top,
                                               uint32_t& top, const uint32_t* x, uint32_t y) {
    asm("mad.lo.cc.u32 %0, %10, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %10, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %12, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, %14, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %14, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %14, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc_top), "+r"(top)
        : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// shift_mad_odd, with position 9 moving down onto the top product's high word
// and that word's carry becoming the new `top`.
__device__ __forceinline__ void shift_mad_odd_w(uint32_t& hi0, uint32_t lo[8], uint32_t& top,
                                                const uint32_t* x, uint32_t y) {
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "madc.lo.cc.u32 %1, %10, %14, %3;\n\t"
        "madc.hi.cc.u32 %2, %10, %14, %4;\n\t"
        "madc.lo.cc.u32 %3, %11, %14, %5;\n\t"
        "madc.hi.cc.u32 %4, %11, %14, %6;\n\t"
        "madc.lo.cc.u32 %5, %12, %14, %7;\n\t"
        "madc.hi.cc.u32 %6, %12, %14, %8;\n\t"
        "madc.lo.cc.u32 %7, %13, %14, 0;\n\t"
        "madc.hi.cc.u32 %8, %13, %14, %9;\n\t"
        "addc.u32 %9, 0, 0;"
        : "+r"(hi0), "+r"(lo[0]), "+r"(lo[1]), "+r"(lo[2]), "+r"(lo[3]),
          "+r"(lo[4]), "+r"(lo[5]), "+r"(lo[6]), "+r"(lo[7]), "+r"(top)
        : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// One wide row: mont_row with `top` threaded through.  The odd chain's carry
// out of position 8 goes to `top`: mad_even_top_w on the odd accumulator with
// `top` as its top word and a zero word, `none`, above that (the bound keeps
// it zero).
template <bool FIRST>
__device__ __forceinline__ void mont_row_w(uint32_t even[8], uint32_t odd[8], uint32_t& top,
                                           const uint32_t a[ACVM_LIMBS], uint32_t bi,
                                           const WideField& f) {
    if (FIRST) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; j += 2) {
            const uint64_t e = (uint64_t)a[j] * bi, o = (uint64_t)a[j + 1] * bi;
            even[j] = (uint32_t)e;
            even[j + 1] = (uint32_t)(e >> 32);
            odd[j] = (uint32_t)o;
            odd[j + 1] = (uint32_t)(o >> 32);
        }
        top = 0;
    } else {
        shift_mad_odd_w(even[0], odd, top, a + 1, bi);
        mad_even_top_w(even, odd[7], top, a, bi);
    }
    const uint32_t m = even[0] * f.n0;
    uint32_t none = 0;
    mad_even_top_w(odd, top, none, f.p + 1, m);
    mad_even_top_w(even, odd[7], top, f.p, m);
}

// Montgomery product a * b * R^-1 over a wide field, canonical: any a < p and
// any 256-bit b give a result < a + p < 2p, which the conditional subtract
// (with the ninth word) brings below p.  r may alias a or b.
__device__ __forceinline__ void mont_mul(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                         const uint32_t b[ACVM_LIMBS], const WideField& f) {
    uint32_t even[8], odd[8], top;
    mont_row_w<true>(even, odd, top, a, b[0], f);
    mont_row_w<false>(odd, even, top, a, b[1], f);
#pragma unroll
    for (int i = 2; i < ACVM_LIMBS; i += 2) {
        mont_row_w<false>(even, odd, top, a, b[i], f);
        mont_row_w<false>(odd, even, top, a, b[i + 1], f);
    }
    // r, r8 = even + (odd >> 32) + top * 2^256.
    uint32_t r8;
    asm("add.cc.u32 %0, %9, %17;\n\t"
        "addc.cc.u32 %1, %10, %18;\n\t"
        "addc.cc.u32 %2, %11, %19;\n\t"
        "addc.cc.u32 %3, %12, %20;\n\t"
        "addc.cc.u32 %4, %13, %21;\n\t"
        "addc.cc.u32 %5, %14, %22;\n\t"
        "addc.cc.u32 %6, %15, %23;\n\t"
        "addc.cc.u32 %7, %16, 0;\n\t"
        "addc.u32 %8, %24, 0;"
        : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3]),
          "=&r"(r[4]), "=&r"(r[5]), "=&r"(r[6]), "=&r"(r[7]), "=&r"(r8)
        : "r"(even[0]), "r"(even[1]), "r"(even[2]), "r"(even[3]),
          "r"(even[4]), "r"(even[5]), "r"(even[6]), "r"(even[7]),
          "r"(odd[1]), "r"(odd[2]), "r"(odd[3]), "r"(odd[4]),
          "r"(odd[5]), "r"(odd[6]), "r"(odd[7]), "r"(top));
    cond_sub(r, r8, f);
}

// r = (sum over the terms t in LIVE of a[t] * b[t]) * R^-1: a sum of products
// with ONE reduction.  Each row adds every live term's a[t] * b[t][i] to the
// accumulators before the single m * p that clears the low limb, so T terms
// cost 64 T + 64 wide multiply-adds where T separate products cost 128 T (and
// T conditional subtracts and modular adds).  Bit t of LIVE says that term t
// takes part; it is a template argument, so the rows are straight-line code.
// a[t] are register arrays of canonical elements, b[t] may point anywhere
// (one word is read a row).  The running sum stays below (T p + p) * 2^32, so
// the caller must keep (T + 1) * p < 2^256 for the live count T; then the
// result is < 2p before the conditional subtract and canonical after it.
// The lowest live term carries the division by 2^32 in its odd chain.
template <int TERMS, uint32_t LIVE>
__device__ __forceinline__ void mont_mul_sum(uint32_t r[ACVM_LIMBS],
                                             const uint32_t* const (&a)[TERMS],
                                             const uint32_t* const (&b)[TERMS], const Field& f) {
    static_assert(LIVE != 0 && LIVE < (1u << TERMS), "at least one live term");
    uint32_t acc[2][8];   // the even and the odd accumulator, swapping each row
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[0][j] = acc[1][j] = 0;
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        uint32_t* even = acc[i & 1];
        uint32_t* odd = acc[(i & 1) ^ 1];
        bool shifted = (i == 0);   // nothing to divide before the first row
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
            if (!(LIVE & (1u << t))) continue;
            const uint32_t bt = b[t][i];
            if (shifted) mad_even(odd, a[t] + 1, bt);
            else shift_mad_odd(even[0], odd, a[t] + 1, bt);
            shifted = true;
            mad_even_top(even, odd[7], a[t], bt);
        }
        const uint32_t m = even[0] * f.n0;
        mad_even(odd, f.p + 1, m);
        mad_even_top(even, odd[7], f.p, m);
    }
    // Eight rows: the names are back where they started, and the last row
    // left positions 0..7 in acc[1].
    merge_rows(r, acc[0], acc[1]);
    cond_sub(r, f);
}

// The same for a mask known only at run time (the same for the whole warp):
// one branch to the instance compiled for it.  live == 0 leaves r untouched.
template <int TERMS, uint32_t LIVE = 1>
__device__ __forceinline__ void mont_mul_sum_of(uint32_t r[ACVM_LIMBS],
                                                const uint32_t* const (&a)[TERMS],
                                                const uint32_t* const (&b)[TERMS], uint32_t live,
                                                const Field& f) {
    if (live == LIVE) {
        mont_mul_sum<TERMS, LIVE>(r, a, b, f);
    } else if constexpr (LIVE + 1 < (1u << TERMS)) {
        mont_mul_sum_of<TERMS, LIVE + 1>(r, a, b, live, f);
    }
}
