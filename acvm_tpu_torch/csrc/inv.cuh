// The field inverse of one thread by constant-time divsteps (Bernstein and
// Yang, "Fast constant-time gcd computation and modular inversion", 2019), in
// the form of libsecp256k1's `modinv32` (its doc/safegcd_implementation.md):
// out = a^-1 R for a canonical a R, and 0 for 0.
//
// Where a Fermat chain (`pow.cuh`) runs ~319 dependent 256-bit Montgomery
// products, this runs 600 divsteps on 32-bit words and 20 updates of 9-limb
// values.  A divstep acts on the low bits of f and g only; 30 of them at a
// time build a 2x2 transition matrix t (entries in [-2^30, 2^30]), and
// t [f, g] / 2^30 and t [d, e] / 2^30 mod M then advance the full values.
//
// Values are 9 signed 30-bit limbs (270 bits): limbs 0-7 in [0, 2^30), the
// top limb signed, so a 256-bit modulus and every intermediate fits.  The
// invariants are f = d x / e0 and g = e x / e0 (mod M), from f = M, g = x,
// d = 0, e = e0.  When g reaches 0, f = +-gcd = +-1 and d = +-e0 / x.  With
// e0 = R^2 mod M and x = a R, d = +-R / a = +-a^-1 R: the Montgomery form
// costs nothing.  x = 0 keeps g = 0 and d = 0 throughout, so 0 maps to 0.
//
// Bound on the steps: every lane runs 20 batches of 30 = 600 divsteps, as
// `modinv32` does, so a warp never diverges.  libsecp256k1's
// doc/safegcd_implementation.md (the section on the number of iterations)
// gives 590 divsteps as sufficient for inputs below 2^256 with delta starting
// at 1/2, a bound computed by a convex-hull search over the divstep matrices
// (Bernstein and Yang's own Theorem 11.2 gives (49 d + 57) / 17 = 741 for
// d = 256 bits).  Past that point g is 0 and the remaining divsteps leave f and
// d unchanged, so running more is harmless.
//
// d and e stay in (-2M, M), as in libsecp256k1: each update adds the multiple
// of M (from M^-1 mod 2^30) that makes t [d, e] divisible by 2^30, plus M
// times the entries of t where d or e is negative.
//
// Plain C++ on int32_t / int64_t, no inline PTX: a CPU build of the kernel
// (tests/test_torch_inv_c.py) compiles this header with g++.  Signed right
// shifts are arithmetic (sign-extending) in both compilers.  Every 64-bit
// product is of two 32-bit values (one IMAD.WIDE each on the card).
#pragma once

#include <cstdint>

#define INV_LIMBS 9
#define INV_BATCHES 20  // batches of 30 divsteps: 600 in all
#define INV_M30 0x3FFFFFFF

// The field's constants, from the host (fields/kernels.py::inv_constants):
// M and e0 = R^2 mod M in signed 30-bit limbs, and M^-1 mod 2^30.
struct InvConstants {
    int32_t m[INV_LIMBS];
    int32_t r2[INV_LIMBS];
    uint32_t m_inv30;
};

// 30 divsteps on the low bits of f and g (f odd).  Returns the new zeta
// (zeta = -(delta + 1/2)) and the transition matrix [u v; q r], which maps
// [f, g] to 2^30 [f', g'].  Branch-free: every condition is a mask.  The
// entries live in uint32_t because they are shifted left while negative;
// their values stay in [-2^30, 2^30], so the cast to int32_t is exact.
__host__ __device__ __forceinline__ int32_t inv_divsteps_30(int32_t zeta, uint32_t f, uint32_t g,
                                                            int32_t t[4]) {
    uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
    for (int i = 0; i < 30; ++i) {
        uint32_t c1 = (uint32_t)(zeta >> 31);   // zeta < 0
        const uint32_t c2 = 0u - (g & 1u);       // g odd
        const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
        g += x & c2;                              // g odd: g += f, or g -= f where zeta < 0
        q += y & c2;
        r += z & c2;
        c1 &= c2;                                 // both: swap (f, g) by f += g below
        zeta = (zeta ^ (int32_t)c1) - 1;          // -zeta - 2 where swapped, else zeta - 1
        f += g & c1;
        u += q & c1;
        v += r & c1;
        g >>= 1;
        u <<= 1;
        v <<= 1;
    }
    t[0] = (int32_t)u;
    t[1] = (int32_t)v;
    t[2] = (int32_t)q;
    t[3] = (int32_t)r;
    return zeta;
}

// [f, g] = t [f, g] / 2^30, exactly (the low 30 bits of both products are 0).
__host__ __device__ __forceinline__ void inv_update_fg(int32_t f[INV_LIMBS], int32_t g[INV_LIMBS],
                                                       const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
    int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < INV_LIMBS; ++i) {
        cf += (int64_t)u * f[i] + (int64_t)v * g[i];
        cg += (int64_t)q * f[i] + (int64_t)r * g[i];
        f[i - 1] = (int32_t)cf & INV_M30;
        g[i - 1] = (int32_t)cg & INV_M30;
        cf >>= 30;
        cg >>= 30;
    }
    f[INV_LIMBS - 1] = (int32_t)cf;
    g[INV_LIMBS - 1] = (int32_t)cg;
}

// [d, e] = (t [d, e] + M [md, me]) / 2^30, with md, me chosen so that the
// division is exact and the results stay in (-2M, M): t's entries where d or e
// is negative, less the residue that clears the low 30 bits.
__host__ __device__ __forceinline__ void inv_update_de(int32_t d[INV_LIMBS], int32_t e[INV_LIMBS],
                                                       const int32_t t[4], const InvConstants& c) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    const int32_t sd = d[INV_LIMBS - 1] >> 31, se = e[INV_LIMBS - 1] >> 31;
    int32_t md = (u & sd) + (v & se);
    int32_t me = (q & sd) + (r & se);
    int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
    int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
    md -= (int32_t)((c.m_inv30 * (uint32_t)cd + (uint32_t)md) & INV_M30);
    me -= (int32_t)((c.m_inv30 * (uint32_t)ce + (uint32_t)me) & INV_M30);
    cd += (int64_t)c.m[0] * md;
    ce += (int64_t)c.m[0] * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < INV_LIMBS; ++i) {
        cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)c.m[i] * md;
        ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)c.m[i] * me;
        d[i - 1] = (int32_t)cd & INV_M30;
        e[i - 1] = (int32_t)ce & INV_M30;
        cd >>= 30;
        ce >>= 30;
    }
    d[INV_LIMBS - 1] = (int32_t)cd;
    e[INV_LIMBS - 1] = (int32_t)ce;
}

// r in (-2M, M) -> r (negated where `sign` < 0) in [0, M): add M if negative,
// negate if asked, carry; add M again if still negative, carry.
__host__ __device__ __forceinline__ void inv_normalize(int32_t r[INV_LIMBS], int32_t sign,
                                                       const InvConstants& c) {
    int32_t add = r[INV_LIMBS - 1] >> 31;
    const int32_t neg = sign >> 31;
#pragma unroll
    for (int i = 0; i < INV_LIMBS; ++i) r[i] = ((r[i] + (c.m[i] & add)) ^ neg) - neg;
#pragma unroll
    for (int i = 0; i < INV_LIMBS - 1; ++i) {
        r[i + 1] += r[i] >> 30;
        r[i] &= INV_M30;
    }
    add = r[INV_LIMBS - 1] >> 31;
#pragma unroll
    for (int i = 0; i < INV_LIMBS; ++i) r[i] += c.m[i] & add;
#pragma unroll
    for (int i = 0; i < INV_LIMBS - 1; ++i) {
        r[i + 1] += r[i] >> 30;
        r[i] &= INV_M30;
    }
}

// out = a^-1 R mod M for a canonical a R (8 little-endian 32-bit limbs), 0 for
// 0.  out may alias a.
__host__ __device__ __forceinline__ void inv_divsteps(uint32_t out[8], const uint32_t a[8],
                                                      const InvConstants& c) {
    int32_t f[INV_LIMBS], g[INV_LIMBS], d[INV_LIMBS], e[INV_LIMBS];
#pragma unroll
    for (int i = 0; i < INV_LIMBS; ++i) {
        // limb i: bits 30 i ... 30 i + 29 of a
        const int w = (30 * i) >> 5, s = (30 * i) & 31;
        uint32_t bits = a[w] >> s;
        if (s > 2 && w + 1 < 8) bits |= a[w + 1] << (32 - s);
        g[i] = (int32_t)(bits & INV_M30);
        f[i] = c.m[i];
        d[i] = 0;
        e[i] = c.r2[i];
    }
    int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
    for (int b = 0; b < INV_BATCHES; ++b) {
        int32_t t[4];
        zeta = inv_divsteps_30(zeta, (uint32_t)f[0], (uint32_t)g[0], t);
        inv_update_de(d, e, t, c);
        inv_update_fg(f, g, t);
    }
    inv_normalize(d, f[INV_LIMBS - 1], c);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        // word k: bits 32 k ... 32 k + 31 of d, from limbs l and l + 1
        // (s <= 14, so the two give at least 46 bits)
        const int l = (32 * k) / 30, s = (32 * k) % 30;
        out[k] = ((uint32_t)d[l] >> s) | ((uint32_t)d[l + 1] << (30 - s));
    }
}
