// ECDSA's double-scalar multiplication R = u1 G + u2 Q over secp256k1 (a = 0)
// or secp256r1 (a = -3), one thread a verification, the whole of it in one
// launch.
//
// Replaces acvm_tpu/tpu/ecdsa.py:147-152: `fixed_base_mul` over the
// generator's window table (a gather and a tree of complete additions),
// `scalar_mul`'s scan of 256 double-and-add steps (acvm_tpu/tpu/ec.py:336-375)
// and the final `pt_add`, all of it wide-field limb arithmetic one operation
// at a time.  Here a thread keeps its accumulator (X, Y, Z) in registers and
// runs:
//
//     acc = sum over the 64 windows w of u1 of T[w][d_w]     (u1 G; d_w = 0 adds nothing)
//     park acc in the thread's output slot
//     L[e] = (e + 1) Q for e = 0 .. 7                        (the lane's table)
//     u2 = sum of s_i 16^i, s_i in [-8, 8) for i < 64, s_64 in {0, 1}
//     acc = s_64 ? Q : 0
//     for w = 63 .. 0:  acc = 16 acc;  if (s_w) acc = acc + sign(s_w) L[|s_w| - 1]
//     acc = acc + (the parked u1 G)                           (R)
//
// with T[w][d] = d 2^(4w) G, the reference's table (64 windows x 16 digits x
// 3 x 8 words, 98 KB, read from global memory where it stays in L2 / L1).
//
// What bounds it: each lane's chain of dependent products (about 3,600 on
// secp256k1), at 8,192 verifications 256 warps, under two a SM: the time is
// the longest chain a WARP runs, and a warp runs every branch one of its
// lanes takes.  So u2 Q goes by signed 4-bit windows: every lane doubles at
// each of the 256 bits and adds at the same 64 window steps, so a warp's
// chain is a lane's (a bit-by-bit ladder adds Q at nearly every bit in some
// lane of a warp: 255 x (7 + 11) products where a lane needs about half the
// additions).  The recoding is one addition: the nibbles of u2 + 0x888...8
// less 8 are the digits s_0 .. s_63 and its carry is s_64 (u2 < 2^256, so
// the sum has 257 bits).  A negative digit adds (X, p - Y, Z), which keeps
// Y = 0 at 0.  The lane's table of 1Q ... 8Q is built in the kernel (2Q a
// doubling, 3Q ... 8Q mixed additions of Q, whose Z is one: 73 products, 74
// on secp256r1) and kept in shared memory as [entry][coord][limb][lane],
// 768 B a lane, 24 KB a 32-thread block: a window's 32 lanes read 32
// consecutive words whatever entries they pick.  24 KB is under the 48 KB a
// block may take without opting in; on the H100 nine blocks an SM fit (142
// registers a thread), so the 32,768-lane launch (eight an SM) is not capped
// (an unsigned 15-entry table would take 46 KB a block and cap it at four).
// A product alone in its warp's chain runs at about 80 % of its scheduler's
// multiply-add issue (mont_probe.cu: two independent products side by side
// take 1.9x one), so the formulas keep one product at a time.
//
// The group law is complete, so each edge takes the reference's branch: the
// accumulator at infinity (u1 = 0, u2 = 0, leading zero digits: the first
// nonzero digit loads its entry), P == Q inside an addition (the doubling
// branch; u1 G == u2 Q in the last one) and P == -Q (infinity).  Only the
// affine R is observable (the gadget's output is one bit); X, Y and Z equal
// `ecdsa_mul_plain`'s, which runs this chain one field operation at a time.
#include "ec.cuh"

#define ECDSA_THREADS 32
#define ECDSA_ENTRIES 8                 // 1Q ... 8Q
#define ECDSA_SHARED_BYTES (ECDSA_ENTRIES * 3 * ACVM_LIMBS * ECDSA_THREADS * 4)

// Entry e of this lane's table, coordinate c, limb i at tab[((3 e + c) 8 + i) 32],
// tab pointing at the lane's column.
__device__ __forceinline__ void store_entry(uint32_t* tab, int e, const uint32_t x[ACVM_LIMBS],
                                            const uint32_t y[ACVM_LIMBS],
                                            const uint32_t z[ACVM_LIMBS]) {
    uint32_t* t = tab + e * 3 * ACVM_LIMBS * ECDSA_THREADS;
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        t[i * ECDSA_THREADS] = x[i];
        t[(ACVM_LIMBS + i) * ECDSA_THREADS] = y[i];
        t[(2 * ACVM_LIMBS + i) * ECDSA_THREADS] = z[i];
    }
}

// An entry as ec_add_from reads Q: each coordinate when the formula needs
// it, Y negated (p - Y, and 0 for 0) for a negative digit.
struct LaneEntry {
    const uint32_t* t;   // the entry's X, limb 0, in this lane's column
    bool negate;
    __device__ __forceinline__ void load(uint32_t r[ACVM_LIMBS], int coord) const {
#pragma unroll
        for (int i = 0; i < ACVM_LIMBS; ++i) r[i] = t[(coord * ACVM_LIMBS + i) * ECDSA_THREADS];
    }
    template <class F>
    __device__ __forceinline__ void x(uint32_t r[ACVM_LIMBS], const F&) const { load(r, 0); }
    template <class F>
    __device__ __forceinline__ void y(uint32_t r[ACVM_LIMBS], const F& f) const {
        load(r, 1);
        if (negate) {
            uint32_t zero[ACVM_LIMBS];
#pragma unroll
            for (int i = 0; i < ACVM_LIMBS; ++i) zero[i] = 0;
            sub_mod(r, zero, r, f);
        }
    }
    template <class F>
    __device__ __forceinline__ void z(uint32_t r[ACVM_LIMBS], const F&) const { load(r, 2); }
};

__device__ __forceinline__ LaneEntry lane_entry(const uint32_t* tab, int e, bool negate) {
    return LaneEntry{tab + e * 3 * ACVM_LIMBS * ECDSA_THREADS, negate};
}

template <int A>
__global__ void __launch_bounds__(ECDSA_THREADS)
ecdsa_mul_kernel(const uint32_t* __restrict__ u1, const uint32_t* __restrict__ u2,
                 const uint32_t* __restrict__ q, const uint32_t* __restrict__ table,
                 uint32_t* __restrict__ out, long long B, const WideField f) {
    extern __shared__ uint32_t lane_tables[];
    const long long b = (long long)blockIdx.x * ECDSA_THREADS + threadIdx.x;
    if (b >= B) return;   // no lane reads another's column: no barrier to keep
    uint32_t* tab = lane_tables + threadIdx.x;
    const long long coord = B * ACVM_LIMBS;   // (3, B, 8): X, Y, Z planes
    const uint32_t* qx = q + b * ACVM_LIMBS;
    const uint32_t* qy = qx + coord;
    const uint32_t* k1 = u1 + b * ACVM_LIMBS;
    uint32_t* o = out + b * ACVM_LIMBS;

    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS], z[ACVM_LIMBS];
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) x[i] = y[i] = z[i] = 0;
    // u1 G, window by window.
#pragma unroll 1
    for (int limb = 0; limb < ACVM_LIMBS; ++limb) {
        const uint32_t word = k1[limb];
#pragma unroll 1
        for (int k = 0; k < 8; ++k) {
            const uint32_t d = (word >> (4 * k)) & 15u;
            if (d) {
                const uint32_t* e = table + ((long long)(8 * limb + k) * 16 + d) * 3 * ACVM_LIMBS;
                ec_madd<A>(x, y, z, e, e + ACVM_LIMBS, f);
            }
        }
    }
    store_fe(o, x);
    store_fe(o + coord, y);
    store_fe(o + 2 * coord, z);

    // The lane's table: L[e] = (e + 1) Q.
    load_fe(x, qx);
    load_fe(y, qy);
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) z[i] = f.r[i];
    store_entry(tab, 0, x, y, z);
    ec_dbl<A>(x, y, z, f);
    store_entry(tab, 1, x, y, z);
#pragma unroll 1
    for (int e = 2; e < ECDSA_ENTRIES; ++e) {
        ec_madd<A>(x, y, z, qx, qy, f);
        store_entry(tab, e, x, y, z);
    }

    // The digits: nibble w of k (u2 + 0x888...8) less 8; the carry is the top one.
    uint32_t k[ACVM_LIMBS], eights[ACVM_LIMBS];
    load_fe(k, u2 + b * ACVM_LIMBS);
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) eights[i] = 0x88888888u;
    const uint32_t top = add_limbs(k, k, eights);
    load_fe(x, qx);   // acc = Q where the top digit is 1, else infinity
    load_fe(y, qy);
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) {
        x[i] = top ? x[i] : 0;
        y[i] = top ? y[i] : 0;
        z[i] = top ? f.r[i] : 0;
    }
    // u2 Q, MSB first: k is shifted left a nibble a window, so the window's
    // digit is always the top nibble (no register array indexed at run time).
#pragma unroll 1
    for (int w = 0; w < 64; ++w) {
#pragma unroll 1
        for (int i = 0; i < 4; ++i) ec_dbl<A>(x, y, z, f);
        const int d = (int)(k[ACVM_LIMBS - 1] >> 28) - 8;
#pragma unroll
        for (int i = ACVM_LIMBS - 1; i > 0; --i) k[i] = __funnelshift_l(k[i - 1], k[i], 4);
        k[0] <<= 4;
        if (d) ec_add_from<A>(x, y, z, lane_entry(tab, (d < 0 ? -d : d) - 1, d < 0), f);
    }

    // R = u2 Q + u1 G: u1 G read back from the slot this thread wrote.
    ec_add<A>(x, y, z, o, o + coord, o + 2 * coord, f);
    store_fe(o, x);
    store_fe(o + coord, y);
    store_fe(o + 2 * coord, z);
}

// u1, u2: (B, 8) standard-form scalars (all 256 bits used); q: (3, B, 8)
// Jacobian Montgomery with Z = R mod p (its Z plane is not read); table:
// (64, 16, 3, 8) Montgomery, every entry of a nonzero digit finite with Z = R
// mod p; out: (3, B, 8).  a_minus_3 selects the secp256r1 doubling.
extern "C" int acvm_ecdsa_mul(const void* u1, const void* u2, const void* q, const void* table,
                              void* out, long long B, int a_minus_3,
                              const uint32_t* field_words, void* stream) {
    if (B <= 0) return 0;
    const unsigned blocks = (unsigned)((B + ECDSA_THREADS - 1) / ECDSA_THREADS);
    const WideField f = field_from_words_as<WideField>(field_words);
    if (a_minus_3) {
        ecdsa_mul_kernel<-3><<<blocks, ECDSA_THREADS, ECDSA_SHARED_BYTES, (cudaStream_t)stream>>>(
            (const uint32_t*)u1, (const uint32_t*)u2, (const uint32_t*)q,
            (const uint32_t*)table, (uint32_t*)out, B, f);
    } else {
        ecdsa_mul_kernel<0><<<blocks, ECDSA_THREADS, ECDSA_SHARED_BYTES, (cudaStream_t)stream>>>(
            (const uint32_t*)u1, (const uint32_t*)u2, (const uint32_t*)q,
            (const uint32_t*)table, (uint32_t*)out, B, f);
    }
    return (int)cudaGetLastError();
}

// For the measurements: the shared memory a block takes, and how many blocks
// of the kernel the card keeps resident on one SM (0 where the query fails).
extern "C" int acvm_ecdsa_mul_shared_bytes() { return ECDSA_SHARED_BYTES; }

extern "C" int acvm_ecdsa_mul_blocks_per_sm(int a_minus_3) {
    int blocks = 0;
    const cudaError_t err = a_minus_3
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ecdsa_mul_kernel<-3>, ECDSA_THREADS,
                                                        ECDSA_SHARED_BYTES)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ecdsa_mul_kernel<0>, ECDSA_THREADS,
                                                        ECDSA_SHARED_BYTES);
    return err == cudaSuccess ? blocks : 0;
}
