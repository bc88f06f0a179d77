// ECDSA's double-scalar multiplication R = u1 G + u2 Q over secp256k1 (a = 0)
// or secp256r1 (a = -3), one thread a verification, the whole of it in one
// launch.
//
// Replaces acvm_tpu/tpu/ecdsa.py:147-152: `fixed_base_mul` over the
// generator's window table (a gather and a tree of complete additions),
// `scalar_mul`'s scan of 256 double-and-add steps (acvm_tpu/tpu/ec.py:336-375)
// and the final `pt_add`, all of it wide-field limb arithmetic one operation
// at a time.  Here a thread keeps its accumulator (X, Y, Z) in registers and
// runs the same three parts in turn:
//
//     acc = sum over the 64 windows w of u1 of T[w][d_w]    (u1 G; d_w = 0 adds nothing)
//     park acc in the thread's output slot
//     acc = 0;  for each bit of u2, MSB first: acc = 2 acc;  if (bit) acc = acc + Q
//     acc = acc + (the parked u1 G)                          (R)
//
// with T[w][d] = d 2^(4w) G, the reference's table (64 windows x 16 digits x
// 3 x 8 words, 98 KB, read from global memory where it stays in L2 / L1).
// The group law is ec.cuh's over the wide field, complete, so each edge takes
// the reference's branch: the accumulator at infinity (u1 = 0, u2 = 0, a
// prefix at infinity), P == Q in an addition (u1 G == u2 Q in the last one:
// the doubling branch) and P == -Q (infinity).  Every table entry and Q
// have Z = one (R mod p), so those additions are ec_madd's 11 products; the
// last one, of two Jacobian points, is ec_add's 16.  Leading zero bits of u2
// cost no product.  Only the affine R is observable (the gadget's output is
// one bit); X, Y and Z equal `ecdsa_mul_plain`'s, which runs this chain one
// field operation at a time.
//
// What bounds it: one thread's chain of about 60 x 11 table products, 256 x
// 7-8 doubling products and 128 x 11 addition products, each waiting on the
// last.  At 8,192 verifications that is 256 warps, under two a SM: the time
// is that chain's latency.  Blocks of 32 threads spread the warps over every
// SM.
#include "ec.cuh"

template <int A>
__global__ void __launch_bounds__(32)
ecdsa_mul_kernel(const uint32_t* __restrict__ u1, const uint32_t* __restrict__ u2,
                 const uint32_t* __restrict__ q, const uint32_t* __restrict__ table,
                 uint32_t* __restrict__ out, long long B, const WideField f) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const long long coord = B * ACVM_LIMBS;   // (3, B, 8): X, Y, Z planes
    const uint32_t* qb = q + b * ACVM_LIMBS;
    const uint32_t* k2 = u2 + b * ACVM_LIMBS;
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

    // u2 Q, MSB first.
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) x[i] = y[i] = z[i] = 0;
#pragma unroll 1
    for (int limb = ACVM_LIMBS - 1; limb >= 0; --limb) {
        const uint32_t word = k2[limb];
#pragma unroll 1
        for (int bit = 31; bit >= 0; --bit) {
            ec_dbl<A>(x, y, z, f);
            if ((word >> bit) & 1u) ec_madd<A>(x, y, z, qb, qb + coord, f);
        }
    }

    // R = u2 Q + u1 G: u1 G read back from the slot this thread wrote.
    ec_add<A>(x, y, z, o, o + coord, o + 2 * coord, f);
    store_fe(o, x);
    store_fe(o + coord, y);
    store_fe(o + 2 * coord, z);
}

// u1, u2: (B, 8) standard-form scalars; q: (3, B, 8) Jacobian Montgomery with
// Z = R mod p (its Z plane is not read); table: (64, 16, 3, 8) Montgomery,
// every entry of a nonzero digit finite with Z = R mod p; out: (3, B, 8).  a_minus_3 selects the
// secp256r1 doubling.
extern "C" int acvm_ecdsa_mul(const void* u1, const void* u2, const void* q, const void* table,
                              void* out, long long B, int a_minus_3,
                              const uint32_t* field_words, void* stream) {
    if (B <= 0) return 0;
    const int threads = 32;
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    const WideField f = field_from_words_as<WideField>(field_words);
    if (a_minus_3) {
        ecdsa_mul_kernel<-3><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)u1, (const uint32_t*)u2, (const uint32_t*)q,
            (const uint32_t*)table, (uint32_t*)out, B, f);
    } else {
        ecdsa_mul_kernel<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)u1, (const uint32_t*)u2, (const uint32_t*)q,
            (const uint32_t*)table, (uint32_t*)out, B, f);
    }
    return (int)cudaGetLastError();
}
