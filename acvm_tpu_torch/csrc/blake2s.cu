// BLAKE2s-256 (no key) of a group's G gadgets x B instances of M message
// bytes; in hash-to-field mode the digest read big-endian and brought below p.
//
// Replaces the JAX package's `tpu/gadgets.py::blake2s_digest` (10 unrolled
// rounds of `jnp` ops a block over the batch) and the epilogue of its
// `run_hashes` for HashToField128Security (`tpu/batch_solver.py:451-472`: the
// 256-bit big-endian digest minus 4p, 2p, p where each fits).  One thread
// hashes one (gadget, instance): the 16 state words and the block's 16
// message words in registers (every round's message indices are literals, so
// no array is indexed at run time), the rotates funnel shifts.  In
// hash-to-field mode the eight limbs of the value are the byte-swapped state
// words in reverse order, and the conditional subtractions are field.cuh's
// borrow chain.
//
// Bound.  Bytes: one 32-byte sector a distinct (panel row, instance) read,
// one an output row written (32 digest rows, or one field row).  Operations:
// gpu/gadgets.py's OPS_PER_BLOCK (its count of these rounds) a block,
// max(1, ceil(M / 64)) blocks, and TO_FIELD_OPS for the subtractions.  The
// bytes bound it at the paths' shapes (PERF.md, row 14).  The first design
// (128-thread blocks, each byte read where the rounds needed it: three table
// loads, then the panel word they address) ran 16-26 % of that bound at one
// gadget x 8,192 instances: 64 blocks on 64 of the 132 SMs, and each byte two
// dependent global round trips.  So the message comes through hash.cuh's
// `MessageStage`, as sha256.cu's does: one-warp blocks (8,192 instances = 256
// blocks over every SM), the gadget's tables and digest rows in shared
// memory, and each 64-byte block's words copied by `cp.async` all at once,
// block k + 1's in flight while block k's ten rounds run.  The counter t, the
// last-block flag and M = 0 (one block of zeros) are BLAKE2s' own.
#include "hash.cuh"

// The multiples of p to subtract (largest first) and how many, or n = -1 for
// the digest itself: the launch argument of hash-to-field mode.
struct Subtrahends {
    uint32_t m[3][ACVM_LIMBS];
    int n;
};

__constant__ uint32_t B2S_IV[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                                   0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

#define B2S_G(a, b, c, d, x, y)              \
    do {                                     \
        a = a + b + (x); d = rotr(d ^ a, 16); \
        c = c + d;       b = rotr(b ^ c, 12); \
        a = a + b + (y); d = rotr(d ^ a, 8);  \
        c = c + d;       b = rotr(b ^ c, 7);  \
    } while (0)

#define B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
    do {                                                                                \
        B2S_G(v0, v4, v8, v12, m[s0], m[s1]);                                           \
        B2S_G(v1, v5, v9, v13, m[s2], m[s3]);                                           \
        B2S_G(v2, v6, v10, v14, m[s4], m[s5]);                                          \
        B2S_G(v3, v7, v11, v15, m[s6], m[s7]);                                          \
        B2S_G(v0, v5, v10, v15, m[s8], m[s9]);                                          \
        B2S_G(v1, v6, v11, v12, m[s10], m[s11]);                                        \
        B2S_G(v2, v7, v8, v13, m[s12], m[s13]);                                         \
        B2S_G(v3, v4, v9, v14, m[s14], m[s15]);                                         \
    } while (0)

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16], uint32_t t, bool last) {
    uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3], v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
    uint32_t v8 = B2S_IV[0], v9 = B2S_IV[1], v10 = B2S_IV[2], v11 = B2S_IV[3];
    uint32_t v12 = B2S_IV[4] ^ t, v13 = B2S_IV[5], v14 = last ? ~B2S_IV[6] : B2S_IV[6];
    uint32_t v15 = B2S_IV[7];
    B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
    B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
    B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
    B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
    B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
    B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
    B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
    B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
    B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
    h[0] ^= v0 ^ v8; h[1] ^= v1 ^ v9; h[2] ^= v2 ^ v10; h[3] ^= v3 ^ v11;
    h[4] ^= v4 ^ v12; h[5] ^= v5 ^ v13; h[6] ^= v6 ^ v14; h[7] ^= v7 ^ v15;
}

__global__ void __launch_bounds__(HASH_WARP) blake2s_kernel(HashGroup grp, Subtrahends subs) {
    extern __shared__ __align__(16) uint32_t hash_smem[];
    MessageStage<64> st;
    st.open(grp, hash_smem);
    const int M = grp.M;
    const int blocks = M > 0 ? (M + 63) / 64 : 1;
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = B2S_IV[i];
    h[0] ^= 0x01010020u;  // depth 1, fanout 1, a 32-byte digest
    st.start(0, blocks, M);
    for (int blk = 0; blk < blocks; ++blk) {
        st.start(blk + 1, blocks, M);
        st.wait();
        uint32_t m[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
#ifdef HASH_ROUNDS_ONLY
            m[t] = (uint32_t)st.b * 0x9E3779B9u + (uint32_t)(16 * blk + t);
#else
            uint32_t word = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) word |= st.byte(blk, 4 * t + i) << (8 * i);  // 0 past M
            m[t] = word;
#endif
        }
#ifdef HASH_READS_ONLY
#pragma unroll
        for (int t = 0; t < 16; ++t) h[t & 7] ^= m[t];
#else
        const int counted = min(64 * (blk + 1), M);  // bytes hashed so far (M < 2^32)
        compress(h, m, (uint32_t)counted, blk == blocks - 1);
#endif
    }
    if (!st.active) return;
    if (subs.n < 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int k = 0; k < 4; ++k) st.put_byte(4 * i + k, (h[i] >> (8 * k)) & 0xFFu);
        }
        return;
    }
    // The digest big-endian: its last four bytes are limb 0, i.e. limb j is
    // state word 7 - j with its bytes swapped.
    uint32_t x[ACVM_LIMBS];
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) x[j] = __byte_perm(h[7 - j], 0, 0x0123);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
        if (s >= subs.n) break;
        uint32_t d[ACVM_LIMBS];
        const uint32_t borrow = sub_limbs(d, x, subs.m[s]);
#pragma unroll
        for (int i = 0; i < ACVM_LIMBS; ++i) x[i] = borrow ? x[i] : d[i];
    }
    st.put(0, x);
}

// The launch arguments of hash.cuh's HashGroup; then the multiples of p to
// subtract, 3 x 8 words on the host (hash-to-field mode, one output row a
// gadget), and how many, or -1 for the 32 digest bytes; then the stream.
// Returns cudaGetLastError().
extern "C" int acvm_blake2s(const void* in, long long in_row, long long in_inst, const void* src_w,
                            const void* src_limb, const void* src_shift, int M, void* out,
                            long long out_row, long long out_inst, int out_words,
                            const void* out_idx, int G, long long B, const void* subtrahends,
                            int n_sub, void* stream) {
    if (G <= 0 || B <= 0) return 0;
    if (n_sub > 3) return (int)cudaErrorInvalidValue;
    Subtrahends subs;
    const uint32_t* words = (const uint32_t*)subtrahends;
    for (int s = 0; s < 3; ++s)
        for (int i = 0; i < ACVM_LIMBS; ++i) subs.m[s][i] = words[s * ACVM_LIMBS + i];
    subs.n = n_sub;
    const HashGroup grp = hash_group(in, in_row, in_inst, src_w, src_limb, src_shift, M, out,
                                     out_row, out_inst, out_words, out_idx, n_sub < 0 ? 32 : 1, B);
    HASH_STAGE_LAUNCH(blake2s_kernel, stage_grid(G, B), stage_shared_bytes(64, M, src_w != nullptr),
                      stream, grp, subs);
    return (int)cudaGetLastError();
}

// Dynamic shared memory a block of a launch at M (tables != 0: the panel form).
extern "C" int acvm_blake2s_shared_bytes(int M, int tables) { return stage_shared_bytes(64, M, tables != 0); }
