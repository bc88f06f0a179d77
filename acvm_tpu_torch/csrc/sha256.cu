// SHA-256 of a group's G gadgets x B instances of M message bytes each.
//
// Replaces the JAX package's `tpu/gadgets.py::sha256_digest` (64 unrolled
// rounds of `jnp` ops a block, over the whole batch, with the message gathered
// off the witness tensor before and the digest scattered after).  Here one
// thread hashes one (gadget, instance) from its first message byte to its last
// digest byte: the state and a rolling 16-word message schedule stay in
// registers, K sits in constant memory (every lane of a warp reads the same
// word), every rotate is one funnel shift, and the static padding (0x80,
// zeros, the bit length) is laid on as the words are assembled.
//
// Bound.  Bytes: one 32-byte sector a distinct (panel row, instance) read and
// one an output row written.  Operations: gpu/gadgets.py's OPS_PER_BLOCK (its
// count of these rounds) a block, (M + 8) / 64 + 1 blocks.  At the paths'
// 64-byte messages the bytes bound it (PERF.md, row 12): 0.0075 ms at one
// gadget x 8,192 instances, where the arithmetic is ~2 us at one warp a
// scheduler.  What held the first design back there was latency: 128-thread
// blocks gave 8,192 instances 64 blocks on 64 of the 132 SMs, and each byte
// cost two dependent global round trips (its table entries, then its word),
// loaded a few at a time as the words were assembled.  So the message comes
// through hash.cuh's `MessageStage`: one-warp blocks (8,192 instances = 256
// blocks over every SM), the tables in shared memory, and each compression
// block's 64 words copied by `cp.async` all at once, block k + 1's in flight
// while block k's rounds run.
#include "hash.cuh"

__constant__ uint32_t SHA_K[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

// Byte j of the padded message, given the message's byte (0 past M): 0x80 at
// M, then zeros, then the message's length in bits as 8 big-endian bytes
// ending the last block.
__device__ __forceinline__ uint32_t padded_byte(uint32_t message, int M, int total, int j) {
    if (j == M) return 0x80u;
    const int from_end = total - 1 - j;  // 0 for the last byte
    if (from_end < 8) return (uint32_t)(((unsigned long long)M * 8ull) >> (8 * from_end)) & 0xFFu;
    return message;
}

__device__ __forceinline__ void compress(uint32_t h[8], uint32_t w[16]) {
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], k = h[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        if (t >= 16) {  // w[t & 15] holds w[t - 16]
            const uint32_t x = w[(t - 15) & 15], y = w[(t - 2) & 15];
            const uint32_t s0 = rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
            const uint32_t s1 = rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
        }
        const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        const uint32_t ch = (e & f) ^ (~e & g);
        const uint32_t t1 = k + S1 + ch + SHA_K[t] + w[t & 15];
        const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        k = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + S0 + maj;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e; h[5] += f; h[6] += g; h[7] += k;
}

__global__ void __launch_bounds__(HASH_WARP) sha256_kernel(HashGroup grp) {
    extern __shared__ __align__(16) uint32_t hash_smem[];
    MessageStage<64> st;
    st.open(grp, hash_smem);
    const int M = grp.M;
    const int blocks = (M + 8) / 64 + 1;
    const int total = 64 * blocks;
    uint32_t h[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19};
    st.start(0, blocks, M);
    for (int blk = 0; blk < blocks; ++blk) {
        st.start(blk + 1, blocks, M);
        st.wait();
        uint32_t w[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
#ifdef HASH_ROUNDS_ONLY
            w[t] = (uint32_t)st.b * 0x9E3779B9u + (uint32_t)(16 * blk + t);
#else
            uint32_t x = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                x = (x << 8) | padded_byte(st.byte(blk, 4 * t + i), M, total, 64 * blk + 4 * t + i);
            w[t] = x;
#endif
        }
#ifdef HASH_READS_ONLY
#pragma unroll
        for (int t = 0; t < 16; ++t) h[t & 7] ^= w[t];
#else
        compress(h, w);
#endif
    }
    if (!st.active) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) st.put_byte(4 * i + k, (h[i] >> (24 - 8 * k)) & 0xFFu);
    }
}

// The launch arguments of hash.cuh's HashGroup, then the stream.  Returns
// cudaGetLastError().
extern "C" int acvm_sha256(const void* in, long long in_row, long long in_inst, const void* src_w,
                           const void* src_limb, const void* src_shift, int M, void* out,
                           long long out_row, long long out_inst, int out_words,
                           const void* out_idx, int G, long long B, void* stream) {
    if (G <= 0 || B <= 0) return 0;
    const HashGroup grp = hash_group(in, in_row, in_inst, src_w, src_limb, src_shift, M, out,
                                     out_row, out_inst, out_words, out_idx, 32, B);
    HASH_STAGE_LAUNCH(sha256_kernel, stage_grid(G, B), stage_shared_bytes(64, M, src_w != nullptr),
                      stream, grp);
    return (int)cudaGetLastError();
}

// Dynamic shared memory a block of a launch at M (tables != 0: the panel form).
extern "C" int acvm_sha256_shared_bytes(int M, int tables) { return stage_shared_bytes(64, M, tables != 0); }
