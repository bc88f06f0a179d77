// Keccak-256 (the original 0x01 padding) of a group's G gadgets x B
// instances: of all M message bytes, or of each instance's first length[g][b]
// bytes (the variable-length form, length <= M, checked by the caller).
//
// Replaces the JAX package's `tpu/gadgets.py::keccak_f1600_batched`,
// `keccak256_digest` and `keccak256_var_digest` (24 unrolled rounds of `jnp`
// ops a permutation, each 64-bit lane a (lo, hi) pair of uint32 because the
// TPU has no 64-bit integers; the var form padding the whole batch to the
// longest message and committing block k only where k is below an instance's
// block count).  Here the lanes are native `uint64_t` and one thread hashes
// one (gadget, instance): the 25 lanes stay in registers, the round constants
// in constant memory, and the thread absorbs only its own blocks, so the
// fixed form is the var form with length = M.  The padding (0x01 after the
// message, 0x80 ending the last rate block, one byte 0x81 where they meet) is
// laid on as the lanes are assembled.
//
// Bound.  Bytes: one 32-byte sector a distinct (panel row, instance) the
// thread reads (the var form reads only its first length bytes), one an
// output row written.  Operations: gpu/gadgets.py's OPS_PER_BLOCK (its count
// of these rounds) a permutation, length / 136 + 1 permutations (PERF.md,
// row 13).  The bytes bound it on this card at the paths' shapes (0.0115 ms
// for the membership's var group of 1 x 8,192 x 232), with ~7.5 us of
// arithmetic a warp.  The first design ran 5.7-8.2 % of that bound: 64
// blocks of 128 threads on 64 SMs, and every byte two dependent global round
// trips made behind the data-dependent `j < length`.  So the message comes
// through hash.cuh's `MessageStage`: one-warp blocks over every SM, the
// tables in shared memory, each rate block's 136 words copied by `cp.async`
// all at once (zero-filled past the length, no branch), block k + 1's in
// flight while block k's permutation runs.  The warp runs as many blocks as
// its longest message; a lane with fewer permutes none past its own.
#include "hash.cuh"

#define KECCAK_RATE 136

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// 0 < n < 64; nvcc makes it two funnel shifts.
__device__ __forceinline__ uint64_t rotl(uint64_t x, int n) { return (x << n) | (x >> (64 - n)); }

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
    for (int round = 0; round < 24; ++round) {
        uint64_t c[5], d[5], b[25];
#pragma unroll
        for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
        for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
        // rho and pi: b[y + 5 ((2 x + 3 y) mod 5)] = a[x + 5 y] <<< r[x][y]
        b[0] = a[0];
        b[1] = rotl(a[6], 44);
        b[2] = rotl(a[12], 43);
        b[3] = rotl(a[18], 21);
        b[4] = rotl(a[24], 14);
        b[5] = rotl(a[3], 28);
        b[6] = rotl(a[9], 20);
        b[7] = rotl(a[10], 3);
        b[8] = rotl(a[16], 45);
        b[9] = rotl(a[22], 61);
        b[10] = rotl(a[1], 1);
        b[11] = rotl(a[7], 6);
        b[12] = rotl(a[13], 25);
        b[13] = rotl(a[19], 8);
        b[14] = rotl(a[20], 18);
        b[15] = rotl(a[4], 27);
        b[16] = rotl(a[5], 36);
        b[17] = rotl(a[11], 10);
        b[18] = rotl(a[17], 15);
        b[19] = rotl(a[23], 56);
        b[20] = rotl(a[2], 62);
        b[21] = rotl(a[8], 55);
        b[22] = rotl(a[14], 39);
        b[23] = rotl(a[15], 41);
        b[24] = rotl(a[21], 2);
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
#pragma unroll
            for (int x = 0; x < 5; ++x) a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
        }
        a[0] ^= KECCAK_RC[round];
    }
}

static_assert(4 * (2 * KECCAK_RATE * HASH_WARP + 2 * HASH_TABLE_CAP + 32) <= 48 * 1024,
              "a block's shared memory must stay under the 48 KB that needs no opt-in");

__global__ void __launch_bounds__(HASH_WARP) keccak_kernel(HashGroup grp, const int* length) {
    extern __shared__ __align__(16) uint32_t hash_smem[];
    MessageStage<KECCAK_RATE> st;
    st.open(grp, hash_smem);
    const int len = !st.active ? 0 : length ? __ldg(length + (long long)st.g * grp.B + st.b) : grp.M;
    const int blocks = len / KECCAK_RATE + 1;
    const int warp_blocks = __reduce_max_sync(0xFFFFFFFFu, blocks);
    const int last = blocks * KECCAK_RATE - 1;
    uint64_t a[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] = 0;
    st.start(0, warp_blocks, len);
    for (int blk = 0; blk < warp_blocks; ++blk) {
        st.start(blk + 1, warp_blocks, len);
        st.wait();
        if (blk >= blocks) continue;
#pragma unroll
        for (int w = 0; w < KECCAK_RATE / 8; ++w) {
            uint64_t v = 0;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int j = blk * KECCAK_RATE + 8 * w + i;
#ifdef HASH_ROUNDS_ONLY
                uint32_t byte = (uint32_t)(st.b * 131 + j) & 0xFFu;
#else
                uint32_t byte = st.byte(blk, 8 * w + i);  // 0 at or past len
#endif
                byte ^= (j == len ? 0x01u : 0u) ^ (j == last ? 0x80u : 0u);
                v |= (uint64_t)byte << (8 * i);
            }
            a[w] ^= v;
        }
#ifndef HASH_READS_ONLY
        keccak_f(a);
#endif
    }
    if (!st.active) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) st.put_byte(8 * i + k, (uint32_t)(a[i] >> (8 * k)) & 0xFFu);
    }
}

// The launch arguments of hash.cuh's HashGroup; then the (G, B) int32 byte
// counts of the variable-length form, or null for M bytes; then the stream.
// Returns cudaGetLastError().
extern "C" int acvm_keccak(const void* in, long long in_row, long long in_inst, const void* src_w,
                           const void* src_limb, const void* src_shift, int M, void* out,
                           long long out_row, long long out_inst, int out_words,
                           const void* out_idx, int G, long long B, const void* length,
                           void* stream) {
    if (G <= 0 || B <= 0) return 0;
    const HashGroup grp = hash_group(in, in_row, in_inst, src_w, src_limb, src_shift, M, out,
                                     out_row, out_inst, out_words, out_idx, 32, B);
    HASH_STAGE_LAUNCH(keccak_kernel, stage_grid(G, B),
                      stage_shared_bytes(KECCAK_RATE, M, src_w != nullptr), stream, grp,
                      (const int*)length);
    return (int)cudaGetLastError();
}

// Dynamic shared memory a block of a launch at M (tables != 0: the panel form).
extern "C" int acvm_keccak_shared_bytes(int M, int tables) {
    return stage_shared_bytes(KECCAK_RATE, M, tables != 0);
}
