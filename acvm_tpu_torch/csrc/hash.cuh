// What the three hash kernels (sha256.cu, blake2s.cu, keccak.cu) share: where
// a thread's message bytes come from and where its digest goes.
//
// A launch hashes a group of G gadgets of one message length M over B
// instances, a thread a (gadget, instance): blockIdx.y is the gadget,
// blockIdx.x * blockDim.x + threadIdx.x the instance, so the threads of a warp
// share every table entry and differ only in the instance.
//
// Two layouts, one code.  The witness panel (NW, B, 8) int32: message byte j
// of gadget g is byte `shift / 8` of limb `limb` of row `row`, each from the
// group's (G, M) tables, and each digest byte goes back as a canonical row
// (limb 0 = the byte, limbs 1-7 = 0) at out_idx[g][k]; a thread reads one
// 32-byte sector a message byte and writes one an output row.  A plain
// (B, M) byte matrix (Schnorr's challenge): no tables, row j is byte j, one
// word an element, and the digest goes to a (B, 32) matrix.  Panel rows read
// and rows written never overlap (a gadget's outputs are fresh witnesses),
// so the reads go through the read-only cache.
//
// The bytes come through `MessageStage`, the message stage (below): one-warp
// blocks, the gadget's tables and digest rows copied into shared memory once,
// and each compression block's words copied by `cp.async` into a two-stage
// ring, all of a block's copies in flight before the lane waits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

// The launch arguments every hash kernel takes, in the order of the C
// launchers: the source (pointer, row stride, instance stride, row / limb /
// shift tables), M, the sink (pointer, row stride, instance stride, words a
// row, output rows), G, B.
struct HashGroup {
    const uint32_t* in;
    long long in_row, in_inst;
    const int* src_w;
    const int* src_limb;
    const int* src_shift;
    int M;
    uint32_t* out;
    long long out_row, out_inst;
    int out_words;
    const int* out_idx;
    int n_out;              // digest rows a gadget: 32, or 1 for hash-to-field
    long long B;
};

static inline HashGroup hash_group(const void* in, long long in_row, long long in_inst,
                                   const void* src_w, const void* src_limb, const void* src_shift,
                                   int M, void* out, long long out_row, long long out_inst,
                                   int out_words, const void* out_idx, int n_out, long long B) {
    return HashGroup{(const uint32_t*)in, in_row, in_inst, (const int*)src_w,
                     (const int*)src_limb, (const int*)src_shift, M, (uint32_t*)out, out_row,
                     out_inst, out_words, (const int*)out_idx, n_out, B};
}

// ---------------------------------------------------------------------------
// The message stage (sha256.cu, blake2s.cu, keccak.cu).
//
// A block is one warp: HASH_WARP instances of one gadget, grid
// (ceil(B / HASH_WARP), G), the ragged last block masked.  Shared memory, in
// this order:
//   ring  [S][BLK][HASH_WARP] words: stage k % S holds compression block k's
//         message words, lane l's in column l (no bank conflicts: a row of the
//         ring is 32 consecutive words); S = 2 where the message spans more
//         than one compression block, else 1 (the padding blocks read none);
//   rows, lsh: the gadget's table entries, row and limb | shift << 8 (8 bytes
//         a message byte): all M at once where M <= HASH_TABLE_CAP, else a
//         ring of two compression blocks' entries beside the words' ring,
//         loaded as each block is staged;
//   outs  the gadget's 32 digest rows (one for hash-to-field).
// Each lane copies the 32-bit word of every byte of block k + 1 (4-byte
// `cp.async.ca`, one commit group a block) before it waits for block k's
// group and runs block k's rounds; a copy at or past the lane's length (the
// var form) or in a masked lane has source size 0 and zero-fills its word, so
// no lane branches on its own length.  Each lane reads only its own column,
// so the wait needs no barrier; `__syncwarp` orders the warp's table loads.
//
// Compiled by nvcc, the copy is `cp.async`; a CPU build of the kernels' C
// (tests/test_torch_hash_c.py) defines HASH_WARP 1 and stub `stage_copy`,
// `stage_commit`, `stage_wait_prior` and `HASH_STAGE_LAUNCH` (a plain copy
// or zero fill, and a host loop over the grid).
//
// Measurement switches (chip_smoke.py: rounds only at every hash row, reads
// only with --hash-variants; never a path's build):
//   HASH_READS_ONLY   the stage and the digest write, no rounds (the words
//                     folded into the state);
//   HASH_ROUNDS_ONLY  the rounds over a message made in registers from the
//                     instance index: no copy, no table, no panel read.

#ifndef HASH_WARP
#define HASH_WARP 32
#endif
#ifndef HASH_TABLE_CAP
#define HASH_TABLE_CAP 1024
#endif

#ifdef __CUDACC__
// One 4-byte asynchronous copy into shared memory; `valid` false reads no
// byte (source size 0) and zero-fills the word.
__device__ __forceinline__ void stage_copy(uint32_t* dst, const uint32_t* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Every commit group of this lane but the newest has landed.
__device__ __forceinline__ void stage_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

#define HASH_STAGE_LAUNCH(kernel, grid, smem, stream, ...) \
    kernel<<<(grid), HASH_WARP, (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

// Stages of the ring, and table entries, a block keeps in shared memory.
static inline __host__ __device__ int stage_ring_stages(int block_bytes, int M) {
    return M > block_bytes ? 2 : 1;
}

static inline __host__ __device__ int stage_table_entries(int block_bytes, int M, bool tables) {
    return !tables ? 0 : (M <= HASH_TABLE_CAP ? M : 2 * block_bytes);
}

// The dynamic shared memory of a block of a kernel with `block_bytes`-byte
// compression blocks: the ring, the table entries, the digest rows.
static inline int stage_shared_bytes(int block_bytes, int M, bool tables) {
    return 4 * (stage_ring_stages(block_bytes, M) * block_bytes * HASH_WARP
                + 2 * stage_table_entries(block_bytes, M, tables) + 32);
}

static inline dim3 stage_grid(int G, long long B) {
    return dim3((unsigned)((B + HASH_WARP - 1) / HASH_WARP), (unsigned)G);
}

template <int BLK>  // message bytes a compression block: 64 (SHA-256), 136 (the Keccak rate)
struct MessageStage {
    uint32_t* ring;
    int* rows;
    int* lsh;
    int* outs;              // null: row k (the matrix form)
    const uint32_t* base;   // this instance's element of row 0 (instance 0's in a masked lane)
    long long in_row;
    const int* src_w;       // this gadget's (M,) tables, or null: row j, limb 0, shift 0
    const int* src_limb;
    const int* src_shift;
    uint32_t* sink;         // this instance's element of output row 0
    long long out_row;
    int out_words;
    int M, lane, g;
    int wrap;               // stages of the ring less 1: block k in stage k & wrap
    long long b;
    bool whole;             // all M table entries in shared memory
    bool active;            // b < B

    __device__ __forceinline__ void load_tables(int from, int n, int at) {
        for (int i = lane; i < n; i += HASH_WARP) {
            rows[at + i] = __ldg(src_w + from + i);
            lsh[at + i] = __ldg(src_limb + from + i) | (__ldg(src_shift + from + i) << 8);
        }
    }

    // This lane's instance and the block's shared memory; the gadget's
    // digest rows and (M <= HASH_TABLE_CAP) its table entries copied in.
    __device__ __forceinline__ void open(const HashGroup& grp, uint32_t* smem) {
        lane = threadIdx.x;
        g = blockIdx.y;
        b = (long long)blockIdx.x * HASH_WARP + lane;
        active = b < grp.B;
        M = grp.M;
        base = grp.in + (active ? b : 0) * grp.in_inst;
        in_row = grp.in_row;
        const long long t = (long long)g * M;
        src_w = grp.src_w ? grp.src_w + t : nullptr;
        src_limb = grp.src_w ? grp.src_limb + t : nullptr;
        src_shift = grp.src_w ? grp.src_shift + t : nullptr;
        sink = grp.out + b * grp.out_inst;
        out_row = grp.out_row;
        out_words = grp.out_words;
        whole = M <= HASH_TABLE_CAP;
        const int entries = stage_table_entries(BLK, M, src_w != nullptr);
        wrap = stage_ring_stages(BLK, M) - 1;
        ring = smem;
        rows = reinterpret_cast<int*>(smem + (wrap + 1) * BLK * HASH_WARP);
        lsh = rows + entries;
        outs = grp.out_idx ? lsh + entries : nullptr;
        if (outs) {
            for (int k = lane; k < grp.n_out; k += HASH_WARP) outs[k] = __ldg(grp.out_idx + g * grp.n_out + k);
        }
#ifndef HASH_ROUNDS_ONLY
        if (src_w && whole) load_tables(0, M, 0);
#endif
        __syncwarp();
    }

    // Stage compression block k (if k < blocks and it holds message bytes):
    // every byte's word copied, zero-filled at or past `len`; one commit
    // group whatever it holds.  Called by every lane with the same k.
    __device__ __forceinline__ void start(int k, int blocks, int len) {
#ifndef HASH_ROUNDS_ONLY
        const int j0 = k * BLK;
        if (k < blocks && j0 < M) {
            const int n = min(BLK, M - j0);
            const int at = whole ? j0 : (k & 1) * BLK;  // M > HASH_TABLE_CAP: two stages
            if (src_w && !whole) {
                __syncwarp();  // every lane is done with block k - 2's entries
                load_tables(j0, n, at);
                __syncwarp();
            }
            uint32_t* dst = ring + (k & wrap) * BLK * HASH_WARP + lane;
#pragma unroll 4
            for (int i = 0; i < n; ++i) {
                const uint32_t* src = src_w ? base + rows[at + i] * in_row + (lsh[at + i] & 0xFF)
                                            : base + (long long)(j0 + i) * in_row;
                stage_copy(dst + i * HASH_WARP, src, active && j0 + i < len);
            }
        }
        stage_commit();
#endif
    }

    // Block k's words have landed (start(k + 1, ...) was the last call).
    __device__ __forceinline__ void wait() const {
#ifndef HASH_ROUNDS_ONLY
        stage_wait_prior();
        __syncwarp();
#endif
    }

    // Byte i of compression block k: the message's, 0 at or past the length.
    __device__ __forceinline__ uint32_t byte(int k, int i) const {
        const int j = k * BLK + i;
        if (j >= M) return 0u;
        const uint32_t w = ring[((k & wrap) * BLK + i) * HASH_WARP + lane];
        if (src_w == nullptr) return w & 0xFFu;
        return (w >> (lsh[whole ? j : (k & 1) * BLK + i] >> 8)) & 0xFFu;
    }

    // Output row k gets the 8 limbs x (hash-to-field's value), or x[0].
    __device__ __forceinline__ void put(int k, const uint32_t x[ACVM_LIMBS]) const {
        uint32_t* dst = sink + (outs ? outs[k] : k) * out_row;
        if (out_words == ACVM_LIMBS) store_fe(dst, x);
        else *dst = x[0];
    }

    // Digest byte k: a canonical row (v, 0, ..., 0), or one word.
    __device__ __forceinline__ void put_byte(int k, uint32_t v) const {
        uint32_t* dst = sink + (outs ? outs[k] : k) * out_row;
        if (out_words == ACVM_LIMBS) {
            uint4* d = reinterpret_cast<uint4*>(dst);
            d[0] = make_uint4(v, 0, 0, 0);
            d[1] = make_uint4(0, 0, 0, 0);
        } else {
            *dst = v;
        }
    }
};
