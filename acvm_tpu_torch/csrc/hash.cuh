// What the three hash kernels (sha256.cu, blake2s.cu, keccak.cu) share: where
// a thread's message bytes come from and where its digest goes.
//
// A launch hashes a group of G gadgets of one message length M over B
// instances, a thread a (gadget, instance): blockIdx.y is the gadget,
// blockIdx.x * blockDim.x + threadIdx.x the instance, so the threads of a warp
// share every table entry (one broadcast load) and differ only in the
// instance.
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
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

struct ByteSource {
    const uint32_t* base;   // the element (row, this instance, limb 0)
    long long row_stride;   // int32 words from one row to the next
    const int* row;         // this gadget's (M,) tables, or null: row j, limb 0, shift 0
    const int* limb;
    const int* shift;

    __device__ __forceinline__ uint32_t byte(int j) const {
        if (row == nullptr) return __ldg(base + j * row_stride) & 0xFFu;
        const uint32_t word = __ldg(base + __ldg(row + j) * row_stride + __ldg(limb + j));
        return (word >> __ldg(shift + j)) & 0xFFu;
    }
};

struct RowSink {
    uint32_t* base;         // the element (row 0, this instance, limb 0)
    long long row_stride;
    int words;              // 8: a canonical row; 1: one word
    const int* row;         // this gadget's output rows, or null: row k

    // Row k gets the 8 limbs x (hash-to-field's value).
    __device__ __forceinline__ void put(int k, const uint32_t x[ACVM_LIMBS]) const {
        uint32_t* dst = base + (row ? __ldg(row + k) : k) * row_stride;
        if (words == ACVM_LIMBS) store_fe(dst, x);
        else *dst = x[0];
    }

    __device__ __forceinline__ void put_byte(int k, uint32_t v) const {
        uint32_t* dst = base + (row ? __ldg(row + k) : k) * row_stride;
        if (words == ACVM_LIMBS) {
            uint4* d = reinterpret_cast<uint4*>(dst);
            d[0] = make_uint4(v, 0, 0, 0);
            d[1] = make_uint4(0, 0, 0, 0);
        } else {
            *dst = v;
        }
    }
};

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

    // This thread's source and sink; false past the last instance.
    __device__ __forceinline__ bool thread(ByteSource& s, RowSink& d, int& g, long long& b) const {
        b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
        g = blockIdx.y;
        if (b >= B) return false;
        const long long t = (long long)g * M;
        s = ByteSource{in + b * in_inst, in_row, src_w ? src_w + t : nullptr,
                       src_w ? src_limb + t : nullptr, src_w ? src_shift + t : nullptr};
        d = RowSink{out + b * out_inst, out_row, out_words,
                    out_idx ? out_idx + (long long)g * n_out : nullptr};
        return true;
    }
};

#define ACVM_HASH_THREADS 128

static inline HashGroup hash_group(const void* in, long long in_row, long long in_inst,
                                   const void* src_w, const void* src_limb, const void* src_shift,
                                   int M, void* out, long long out_row, long long out_inst,
                                   int out_words, const void* out_idx, int n_out, long long B) {
    return HashGroup{(const uint32_t*)in, in_row, in_inst, (const int*)src_w,
                     (const int*)src_limb, (const int*)src_shift, M, (uint32_t*)out, out_row,
                     out_inst, out_words, (const int*)out_idx, n_out, B};
}

static inline dim3 hash_grid(int G, long long B) {
    return dim3((unsigned)((B + ACVM_HASH_THREADS - 1) / ACVM_HASH_THREADS), (unsigned)G);
}
