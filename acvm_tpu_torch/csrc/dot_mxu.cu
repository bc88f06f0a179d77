// Expression-panel dot on the tensor cores:
//
//   out[e, b] = REDC( qc[e] + sum_t coeff[e, t] * vals[e, t, b] )      (canonical)
//
// vals (E, T, B, 8) canonical standard form, coeff (E, T, 8) Montgomery form
// (c R, or c R^2 beside w1 w2 R^-1 products), qc (E, 8) Montgomery form.
//
// Replaces: the JAX package's fields/mxu_ops.py::mont_dot_mxu (with redc_mxu
// and toeplitz8), the opt-in route of tpu/batch_solver.py::eval_exprs.  It
// reaches no pallas_call: its bf16 einsums of 8-bit-limb Toeplitz matrices ran
// on the TPU's matrix unit.  The H100 has the same exact-integer identity in
// its int8 tensor cores.
//
// The convolution.  Per gate, conv[b, k] = sum_t sum_j v8[t, b, j] c8[t, k - j]
// over the 32 little-endian bytes of each value (a contiguous int32 limb row
// read as bytes is already that order).  As a matrix product with the
// instances on N: C (64 x B) = A_t (64 x 32) * V_t (32 x B), summed over t,
// with A_t the transposed Toeplitz matrix of the term's coefficient bytes,
// A_t[k][j] = c8[t][k - j] (row 63 is zero).  Each warp runs
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32 over 4 x 4 tiles of 16 rows x 8
// instances: every sum is exact in int32 (at most 8 x 32 x 255^2 < 2^24).
// The reduction axis of the mma is permuted so that a thread's two B registers
// are two neighbouring limbs of one instance (8 bytes, one load): mma k-group
// [4 tig, 4 tig + 4) is byte group [8 tig, 8 tig + 4) and [16 + 4 tig, ...) is
// [8 tig + 4, 8 tig + 8).  A_t is read with the same permutation, so the
// pairing is the plain product's.  A_t lives in shared memory, built by the
// block from the gate's 32 T coefficient bytes: nothing of the (E, T, 32, 63)
// Toeplitz tensor the JAX package materialises goes through device memory.
//
// The reduction.  JAX's redc_mxu multiplies by constant matrices after carry
// passes that leave limbs of up to 256, which is exact in bf16 but does not
// fit an unsigned-byte operand.  Here the one REDC a (gate, instance) runs on
// the CUDA cores from its 63 column sums: the sums staged through shared
// memory (instance rows of 68 words: no bank conflict either way), folded into
// the 512-bit X = X_lo + X_hi 2^256 (qc added), then
// REDC(X) = X_lo * 1 * R^-1 + (X_hi mod p): field.cuh's Montgomery product
// by the integer 1, one conditional subtract (X < 8 p^2 + p, so X_hi < 1.52 p
// for BN254) and one modular add.  It is one product a value where the v2 dot
// (dot.cu) runs one a term and a modular add a term.
//
// What bounds it: 32 bytes a term an instance read and 32 bytes written,
// against 32 x 32 byte products a term on the tensor cores and one
// Montgomery product: device memory, at any term count.  A block takes one
// gate and 256 instances (four warps, two 32-instance tiles each), so A_t is
// built once for 256 instances.  Shared memory: 2 KB a term + 34 KB of
// staging (over 48 KB at T = 8: the launcher opts in).

#include "field.cuh"

#define MXU_WARPS 4
#define MXU_TILE 32
#define MXU_TILES_PER_WARP 2
#define MXU_BLOCK_INSTANCES (MXU_WARPS * MXU_TILE * MXU_TILES_PER_WARP)
#define MXU_STAGE_STRIDE 68   // words a staged instance row: 64 sums + 4
#define MXU_TOEPLITZ_WORDS 512  // 64 rows x 32 bytes a term

__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int T>
__global__ void __launch_bounds__(MXU_WARPS * 32)
mont_dot_mxu_kernel(const uint32_t* __restrict__ vals, const uint32_t* __restrict__ coeff,
                    const uint32_t* __restrict__ qc, uint32_t* __restrict__ out, long long E,
                    long long B, const Field f) {
    extern __shared__ __align__(16) uint32_t smem[];
    uint32_t* toeplitz = smem;                                   // [T][64][8] words
    const long long e = blockIdx.y + (long long)blockIdx.z * gridDim.y;
    if (e >= E) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    uint32_t* stage = smem + T * MXU_TOEPLITZ_WORDS + warp * MXU_TILE * MXU_STAGE_STRIDE;

    // A_t[k][j] = c8[t][k - j], four bytes a word; and which terms are live
    // (a zero coefficient is padding to the widest gate: skipped, loads and all).
    const uint32_t* ce = coeff + e * T * ACVM_LIMBS;
    for (int w = threadIdx.x; w < T * MXU_TOEPLITZ_WORDS; w += blockDim.x) {
        const int t = w / MXU_TOEPLITZ_WORDS, k = (w / 8) % 64, j0 = (w % 8) * 4;
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int x = k - (j0 + i);
            if (x >= 0 && x < 32)
                word |= ((__ldg(ce + t * ACVM_LIMBS + (x >> 2)) >> (8 * (x & 3))) & 0xFFu) << (8 * i);
        }
        toeplitz[w] = word;
    }
    uint32_t live = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
        uint32_t any = 0;
#pragma unroll
        for (int i = 0; i < ACVM_LIMBS; ++i) any |= __ldg(ce + t * ACVM_LIMBS + i);
        if (any) live |= 1u << t;
    }
    __syncthreads();

    uint32_t qm[ACVM_LIMBS];
    load_fe(qm, qc + e * ACVM_LIMBS);
    const long long block_base = (long long)blockIdx.x * MXU_BLOCK_INSTANCES;
    for (int tile = 0; tile < MXU_TILES_PER_WARP; ++tile) {
        const long long base = block_base + (long long)(tile * MXU_WARPS + warp) * MXU_TILE;
        if (base >= B) break;   // the same for the whole warp

        int acc[4][4][4];   // [row tile][instance tile][fragment]
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0;

#pragma unroll
        for (int t = 0; t < T; ++t) {
            if (!((live >> t) & 1u)) continue;
            const uint32_t* vt = vals + (e * T + t) * B * ACVM_LIMBS;
            uint2 bv[4];   // limbs 2 tig and 2 tig + 1 of instance base + 8 nt + g
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const long long b = base + nt * 8 + g;
                bv[nt] = b < B ? __ldg(reinterpret_cast<const uint2*>(vt + b * ACVM_LIMBS + 2 * tig))
                               : make_uint2(0u, 0u);
            }
            const uint32_t* at = toeplitz + t * MXU_TOEPLITZ_WORDS;
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const uint2 lo = *reinterpret_cast<const uint2*>(at + (mt * 16 + g) * 8 + 2 * tig);
                const uint2 hi = *reinterpret_cast<const uint2*>(at + (mt * 16 + g + 8) * 8 + 2 * tig);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    mma_u8(acc[mt][nt], lo.x, hi.x, lo.y, hi.y, bv[nt].x, bv[nt].y);
            }
        }

        // Fragment (row g or g + 8, instance 2 tig + c) of each tile -> the
        // instance's row of 64 column sums.
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    stage[(nt * 8 + tig * 2 + (r & 1)) * MXU_STAGE_STRIDE + mt * 16 + g + 8 * (r >> 1)] =
                        (uint32_t)acc[mt][nt][r];
        __syncwarp();

        const long long b = base + lane;
        if (b < B) {
            // Column sums (< 2^24) -> X in sixteen words.
            const uint4* row = reinterpret_cast<const uint4*>(stage + lane * MXU_STAGE_STRIDE);
            uint32_t x[2 * ACVM_LIMBS];
            uint64_t carry = 0;
#pragma unroll
            for (int w = 0; w < 2 * ACVM_LIMBS; ++w) {
                const uint4 s = row[w];
                const uint64_t v = carry + s.x + ((uint64_t)s.y << 8) + ((uint64_t)s.z << 16) +
                                   ((uint64_t)s.w << 24);
                x[w] = (uint32_t)v;
                carry = v >> 32;
            }
            uint32_t lo[ACVM_LIMBS], hi[ACVM_LIMBS], c[ACVM_LIMBS] = {0, 0, 0, 0, 0, 0, 0, 0};
            c[0] = add_limbs(lo, x, qm);            // X_lo + qc R
            add_limbs(hi, x + ACVM_LIMBS, c);       // X_hi + its carry: < 1.52 p
            uint32_t one[ACVM_LIMBS] = {1, 0, 0, 0, 0, 0, 0, 0}, r[ACVM_LIMBS];
            mont_mul(r, one, lo, f);                // X_lo R^-1, canonical
            cond_sub(hi, f);
            add_mod(r, r, hi, f);
            store_fe(out + (e * B + b) * ACVM_LIMBS, r);
        }
        __syncwarp();   // the row is read before the next tile overwrites it
    }
}

template <int T>
static int launch_dot_mxu(const void* vals, const void* coeff, const void* qc, void* out,
                          long long E, long long B, const Field& f, cudaStream_t stream) {
    const int threads = MXU_WARPS * 32;
    const size_t shared =
        sizeof(uint32_t) * (T * MXU_TOEPLITZ_WORDS + MXU_WARPS * MXU_TILE * MXU_STAGE_STRIDE);
    if (shared > 48 * 1024) {
        // The opt-in is a function attribute of each device: set once a device
        // (so not again inside a CUDA graph's capture).
        static bool opted_in[64] = {};
        int device = 0;
        cudaError_t err = cudaGetDevice(&device);
        if (err != cudaSuccess) return (int)err;
        if (device >= 64) return (int)cudaErrorInvalidDevice;
        if (!opted_in[device]) {
            err = cudaFuncSetAttribute(mont_dot_mxu_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
            if (err != cudaSuccess) return (int)err;
            opted_in[device] = true;
        }
    }
    const long long ey = E < 32768 ? E : 32768;
    dim3 grid((unsigned)((B + MXU_BLOCK_INSTANCES - 1) / MXU_BLOCK_INSTANCES), (unsigned)ey,
              (unsigned)((E + ey - 1) / ey));
    mont_dot_mxu_kernel<T><<<grid, threads, shared, stream>>>(
        (const uint32_t*)vals, (const uint32_t*)coeff, (const uint32_t*)qc, (uint32_t*)out, E, B, f);
    return (int)cudaGetLastError();
}

// The bytes of dynamic shared memory a block of a T-term panel takes.
extern "C" int acvm_dot_mxu_shared_bytes(int T) {
    return (int)(sizeof(uint32_t) * (T * MXU_TOEPLITZ_WORDS + MXU_WARPS * MXU_TILE * MXU_STAGE_STRIDE));
}

extern "C" int acvm_mont_dot_mxu(const void* vals, const void* coeff, const void* qc, void* out,
                                 long long E, long long B, int T, const uint32_t* field_words,
                                 void* stream) {
    if (E <= 0 || B <= 0) return 0;
    const Field f = field_from_words(field_words);
    cudaStream_t s = (cudaStream_t)stream;
    switch (T) {
        case 1: return launch_dot_mxu<1>(vals, coeff, qc, out, E, B, f, s);
        case 2: return launch_dot_mxu<2>(vals, coeff, qc, out, E, B, f, s);
        case 3: return launch_dot_mxu<3>(vals, coeff, qc, out, E, B, f, s);
        case 4: return launch_dot_mxu<4>(vals, coeff, qc, out, E, B, f, s);
        case 5: return launch_dot_mxu<5>(vals, coeff, qc, out, E, B, f, s);
        case 6: return launch_dot_mxu<6>(vals, coeff, qc, out, E, B, f, s);
        case 7: return launch_dot_mxu<7>(vals, coeff, qc, out, E, B, f, s);
        case 8: return launch_dot_mxu<8>(vals, coeff, qc, out, E, B, f, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
