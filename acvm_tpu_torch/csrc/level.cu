// One arith-static level, in place on the witness-major panel (NW, B, 8):
//
//   panel[out_idx[g], b] = qc[g] + sum_t lc[g, t] * panel[lin_idx[g, t], b]
//                        + sum_k mc[g, k] * (panel[m1[g, k], b] * panel[m2[g, k], b])
//
// Replaces acvm_tpu/tpu/fused_level.py::_make_level_kernel.  A gate's
// descriptor row is
//   [lin_idx t1 | mul_idx 2*t2 | out_idx | lin_coeff 8*t1 | mul_coeff 8*t2 | qc 8].
//
// Blocks that stay.  A block of 128 threads takes one chunk of 128 instances
// and walks up to LEVEL_GATES consecutive gates (fewer where 48 KB of shared
// memory hold fewer rows); one thread owns one instance of each.  The rows of
// those gates are contiguous in `desc` and come into shared memory with one
// sweep of cp.async copies; a second short pass notes which terms of each
// gate have a nonzero coefficient.  Two barriers a block, none in the gate
// loop.  A warp's operand loads are contiguous whichever row a gate names (the
// instance is the fastest axis of the panel).
//
// Operands in flight.  For the common shape (2 linear terms, 1 product) the
// term loops are unrolled and all of a gate's operand rows (up to four) are
// requested before its first product; at 74 registers six blocks share an SM
// and the other warps hide the latency.  Requesting the NEXT gate's rows
// before this gate's products (ACVM_LEVEL_PREFETCH=1, two operand buffers
// taking turns) holds 44 more registers and measured slower: 1.37 against
// 1.20 ms at 15,709 gates x 2,048 instances on an H100.  Other shapes run
// runtime term loops and load as they go.
//
// One reduction a gate.  For that shape a gate's coefficient x value products
// go through field.cuh's mont_mul_sum: every row adds all live terms before
// the one m * p that reduces it, so a gate of T terms pays one reduction and
// one conditional subtract, not T.  For a product term, v * w is reduced first
// (it has to be, before its coefficient) and coefficient x (v w) is one of the
// terms.  The unreduced running sum of T terms needs (T + 1) p < 2^256, which
// the launcher checks from the modulus' top limb: BN254 takes the three terms
// of the common shape, BLS12-381 (p > 2^254) does not and runs the other
// kernel.  There each term is one product and one modular add, so any term
// count is exact.  Gates of one level are packed to the widest; a term with a
// zero coefficient is such padding and is skipped, operand loads and all (the
// coefficient is the same for the whole block, so no warp diverges).
//
// Blocks run in any order and a block may read a gate's operands before it
// has stored the gate before: a level's reads never alias its writes, because
// the planner solves each witness exactly once, before any use.
//
// Per (gate, instance): 32 bytes per operand in, 32 out; 64 wide multiply-adds
// a live term, 128 more for a product term's v * w, 64 for the reduction.  At
// 2-3 terms the integer pipes bound it, not the bytes.
//
// Measurement switches, off in every build of the solver: ACVM_LEVEL_NO_PRODUCTS
// keeps the loads and the store and folds the operands with xor;
// ACVM_LEVEL_CACHED_OPERANDS keeps the arithmetic and the load operations but
// reads every operand from panel row 0 (which stays in cache) and never
// stores; ACVM_LEVEL_GATES_FASTEST makes neighbouring blocks walk neighbouring
// gates of one instance chunk instead of neighbouring chunks;
// ACVM_LEVEL_PREFETCH=1 loads the next gate's operands ahead;
// ACVM_LEVEL_THREADS sets the instances a block takes.
#include "field.cuh"

#ifndef ACVM_LEVEL_PREFETCH
#define ACVM_LEVEL_PREFETCH 0
#endif

#ifndef ACVM_LEVEL_THREADS
#define ACVM_LEVEL_THREADS 128
#endif

constexpr int LEVEL_THREADS = ACVM_LEVEL_THREADS;
constexpr int LEVEL_GATES = 16;

__device__ __forceinline__ void cp_async_4(uint32_t* smem, const int32_t* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_16(uint32_t* smem, const int32_t* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy_fe(uint32_t dst[ACVM_LIMBS], const uint32_t* src) {
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) dst[j] = src[j];
}

__device__ __forceinline__ bool is_zero_at(const uint32_t* src) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) acc |= src[j];
    return acc == 0;
}

__device__ __forceinline__ void load_operand(uint32_t v[ACVM_LIMBS], const uint32_t* panel,
                                             uint32_t row, long long B, long long b) {
#ifdef ACVM_LEVEL_CACHED_OPERANDS
    row = 0;
#endif
    load_fe(v, panel + ((long long)row * B + b) * ACVM_LIMBS);
}

// v <- v * w, the operand pair of a product term.
__device__ __forceinline__ void gate_product(uint32_t v[ACVM_LIMBS], const uint32_t w[ACVM_LIMBS],
                                             const Field& f) {
#ifdef ACVM_LEVEL_NO_PRODUCTS
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) v[j] ^= w[j];
#else
    mont_mul(v, v, w, f);
#endif
}

// sum <- sum + coefficient * v: one product, one modular add.
__device__ __forceinline__ void gate_term(uint32_t sum[ACVM_LIMBS], const uint32_t* coeff,
                                          uint32_t v[ACVM_LIMBS], const Field& f) {
#ifdef ACVM_LEVEL_NO_PRODUCTS
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) sum[j] ^= v[j] & coeff[j];
#else
    uint32_t c[ACVM_LIMBS];
    copy_fe(c, coeff);
    mont_mul(v, c, v, f);
    add_mod(sum, sum, v, f);
#endif
}

__device__ __forceinline__ void store_gate(uint32_t* panel, uint32_t out_idx, long long B,
                                           long long b, const uint32_t sum[ACVM_LIMBS]) {
#ifdef ACVM_LEVEL_CACHED_OPERANDS
    if ((sum[0] & sum[7]) != 0xFFFFFFFFu) return;   // canonical: never stores
#endif
    store_fe(panel + ((long long)out_idx * B + b) * ACVM_LIMBS, sum);
}

// Request the operand loads of one gate's live terms (bit t of `live`: term t,
// linear terms first, has a nonzero coefficient).
template <int CT1, int CT2>
__device__ __forceinline__ void load_gate(uint32_t (*ops)[ACVM_LIMBS], const uint32_t* row,
                                          uint32_t live, const uint32_t* panel, long long B,
                                          long long b) {
#pragma unroll
    for (int t = 0; t < CT1; ++t)
        if (live & (1u << t)) load_operand(ops[t], panel, row[t], B, b);
#pragma unroll
    for (int t = 0; t < CT2; ++t)
        if (live & (1u << (CT1 + t))) {
            load_operand(ops[CT1 + 2 * t], panel, row[CT1 + 2 * t], B, b);
            load_operand(ops[CT1 + 2 * t + 1], panel, row[CT1 + 2 * t + 1], B, b);
        }
}

// One gate of the unrolled shape from operands already in registers.
template <int CT1, int CT2>
__device__ __forceinline__ void solve_gate(uint32_t (*ops)[ACVM_LIMBS], const uint32_t* row,
                                           uint32_t live, uint32_t* panel, long long B,
                                           long long b, const Field& f) {
    constexpr int TERMS = CT1 + CT2, off_out = CT1 + 2 * CT2, off_lc = off_out + 1;
    constexpr int off_qc = off_lc + ACVM_LIMBS * TERMS;
    uint32_t sum[ACVM_LIMBS];
    copy_fe(sum, row + off_qc);
#pragma unroll
    for (int t = 0; t < CT2; ++t)
        if (live & (1u << (CT1 + t))) gate_product(ops[CT1 + 2 * t], ops[CT1 + 2 * t + 1], f);
#ifdef ACVM_LEVEL_NO_PRODUCTS
#pragma unroll
    for (int t = 0; t < TERMS; ++t)
        if (live & (1u << t))
            gate_term(sum, row + off_lc + ACVM_LIMBS * t, ops[t < CT1 ? t : 2 * t - CT1], f);
#else
    if (live) {
        // Term t reads ops[t] (linear) or the product left in ops[CT1 + 2k]; its
        // coefficient is the t-th of the row's (linear ones first).
        const uint32_t* a_of[TERMS];
        const uint32_t* c_of[TERMS];
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
            a_of[t] = ops[t < CT1 ? t : 2 * t - CT1];
            c_of[t] = row + off_lc + ACVM_LIMBS * t;
        }
        uint32_t r[ACVM_LIMBS];
        mont_mul_sum_of<TERMS>(r, a_of, c_of, live, f);
        add_mod(sum, sum, r, f);
    }
#endif
    store_gate(panel, row[off_out], B, b, sum);
}

// CT1, CT2 >= 0: the term counts are these constants, the loops unroll and the
// next gate's operands are loaded ahead.  CT1 < 0: runtime counts t1, t2.
template <int CT1, int CT2>
__global__ void __launch_bounds__(LEVEL_THREADS)
fused_level_kernel(uint32_t* panel, const int32_t* __restrict__ desc, long long E, long long B,
                   int t1_arg, int t2_arg, int dw, int gates, long long chunks, int vector_copy,
                   const Field f) {
    extern __shared__ __align__(16) uint32_t rows[];
    const int t1 = CT1 >= 0 ? CT1 : t1_arg;
    const int t2 = CT1 >= 0 ? CT2 : t2_arg;
#ifdef ACVM_LEVEL_GATES_FASTEST
    const long long groups = (E + gates - 1) / gates;
    const long long chunk = blockIdx.x / groups, group = blockIdx.x % groups;
#else
    const long long chunk = blockIdx.x % chunks, group = blockIdx.x / chunks;
#endif
    const long long g0 = group * gates;
    const int n_gates = (int)(E - g0 < gates ? E - g0 : gates);
    const int n_words = n_gates * dw;
    const int32_t* src = desc + g0 * dw;
    int done = 0;
    if (vector_copy) {   // the block's rows start on a 16-byte boundary
        done = n_words & ~3;
        for (int i = 4 * threadIdx.x; i < done; i += 4 * LEVEL_THREADS) cp_async_16(rows + i, src + i);
    }
    for (int i = done + threadIdx.x; i < n_words; i += LEVEL_THREADS) cp_async_4(rows + i, src + i);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    const int off_out = t1 + 2 * t2, off_lc = off_out + 1;
    const int off_mc = off_lc + ACVM_LIMBS * t1, off_qc = off_mc + ACVM_LIMBS * t2;
    const long long b = chunk * LEVEL_THREADS + threadIdx.x;

    if constexpr (CT1 >= 0) {
        // Which terms of each gate are live, worked out once a block.
        uint32_t* live_of = rows + gates * dw;
        if (threadIdx.x < n_gates) {
            const uint32_t* row = rows + threadIdx.x * dw;
            uint32_t live = 0;
#pragma unroll
            for (int t = 0; t < CT1 + CT2; ++t)
                if (!is_zero_at(row + off_lc + ACVM_LIMBS * t)) live |= 1u << t;
            live_of[threadIdx.x] = live;
        }
        __syncthreads();
        if (b >= B) return;
        // Two operand buffers take turns: while one gate is computed from one,
        // the next gate's rows arrive in the other.
        uint32_t ops[2][CT1 + 2 * CT2][ACVM_LIMBS];
#if ACVM_LEVEL_PREFETCH
        load_gate<CT1, CT2>(ops[0], rows, live_of[0], panel, B, b);
#pragma unroll 1
        for (int g = 0; g < n_gates; g += 2) {
            const uint32_t* row = rows + g * dw;
            if (g + 1 < n_gates) load_gate<CT1, CT2>(ops[1], row + dw, live_of[g + 1], panel, B, b);
            solve_gate<CT1, CT2>(ops[0], row, live_of[g], panel, B, b, f);
            if (g + 1 < n_gates) {
                if (g + 2 < n_gates)
                    load_gate<CT1, CT2>(ops[0], row + 2 * dw, live_of[g + 2], panel, B, b);
                solve_gate<CT1, CT2>(ops[1], row + dw, live_of[g + 1], panel, B, b, f);
            }
        }
#else
#pragma unroll 1
        for (int g = 0; g < n_gates; ++g) {
            const uint32_t* row = rows + g * dw;
            load_gate<CT1, CT2>(ops[0], row, live_of[g], panel, B, b);
            solve_gate<CT1, CT2>(ops[0], row, live_of[g], panel, B, b, f);
        }
#endif
    } else {
        if (b >= B) return;
        uint32_t sum[ACVM_LIMBS], v[ACVM_LIMBS], w[ACVM_LIMBS];
#pragma unroll 1
        for (int g = 0; g < n_gates; ++g) {
            const uint32_t* row = rows + g * dw;
            copy_fe(sum, row + off_qc);
#pragma unroll 1
            for (int t = 0; t < t1; ++t) {
                const uint32_t* c = row + off_lc + ACVM_LIMBS * t;
                if (is_zero_at(c)) continue;   // a padding term; the whole block skips it
                load_operand(v, panel, row[t], B, b);
                gate_term(sum, c, v, f);
            }
#pragma unroll 1
            for (int t = 0; t < t2; ++t) {
                const uint32_t* c = row + off_mc + ACVM_LIMBS * t;
                if (is_zero_at(c)) continue;
                load_operand(v, panel, row[t1 + 2 * t], B, b);
                load_operand(w, panel, row[t1 + 2 * t + 1], B, b);
                gate_product(v, w, f);
                gate_term(sum, c, v, f);
            }
            store_gate(panel, row[off_out], B, b, sum);
        }
    }
}

extern "C" int acvm_fused_level(void* panel, const void* desc, long long E, long long B, int t1,
                                int t2, const uint32_t* field_words, void* stream) {
    if (E <= 0 || B <= 0) return 0;
    const int dw = t1 + 2 * t2 + 1 + ACVM_LIMBS * (t1 + t2 + 1);
    if (((size_t)dw + LEVEL_GATES) * sizeof(uint32_t) > 48 * 1024) return (int)cudaErrorInvalidValue;   // > 1,300 terms a gate
    int gates = (int)((48 * 1024 - LEVEL_GATES * sizeof(uint32_t)) / ((size_t)dw * sizeof(uint32_t)));
    if (gates > LEVEL_GATES) gates = LEVEL_GATES;
    const size_t smem = ((size_t)gates * dw + LEVEL_GATES) * sizeof(uint32_t);   // rows, then live masks
    const long long chunks = (B + LEVEL_THREADS - 1) / LEVEL_THREADS;
    const long long groups = (E + gates - 1) / gates;
    if (chunks * groups > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const Field f = field_from_words(field_words);
    // The unrolled kernel sums three terms unreduced: (3 + 1) p < 2^256, judged
    // from the top limb (p < (p7 + 1) 2^224).
    const bool sums_fit = 4ULL * ((unsigned long long)f.p[ACVM_LIMBS - 1] + 1) <= 0x100000000ULL;
    const int vector_copy =
        (reinterpret_cast<uintptr_t>(desc) % 16 == 0) && ((gates * dw) % 4 == 0);
    const unsigned grid = (unsigned)(chunks * groups);
    cudaStream_t s = (cudaStream_t)stream;
    if (t1 == 2 && t2 == 1 && sums_fit) {
        fused_level_kernel<2, 1><<<grid, LEVEL_THREADS, smem, s>>>(
            (uint32_t*)panel, (const int32_t*)desc, E, B, t1, t2, dw, gates, chunks, vector_copy, f);
    } else {
        fused_level_kernel<-1, -1><<<grid, LEVEL_THREADS, smem, s>>>(
            (uint32_t*)panel, (const int32_t*)desc, E, B, t1, t2, dw, gates, chunks, vector_copy, f);
    }
    return (int)cudaGetLastError();
}
