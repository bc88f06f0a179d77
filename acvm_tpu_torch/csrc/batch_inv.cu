// Batch inversion along axis 0 of a contiguous (G, L, 8) panel in Montgomery
// form: out[i, l] = a[i, l]^-1 (as a^-1 R), 0 -> 0, canonical.
//
// Replaces the JAX package's `fields/jnp_ops.py::LimbContext.mont_batch_inv` /
// `_batch_inv_axis0`: prefix and suffix `associative_scan`s over the multiply
// kernel around one Fermat chain of the pow kernel.  Here it is one launch.
//
// A lane is a chunk of up to g consecutive rows of one column; a block takes a
// tile of `blockDim.x` lanes, neighbouring columns of one chunk, so every load
// and store of a row is coalesced.  Montgomery's trick runs on two levels:
//   1. each lane runs forward over its rows, a zero replaced by R (the
//      Montgomery one): one product a value; the last prefix is the lane's
//      total;
//   2. the block's lane totals go through the same trick: inclusive prefix
//      and suffix products within each warp by shuffles (five rounds each),
//      the warps' totals through shared memory, and ONE Fermat chain
//      (`pow.cuh`, e = p - 2) on the block's grand total; walked back down, a
//      lane's own inverse is (its warp's prefix before it) (its warp's suffix
//      after it) (the other warps' totals) (the grand total's inverse);
//   3. each lane runs backward, i = n-1 .. 1: out[i] = prefix[i-1] * run (0
//      where a[i] is 0), then run = run * a[i]; finally out[0] = run.  Two
//      products a value, each output written once.
// A block costs one chain where a thread a lane cost one a lane: at the dyn
// level (2,048 x 2,048) 256 chains where a chain a lane of 128 made 32,768.
//
// The prefixes wait in `out` (written forward, read back backward) through the
// chain.  Built twice: as `batch_inv` over the narrow field and, with
// -DACVM_WIDE, as `batch_inv_wide`.
#include "pow.cuh"

#define FULL_WARP 0xffffffffu
#define INV_MAX_LANES 256   // chunks a block; 256 threads leave a thread 255 registers

__device__ __forceinline__ void shfl_fe(uint32_t r[ACVM_LIMBS], const uint32_t x[ACVM_LIMBS],
                                        int delta, bool up) {
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j)
        r[j] = up ? __shfl_up_sync(FULL_WARP, x[j], delta) : __shfl_down_sync(FULL_WARP, x[j], delta);
}

// r = 0 where x is 0 (a zero's output), else r as it is.
__device__ __forceinline__ void zero_where(uint32_t r[ACVM_LIMBS], bool zero) {
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) r[j] = zero ? 0u : r[j];
}

__global__ void __launch_bounds__(INV_MAX_LANES)
batch_inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long G,
                 long long L, int g, const __grid_constant__ PowSchedule s, const KernelField f) {
    __shared__ uint4 warp_totals[2 * (INV_MAX_LANES / 32)];   // [warp][half]
    __shared__ uint4 grand_inv[2];                            // [half]

    const int T = blockDim.x, l = threadIdx.x, lane = l & 31, w = l >> 5, nw = T >> 5;
    const long long col_tiles = (L + T - 1) / T;
    const long long c = blockIdx.x / col_tiles;
    const long long col = (blockIdx.x - c * col_tiles) * T + l;
    const bool live = col < L;
    const long long row0 = c * g;
    const int n = (int)min((long long)g, G - row0);
    const long long step = L * ACVM_LIMBS;
    const uint32_t* src = a + (row0 * L + col) * ACVM_LIMBS;
    uint32_t* dst = out + (row0 * L + col) * ACVM_LIMBS;

    // 1. forward: prefix products, zeros as R; a masked lane's total is R.
    uint32_t run[ACVM_LIMBS], x[ACVM_LIMBS];
    copy_fe(run, f.r);
    if (live) {
        // Each step's loads issued one step ahead of its product.
        load_fe(x, src);
        if (!is_zero(x)) copy_fe(run, x);
        store_fe(dst, run);
        if (n > 1) load_fe(x, src + step);
        for (int i = 1; i < n; ++i) {
            uint32_t next[ACVM_LIMBS];
            if (i + 1 < n) load_fe(next, src + (i + 1) * step);
            if (!is_zero(x)) mont_mul(run, run, x, f);
            if (i + 1 < n) store_fe(dst + i * step, run);   // the last prefix is the total
            copy_fe(x, next);
        }
    }

    // 2. the totals: inclusive prefix q and suffix r within the warp.
    uint32_t q[ACVM_LIMBS], r[ACVM_LIMBS], y[ACVM_LIMBS];
    copy_fe(q, run);
    copy_fe(r, run);
#pragma unroll 1
    for (int d = 1; d < 32; d <<= 1) {   // no lane below d (above 31 - d): times R
        uint32_t z[ACVM_LIMBS];
        shfl_fe(y, q, d, true);
        if (lane < d) copy_fe(y, f.r);
        shfl_fe(z, r, d, false);
        if (lane + d >= 32) copy_fe(z, f.r);
        mont_mul(q, y, q, f);
        mont_mul(r, r, z, f);
    }
    if (lane == 31) {
        warp_totals[2 * w] = make_uint4(q[0], q[1], q[2], q[3]);
        warp_totals[2 * w + 1] = make_uint4(q[4], q[5], q[6], q[7]);
    }
    // The lane's product of every other lane's total in its warp: prefix
    // before it times suffix after it (R at the ends).
    shfl_fe(y, q, 1, true);
    shfl_fe(x, r, 1, false);
    if (lane == 0) copy_fe(y, f.r);
    if (lane == 31) copy_fe(x, f.r);
    mont_mul(y, y, x, f);
    __syncthreads();
    // Times the other warps' totals (the same for the whole warp).
    bool others = false;
    uint32_t k[ACVM_LIMBS];
#pragma unroll 1
    for (int v = 0; v < nw; ++v) {
        if (v == w) continue;
        const uint4 lo = warp_totals[2 * v], hi = warp_totals[2 * v + 1];
        const uint32_t t[ACVM_LIMBS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (others) mont_mul(k, k, t, f);
        else copy_fe(k, t);
        others = true;
    }
    if (others) mont_mul(y, y, k, f);
    // One chain for the block: the grand total is warp 0's other warps' totals
    // times warp 0's own.
    if (l == 0) {
        const uint4 lo = warp_totals[0], hi = warp_totals[1];
        uint32_t total[ACVM_LIMBS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (others) mont_mul(total, total, k, f);
        pow_chain(x, total, s, f);
        grand_inv[0] = make_uint4(x[0], x[1], x[2], x[3]);
        grand_inv[1] = make_uint4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();
    {
        const uint4 lo = grand_inv[0], hi = grand_inv[1];
        const uint32_t t[ACVM_LIMBS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        mont_mul(run, y, t, f);         // the inverse of this lane's total
    }
    if (!live) return;

    // 3. backward: run holds (b[0] ... b[i])^-1 on entry to step i.
    uint32_t prev[ACVM_LIMBS];
    if (n > 1) {
        load_fe(x, src + (n - 1) * step);
        load_fe(prev, dst + (n - 2) * step);
    }
    for (int i = n - 1; i >= 1; --i) {
        // Row i - 1's operands, read before this step's product; out[i - 2]
        // is not written before step i - 2.
        uint32_t next_x[ACVM_LIMBS], next_prev[ACVM_LIMBS];
        if (i >= 2) {
            load_fe(next_x, src + (i - 1) * step);
            load_fe(next_prev, dst + (i - 2) * step);
        }
        const bool zero = is_zero(x);
        mont_mul(y, prev, run, f);
        zero_where(y, zero);
        if (!zero) mont_mul(run, run, x, f);
        store_fe(dst + i * step, y);
        copy_fe(x, next_x);
        copy_fe(prev, next_prev);
    }
    load_fe(x, src);
    zero_where(run, is_zero(x));
    store_fe(dst, run);
}

// g rows a chunk, `lanes` chunks a block (a multiple of 32, at most 256):
// the plan of fields/kernels.py::batch_inv_plan.
extern "C" int acvm_batch_inv(const void* a, void* out, long long G, long long L, int g,
                              int lanes, const uint32_t* schedule_words,
                              const uint32_t* field_words, void* stream) {
    if (G <= 0 || L <= 0) return 0;
    if (g < 1 || lanes < 32 || lanes > INV_MAX_LANES || lanes % 32) return (int)cudaErrorInvalidValue;
    const long long blocks = (G + g - 1) / g * ((L + lanes - 1) / lanes);
    batch_inv_kernel<<<(unsigned)blocks, lanes, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, G, L, g, pow_schedule_from_words(schedule_words),
        field_from_words_as<KernelField>(field_words));
    return (int)cudaGetLastError();
}
