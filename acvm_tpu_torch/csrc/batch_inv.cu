// Batch inversion along axis 0 of a contiguous (G, L, 8) panel in Montgomery
// form: out[i, l] = a[i, l]^-1 (as a^-1 R), 0 -> 0, canonical.
//
// Replaces the JAX package's `fields/jnp_ops.py::LimbContext.mont_batch_inv` /
// `_batch_inv_axis0`: prefix and suffix `associative_scan`s over the multiply
// kernel around one Fermat chain of the pow kernel, where the port ran 2g
// sequential multiply launches, a pow launch and a dozen whole-panel passes a
// chunk of g rows.  Here it is one launch.
//
// One thread owns one lane: a chunk of up to g consecutive rows of one column
// l.  Neighbouring threads take neighbouring columns, so every load and store
// of a step is coalesced (32 bytes a thread, two 16-byte accesses); a ragged
// last chunk is masked here.  A lane
//   1. runs forward, a zero replaced by R (the Montgomery one), keeping the
//      running product and writing prefix i to out[i]: one product a value;
//   2. inverts the lane's total with the chain of `pow.cuh` (e = p - 2), in
//      registers;
//   3. runs backward, i = n-1 .. 1: out[i] = out[i-1] * run (0 where a[i] is
//      0), then run = run * b[i] with a[i] read again; finally out[0] = run.
//      out doubles as the prefix scratch: out[i-1] is read before it is
//      overwritten.  Two products a value.
// A lane of n rows costs 3(n - 1) products and one chain; about 5 x 32 bytes
// move per value (a read twice, the prefix written, read back and
// overwritten).  Bound by the integer pipes when lanes fill the card; the
// chunk size trades chains (n / g of them) against a lane's dependent depth
// (3g + ~305 products).  out must not alias a.  Built twice: as `batch_inv`
// over the narrow field and, with -DACVM_WIDE, as `batch_inv_wide`.
#include "pow.cuh"

// Each step's loads are issued one step ahead of its products: at the dyn
// level's 32,768 lanes an SM holds only ~8 warps, too few to hide a load behind
// other warps' products (on an H100 at that level, 0.58-0.59 ms with loads at
// the step, 0.49-0.51 with loads ahead; PERF.md).
__global__ void __launch_bounds__(ACVM_POW_THREADS)
batch_inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long G,
                 long long L, int g, const __grid_constant__ PowSchedule s, const KernelField f) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long chunks = (G + g - 1) / g;
    if (t >= chunks * L) return;
    const long long c = t / L;
    const long long row0 = c * g;
    const int n = (int)min((long long)g, G - row0);
    const long long step = L * ACVM_LIMBS;
    const uint32_t* src = a + (row0 * L + (t - c * L)) * ACVM_LIMBS;
    uint32_t* dst = out + (src - a);

    uint32_t run[ACVM_LIMBS], x[ACVM_LIMBS];
    // 1. forward: prefix products, zeros as R.
    load_fe(run, src);
    if (is_zero(run)) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) run[j] = f.r[j];
    }
    store_fe(dst, run);
    if (n > 1) load_fe(x, src + step);
    for (int i = 1; i < n; ++i) {
        uint32_t next[ACVM_LIMBS];
        if (i + 1 < n) load_fe(next, src + (i + 1) * step);
        if (!is_zero(x)) mont_mul(run, run, x, f);   // times R where x = 0: run itself
        store_fe(dst + i * step, run);
        copy_fe(x, next);
    }

    // 2. the total's inverse.
    {
        uint32_t total[ACVM_LIMBS];
        copy_fe(total, run);
        pow_chain(run, total, s, f);
    }

    // 3. backward: run holds (b[0] ... b[i])^-1 on entry to step i.
    uint32_t prev[ACVM_LIMBS];
    if (n > 1) {
        load_fe(x, src + (n - 1) * step);
        load_fe(prev, dst + (n - 2) * step);
    }
    for (int i = n - 1; i >= 1; --i) {
        uint32_t y[ACVM_LIMBS];
        // Row i - 1's operands, read before this step's product; out[i - 2]
        // is not written before step i - 2.
        uint32_t next_x[ACVM_LIMBS], next_prev[ACVM_LIMBS];
        if (i >= 2) {
            load_fe(next_x, src + (i - 1) * step);
            load_fe(next_prev, dst + (i - 2) * step);
        }
        const bool zero = is_zero(x);
        mont_mul(y, prev, run, f);
        if (zero) {
#pragma unroll
            for (int j = 0; j < ACVM_LIMBS; ++j) y[j] = 0;
        } else {
            mont_mul(run, run, x, f);
        }
        store_fe(dst + i * step, y);
        copy_fe(x, next_x);
        copy_fe(prev, next_prev);
    }
    load_fe(x, src);
    if (is_zero(x)) {
#pragma unroll
        for (int j = 0; j < ACVM_LIMBS; ++j) run[j] = 0;
    }
    store_fe(dst, run);
}

extern "C" int acvm_batch_inv(const void* a, void* out, long long G, long long L, int g,
                              const uint32_t* schedule_words, const uint32_t* field_words,
                              void* stream) {
    if (G <= 0 || L <= 0) return 0;
    if (g < 1) return (int)cudaErrorInvalidValue;
    const long long lanes = (G + g - 1) / g * L;
    const int threads = ACVM_POW_THREADS;
    const long long blocks = (lanes + threads - 1) / threads;
    batch_inv_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, G, L, g, pow_schedule_from_words(schedule_words),
        field_from_words_as<KernelField>(field_words));
    return (int)cudaGetLastError();
}
