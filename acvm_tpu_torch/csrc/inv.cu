// Field inverse by constant-time divsteps: out[i] = a[i]^-1 R for a canonical
// a[i] R (Montgomery form), 0 -> 0.
//
// Replaces the JAX package's `fields/jnp_ops.py::LimbContext.mont_inv` in
// wide mode (a Fermat chain of 256 steps; its Pallas route refuses wide
// fields), which the port ran as `pow_wide` (`pow.cu` with -DACVM_WIDE): ~319
// dependent wide Montgomery products a value, one chain a thread, at 97 % of
// that chain's latency floor.  Here one thread runs `inv.cuh`'s 20 batches of
// 30 divsteps on 32-bit words and a 9-limb update of (f, g) and (d, e) after
// each: ~20,400 int32 operations a value (fields/kernels.py::INV_OPS), all
// lanes the same steps.
//
// Bound.  Bytes: 64 a value (read a R, write a^-1 R).  Operations: INV_OPS a
// value against 16.7e12 int32 operations/s; at a solve's 8,192 values that is
// ~0.010 ms, below one warp's latency through the chain, so the latency of a
// lone warp's inversion (a launch of 32 values) is the floor.  One-warp
// blocks: 8,192 values are 256 blocks over all 132 SMs, where `pow_wide`'s
// 128-thread blocks put 64 blocks on 64 SMs.
//
// Compiled by nvcc for the card; a CPU build (tests/test_torch_inv_c.py)
// compiles the same file with g++ against a stub cuda_runtime.h that defines
// `INV_LAUNCH` as a host loop over the grid.
#include "field.cuh"
#include "inv.cuh"

#define INV_THREADS 32

#ifdef __CUDACC__
#define INV_LAUNCH(kernel, blocks, threads, stream, ...) \
    kernel<<<(blocks), (threads), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

__global__ void __launch_bounds__(INV_THREADS)
inv_wide_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n,
                const __grid_constant__ InvConstants c) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[ACVM_LIMBS];
    load_fe(x, a + i * ACVM_LIMBS);
    inv_divsteps(x, x, c);
    store_fe(out + i * ACVM_LIMBS, x);
}

// a, out: n elements of 8 words; constant_words: the 9 + 9 + 1 words
// [M | R^2 mod M | M^-1 mod 2^30] (signed 30-bit limbs); the stream.  Returns
// cudaGetLastError().
extern "C" int acvm_inv_wide(const void* a, void* out, long long n, const int32_t* constant_words,
                             void* stream) {
    if (n <= 0) return 0;
    InvConstants c;
    for (int i = 0; i < INV_LIMBS; ++i) {
        c.m[i] = constant_words[i];
        c.r2[i] = constant_words[INV_LIMBS + i];
    }
    c.m_inv30 = (uint32_t)constant_words[2 * INV_LIMBS];
    const long long blocks = (n + INV_THREADS - 1) / INV_THREADS;
    INV_LAUNCH(inv_wide_kernel, (unsigned)blocks, INV_THREADS, stream, (const uint32_t*)a,
               (uint32_t*)out, n, c);
    return (int)cudaGetLastError();
}
