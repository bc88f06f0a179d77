// Euclidean division of 256-bit integers: q = a / b, r = a mod b for every
// element of two contiguous (n, 8) limb panels; q = r = 0 where b = 0 (the
// Quotient directive's convention).  Only bits below `num_bits` of a are read.
//
// Replaces the JAX package's `tpu/intops.py::long_divmod`, a `fori_loop` of
// num_bits restoring-division steps over the whole panel that XLA runs as one
// loop on the TPU; the port's eager copy of it is some 20 tensor ops a step,
// 4,000-5,000 launches for a quotient level.  Here it is one launch.
//
// One thread owns one element: a, b, the remainder and the quotient stay in
// registers for the whole division.  A step doubles the remainder and brings
// in the next bit of a (an add.cc chain; the remainder is at most a >> 1
// before the last step, so nothing leaves the top), subtracts b (a sub.cc
// chain), keeps the difference where it did not borrow, and shifts that
// verdict into the quotient.  A thread starts at its dividend's highest set
// bit: the steps above it leave remainder and quotient zero, so the bits are
// the same and the Quotient directive's dividends below 2^65 take 65 steps,
// not 256.
//
// Bound: 128 bytes an element (a, b in; q, r out) against the operations the
// data needs: a step for each bit of the dividend, and a step spans only the
// w limbs of the divisor (the remainder stays below it): 3w + 1 int32
// operations to double, subtract, select and set the quotient bit.  At the
// Quotient's 65-bit dividends over 2^32 that is 7 a step, so the bytes bound
// it.  This design runs all 8 limbs a step (~35 dependent instructions), so
// it stays compute-shaped and well short of that bound (PERF.md, row 10); a
// step cut to the divisor's limbs is what a faster version would do.  Every
// step stays in registers, with no memory access between loads and stores.
#include "field.cuh"

__device__ __forceinline__ void divmod_step(uint32_t rem[ACVM_LIMBS], uint32_t quo[ACVM_LIMBS],
                                            const uint32_t b[ACVM_LIMBS], uint32_t bit) {
    add_limbs(rem, rem, rem);
    rem[0] |= bit;
    uint32_t d[ACVM_LIMBS];
    const bool ge = sub_limbs(d, rem, b) == 0;  // 2 rem + bit >= b
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) rem[j] = ge ? d[j] : rem[j];
    add_limbs(quo, quo, quo);
    quo[0] |= (uint32_t)ge;
}

__global__ void divmod_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ q, uint32_t* __restrict__ r, long long n,
                              int num_bits) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS];
    uint32_t rem[ACVM_LIMBS] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint32_t quo[ACVM_LIMBS] = {0, 0, 0, 0, 0, 0, 0, 0};
    load_fe(x, a + i * ACVM_LIMBS);
    load_fe(y, b + i * ACVM_LIMBS);
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) {  // the bits of a below num_bits
        const int keep = num_bits - 32 * j;
        x[j] = keep >= 32 ? x[j] : (keep <= 0 ? 0u : x[j] & ((1u << keep) - 1u));
    }
    if (!is_zero(y)) {
        bool started = false;
#pragma unroll
        for (int j = ACVM_LIMBS - 1; j >= 0; --j) {  // static limb index: x stays in registers
            const uint32_t word = x[j];
            int bit = started ? 31 : (word ? 31 - __clz(word) : -1);
            started = started || word != 0;
            for (; bit >= 0; --bit) divmod_step(rem, quo, y, (word >> bit) & 1u);
        }
    }
    store_fe(q + i * ACVM_LIMBS, quo);
    store_fe(r + i * ACVM_LIMBS, rem);
}

extern "C" int acvm_divmod(const void* a, const void* b, void* q, void* r, long long n,
                           int num_bits, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    divmod_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)q, (uint32_t*)r, n, num_bits);
    return (int)cudaGetLastError();
}
