// First-generation elementwise Montgomery multiply, BN254 Fr only:
// out[i] = a[i] * b[i] * R^-1 mod p for two equal-shaped arrays.
//
// Replaces acvm_tpu/fields/pallas_mul.py::_make_kernel (mont_mul_pallas and
// its _flex wrapper).  Like its reference it knows one field: the modulus is
// a compile-time constant, so every limb of p is an immediate operand.  The
// reference's padding to 512-row tiles was the TPU's; any n >= 1 runs here.
// One thread owns one element: 96 bytes against 136 multiply-adds, bound by
// the integer pipes.  The v1 route of the expression evaluation pre-multiplies
// the operands of quadratic terms with it (dot_v1.cu takes the products).
#include "field.cuh"

__device__ __forceinline__ Field bn254_fr() {
    // p = 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001
    return Field{
        {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
         0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
        {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
         0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
        0xefffffffu};
}

__global__ void mont_mul_v1_kernel(const uint32_t* __restrict__ a,
                                   const uint32_t* __restrict__ b,
                                   uint32_t* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Field f = bn254_fr();
    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS];
    load_fe(x, a + i * ACVM_LIMBS);
    load_fe(y, b + i * ACVM_LIMBS);
    mont_mul(x, x, y, f);
    store_fe(out + i * ACVM_LIMBS, x);
}

extern "C" int acvm_mont_mul_v1(const void* a, const void* b, void* out, long long n,
                                void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    mont_mul_v1_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
    return (int)cudaGetLastError();
}
