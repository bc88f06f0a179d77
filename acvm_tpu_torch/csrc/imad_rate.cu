// Probe, not a kernel of the solver: the rate at which the card issues the
// 32x32->64 multiply-add that the field kernels are made of.  Each thread
// runs eight independent dependent chains (the carry pattern of a CIOS row)
// so the integer pipes stay full; the caller divides the multiply-adds done
// by the time taken.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void imad_rate_kernel(uint32_t* out, int iters, uint32_t y) {
    uint64_t acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = threadIdx.x * 2654435761u + blockIdx.x + k;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = (uint64_t)(uint32_t)acc[k] * y + (acc[k] >> 32);
    }
    uint64_t s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) s ^= acc[k];
    out[blockIdx.x * blockDim.x + threadIdx.x] = (uint32_t)s ^ (uint32_t)(s >> 32);
}

// Launches blocks x threads threads; each does iters * 8 multiply-adds.
extern "C" int acvm_imad_rate(void* out, int blocks, int threads, int iters, void* stream) {
    imad_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((uint32_t*)out, iters,
                                                                   0x9E3779B1u);
    return (int)cudaGetLastError();
}
