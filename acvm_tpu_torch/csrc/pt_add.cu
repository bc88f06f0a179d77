// Complete Jacobian point addition on an a = 0 short-Weierstrass curve
// (Grumpkin): out[c, :, b] = P[c, :, b] + Q[c, :, b].
//
// Replaces acvm_tpu/tpu/ec_pallas.py::_make_pt_add_kernel (pt_add_pairs).  A
// point is (X, Y, Z) in Montgomery form, Z == 0 encoding infinity.  The
// formula is add-2007-bl with the dbl-2009-l doubling for P == Q, exactly the
// chain of field operations of the reference (every intermediate canonical),
// so X, Y and Z come out bit-identical to it, not just the affine point.
//
// One thread owns one (pair c, instance b): it loads P into registers, runs
// the group law of ec.cuh there (Q is read where it lies, a coordinate when
// the formula first needs it) and stores three coordinates.  No intermediate
// touches device memory.  Either operand at infinity costs no product, P == Q
// costs 8 + 7, a generic pair 16.  At 288 bytes against 16 products a pair the
// integer pipes bound it, not memory.  A launch of few pairs (a tree's last
// rounds) is bound by latency instead: a lone warp waits out its chain of
// dependent products, 0.48 us each with field.cuh's carry-flag product against
// 0.77 us with the C product it replaced (H100, mont_probe.cu).
//
// Each operand comes with its own strides (in 32-bit words) for the point,
// coordinate and instance axes, so the even/odd pairs of one panel (a tree
// round) and two separate panels (a ladder step) are the same kernel with no
// copies, and a panel gathered as (N, B, 3, 8) is read where it lies.  Every
// thread reads its six inputs before it writes, and no other thread touches
// its slots, so `out` may be exactly P or exactly Q (same strides); the
// wrapper refuses any other overlap.
#include "ec.cuh"

struct PointView {
    const uint32_t* base;
    long long point, coord, inst;   // strides in words
};

__global__ void __launch_bounds__(128)
pt_add_kernel(const PointView P, const PointView Q, uint32_t* out, long long o_point,
              long long o_coord, long long o_inst, long long n_pairs, long long B,
              const Field f) {
    const long long c = blockIdx.y + (long long)blockIdx.z * gridDim.y;
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n_pairs || b >= B) return;

    const uint32_t* p = P.base + c * P.point + b * P.inst;
    const uint32_t* q = Q.base + c * Q.point + b * Q.inst;
    uint32_t* o = out + c * o_point + b * o_inst;

    uint32_t x[ACVM_LIMBS], y[ACVM_LIMBS], z[ACVM_LIMBS];
    load_fe(x, p);
    load_fe(y, p + P.coord);
    load_fe(z, p + 2 * P.coord);
    ec_add<0>(x, y, z, q, q + Q.coord, q + 2 * Q.coord, f);
    store_fe(o, x);
    store_fe(o + o_coord, y);
    store_fe(o + 2 * o_coord, z);
}

extern "C" int acvm_pt_add(const void* p, long long p_point, long long p_coord, long long p_inst,
                           const void* q, long long q_point, long long q_coord, long long q_inst,
                           void* out, long long o_point, long long o_coord, long long o_inst,
                           long long n_pairs, long long B, const uint32_t* field_words,
                           void* stream) {
    if (n_pairs <= 0 || B <= 0) return 0;
    const int threads = 128;
    const long long cy = n_pairs < 32768 ? n_pairs : 32768;
    dim3 grid((unsigned)((B + threads - 1) / threads), (unsigned)cy,
              (unsigned)((n_pairs + cy - 1) / cy));
    PointView P{(const uint32_t*)p, p_point, p_coord, p_inst};
    PointView Q{(const uint32_t*)q, q_point, q_coord, q_inst};
    pt_add_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        P, Q, (uint32_t*)out, o_point, o_coord, o_inst, n_pairs, B,
        field_from_words(field_words));
    return (int)cudaGetLastError();
}
