// Complete Jacobian point addition on an a = 0 short-Weierstrass curve
// (Grumpkin): out[c, :, b] = P[c, :, b] + Q[c, :, b].
//
// Replaces acvm_tpu/tpu/ec_pallas.py::_make_pt_add_kernel (pt_add_pairs).  A
// point is (X, Y, Z) in Montgomery form, Z == 0 encoding infinity.  The
// formula is add-2007-bl with the dbl-2009-l doubling for P == Q, exactly the
// chain of field operations of the reference (every intermediate canonical),
// so X, Y and Z come out bit-identical to it, not just the affine point.
//
// One thread owns one (pair c, instance b): it loads the six coordinates into
// registers, runs the whole chain there and stores three.  No intermediate
// touches device memory.  Where the reference computes the doubling for every
// lane and selects, a thread here branches: either operand at infinity costs
// no product, P == Q costs 8 + 7, a generic pair 16.  At 288 bytes against
// 16 products (2,176 multiply-adds) a pair the integer pipes bound it.
//
// Each operand comes with its own strides (in 32-bit words) for the point,
// coordinate and instance axes, so the even/odd pairs of one panel (a tree
// round) and two separate panels (a ladder step) are the same kernel with no
// copies, and a panel gathered as (N, B, 3, 8) is read where it lies.  Every
// thread reads its six inputs before it writes, and no other thread touches
// its slots, so `out` may be exactly P or exactly Q (same strides); the
// wrapper refuses any other overlap.
#include "field.cuh"

struct PointView {
    const uint32_t* base;
    long long point, coord, inst;   // strides in words
};

__device__ __forceinline__ void dbl_mod(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                        const Field& f) {
    add_mod(r, a, a, f);
}

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

    uint32_t x1[ACVM_LIMBS], y1[ACVM_LIMBS], z1[ACVM_LIMBS];
    uint32_t x2[ACVM_LIMBS], y2[ACVM_LIMBS], z2[ACVM_LIMBS];
    load_fe(x1, p);
    load_fe(y1, p + P.coord);
    load_fe(z1, p + 2 * P.coord);
    load_fe(x2, q);
    load_fe(y2, q + Q.coord);
    load_fe(z2, q + 2 * Q.coord);

    // Identities first (the reference's last selects: Q at infinity wins).
    if (is_zero(z2)) {
        store_fe(o, x1);
        store_fe(o + o_coord, y1);
        store_fe(o + 2 * o_coord, z1);
        return;
    }
    if (is_zero(z1)) {
        store_fe(o, x2);
        store_fe(o + o_coord, y2);
        store_fe(o + 2 * o_coord, z2);
        return;
    }

    uint32_t z1z1[ACVM_LIMBS], z2z2[ACVM_LIMBS], u1[ACVM_LIMBS], s1[ACVM_LIMBS];
    uint32_t h[ACVM_LIMBS], rr[ACVM_LIMBS], t[ACVM_LIMBS];
    mont_mul(z1z1, z1, z1, f);
    mont_mul(z2z2, z2, z2, f);
    mont_mul(u1, x1, z2z2, f);
    mont_mul(t, x2, z1z1, f);        // U2
    sub_mod(h, t, u1, f);            // H = U2 - U1
    mont_mul(s1, y1, z2, f);
    mont_mul(s1, s1, z2z2, f);       // S1
    mont_mul(t, y2, z1, f);
    mont_mul(t, t, z1z1, f);         // S2
    sub_mod(rr, t, s1, f);           // r = S2 - S1

    uint32_t x3[ACVM_LIMBS], y3[ACVM_LIMBS], z3[ACVM_LIMBS];
    if (is_zero(h) && is_zero(rr)) {
        // P == Q: dbl-2009-l on P (mirrors ec.pt_double, a = 0).
        uint32_t A[ACVM_LIMBS], Bv[ACVM_LIMBS], C[ACVM_LIMBS], D[ACVM_LIMBS], E[ACVM_LIMBS];
        mont_mul(A, x1, x1, f);
        mont_mul(Bv, y1, y1, f);
        mont_mul(C, Bv, Bv, f);
        add_mod(t, x1, Bv, f);
        mont_mul(t, t, t, f);
        sub_mod(D, t, A, f);
        sub_mod(D, D, C, f);
        dbl_mod(D, D, f);            // D = 2((X + B)^2 - A - C)
        dbl_mod(E, A, f);
        add_mod(E, E, A, f);         // E = 3A
        mont_mul(x3, E, E, f);       // F
        dbl_mod(t, D, f);
        sub_mod(x3, x3, t, f);       // X3 = F - 2D
        dbl_mod(C, C, f);
        dbl_mod(C, C, f);
        dbl_mod(C, C, f);            // 8C
        sub_mod(t, D, x3, f);
        mont_mul(y3, E, t, f);
        sub_mod(y3, y3, C, f);       // Y3 = E(D - X3) - 8C
        mont_mul(z3, y1, z1, f);
        dbl_mod(z3, z3, f);          // Z3 = 2 Y1 Z1
    } else {
        // add-2007-bl (mirrors ec.pt_add).  P == -Q has H == 0 and r != 0:
        // the last product makes Z3 = 0, the reference's explicit select.
        uint32_t I[ACVM_LIMBS], J[ACVM_LIMBS], V[ACVM_LIMBS];
        dbl_mod(I, h, f);
        mont_mul(I, I, I, f);        // I = (2H)^2
        mont_mul(J, h, I, f);
        dbl_mod(rr, rr, f);          // r2 = 2r
        mont_mul(V, u1, I, f);
        mont_mul(x3, rr, rr, f);
        sub_mod(x3, x3, J, f);
        dbl_mod(t, V, f);
        sub_mod(x3, x3, t, f);       // X3 = r2^2 - J - 2V
        mont_mul(J, s1, J, f);       // S1 J
        sub_mod(t, V, x3, f);
        mont_mul(y3, rr, t, f);
        dbl_mod(J, J, f);
        sub_mod(y3, y3, J, f);       // Y3 = r2 (V - X3) - 2 S1 J
        add_mod(t, z1, z2, f);
        mont_mul(t, t, t, f);
        sub_mod(t, t, z1z1, f);
        sub_mod(t, t, z2z2, f);
        mont_mul(z3, t, h, f);       // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
    }
    store_fe(o, x3);
    store_fe(o + o_coord, y3);
    store_fe(o + 2 * o_coord, z3);
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
