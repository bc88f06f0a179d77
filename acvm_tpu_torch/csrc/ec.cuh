// The group law of a short-Weierstrass curve for one thread, on registers: a
// point is (X, Y, Z) Jacobian in Montgomery form, Z == 0 encoding infinity.
// Templated on the curve's a (0: Grumpkin, secp256k1; -3: secp256r1) and on
// the field's mode (Field for Grumpkin over BN254 Fr, WideField for the
// secp curves' base fields); Grumpkin's instantiation is the code it was.
//
// ec_add is the complete addition of acvm_tpu/tpu/ec_pallas.py::
// _make_pt_add_kernel: add-2007-bl with the dbl-2009-l doubling for P == Q,
// the reference's chain of field operations with every intermediate
// canonical, so X, Y and Z come out bit-identical to it, not just the affine
// point.  Where the reference computes both formulas for every lane and
// selects, a thread branches: either operand at infinity costs no product,
// P == Q costs 8 + 7, a generic pair 16.  ec_dbl is that doubling branch on
// its own: it reads P only, so a caller that knows both operands are the same
// point gets the same bits for 7 products.
//
// For a = -3 the doubling is the reference's dbl-2007-bl with its a Z^4
// term (acvm_tpu/tpu/ec.py::pt_double with a_mont): M = 3 X^2 + a Z^4, here
// as 3 (X - Z^2)(X + Z^2), the same element for 8 products where the
// reference's chain takes 10.  Every output is a canonical element, so the
// same value is the same bits.
//
// ec_madd is ec_add for a finite Q whose Z is one (R mod p, an affine point in
// Jacobian form): madd-2007-bl.  With Z2 = 1, Z2Z2 = 1, U1 = X1, S1 = Y1 and
// (Z1 + Z2)^2 - Z1Z1 - Z2Z2 = 2 Z1, so the same chain gives the same
// canonical X3, Y3 and Z3 for 11 products where ec_add takes 16.
//
// All three work in place on P.  Q is read through pointers (ec_add: or any
// source of its three coordinates, ec_add_from), each coordinate when the
// formula first needs it, so a caller whose Q never changes holds none of it
// in registers between additions.
#pragma once

#include "field.cuh"

template <class F>
__device__ __forceinline__ void dbl_mod(uint32_t r[ACVM_LIMBS], const uint32_t a[ACVM_LIMBS],
                                        const F& f) {
    add_mod(r, a, a, f);
}

// P <- 2P, a = -3: dbl-2007-bl.  Z3 = 2 Y Z = (Y + Z)^2 - YY - ZZ,
// S = 4 X YY = 2((X + YY)^2 - XX - YYYY), X3 = M^2 - 2S,
// Y3 = M (S - X3) - 8 YYYY.
template <class F>
__device__ __forceinline__ void ec_dbl_a3(uint32_t x[ACVM_LIMBS], uint32_t y[ACVM_LIMBS],
                                          uint32_t z[ACVM_LIMBS], const F& f) {
    uint32_t ZZ[ACVM_LIMBS], YY[ACVM_LIMBS], M[ACVM_LIMBS], S[ACVM_LIMBS], t[ACVM_LIMBS];
    mont_mul(ZZ, z, z, f);
    mont_mul(z, y, z, f);
    dbl_mod(z, z, f);            // Z3 = 2 Y Z
    sub_mod(t, x, ZZ, f);
    add_mod(M, x, ZZ, f);
    mont_mul(M, t, M, f);
    dbl_mod(t, M, f);
    add_mod(M, t, M, f);         // M = 3 (X - ZZ)(X + ZZ) = 3 X^2 - 3 Z^4
    mont_mul(YY, y, y, f);
    mont_mul(S, x, YY, f);
    dbl_mod(S, S, f);
    dbl_mod(S, S, f);            // S = 4 X YY
    mont_mul(YY, YY, YY, f);     // YYYY, over YY
    mont_mul(x, M, M, f);
    dbl_mod(t, S, f);
    sub_mod(x, x, t, f);         // X3 = M^2 - 2S
    sub_mod(t, S, x, f);
    mont_mul(y, M, t, f);
    dbl_mod(YY, YY, f);
    dbl_mod(YY, YY, f);
    dbl_mod(YY, YY, f);          // 8 YYYY
    sub_mod(y, y, YY, f);        // Y3 = M (S - X3) - 8 YYYY
}

// P <- 2P, a = 0: dbl-2009-l (mirrors ec.pt_double).
template <class F>
__device__ __forceinline__ void ec_dbl_a0(uint32_t x[ACVM_LIMBS], uint32_t y[ACVM_LIMBS],
                                          uint32_t z[ACVM_LIMBS], const F& f) {
    uint32_t A[ACVM_LIMBS], Bv[ACVM_LIMBS], C[ACVM_LIMBS], D[ACVM_LIMBS], t[ACVM_LIMBS];
    mont_mul(z, y, z, f);
    dbl_mod(z, z, f);            // Z3 = 2 Y1 Z1
    mont_mul(A, x, x, f);
    mont_mul(Bv, y, y, f);
    mont_mul(C, Bv, Bv, f);
    add_mod(t, x, Bv, f);
    mont_mul(t, t, t, f);
    sub_mod(D, t, A, f);
    sub_mod(D, D, C, f);
    dbl_mod(D, D, f);            // D = 2((X + B)^2 - A - C)
    dbl_mod(t, A, f);
    add_mod(A, t, A, f);         // E = 3A, over A
    mont_mul(x, A, A, f);        // F
    dbl_mod(t, D, f);
    sub_mod(x, x, t, f);         // X3 = F - 2D
    dbl_mod(C, C, f);
    dbl_mod(C, C, f);
    dbl_mod(C, C, f);            // 8C
    sub_mod(t, D, x, f);
    mont_mul(y, A, t, f);
    sub_mod(y, y, C, f);         // Y3 = E(D - X3) - 8C
}

// P <- 2P on a curve with a = 0 or a = -3.  P at infinity stays as it is,
// limb for limb.
template <int A, class F>
__device__ __forceinline__ void ec_dbl(uint32_t x[ACVM_LIMBS], uint32_t y[ACVM_LIMBS],
                                       uint32_t z[ACVM_LIMBS], const F& f) {
    static_assert(A == 0 || A == -3, "the curves of this package have a = 0 or a = -3");
    if (is_zero(z)) return;
    if constexpr (A == 0) {
        ec_dbl_a0(x, y, z, f);
    } else {
        ec_dbl_a3(x, y, z, f);
    }
}

// Where ec_add reads Q from: three coordinates in memory, 8 contiguous limbs
// each.  A caller with Q elsewhere (ecdsa_mul's lane table in shared memory)
// passes its own source with the same three loads.
struct PointAt {
    const uint32_t* px;
    const uint32_t* py;
    const uint32_t* pz;
    template <class F>
    __device__ __forceinline__ void x(uint32_t r[ACVM_LIMBS], const F&) const { load_fe(r, px); }
    template <class F>
    __device__ __forceinline__ void y(uint32_t r[ACVM_LIMBS], const F&) const { load_fe(r, py); }
    template <class F>
    __device__ __forceinline__ void z(uint32_t r[ACVM_LIMBS], const F&) const { load_fe(r, pz); }
};

// P <- P + Q, complete, Q read from `q` (a PointAt or a source like it), each
// coordinate when the formula first needs it.
template <int A, class F, class Src>
__device__ __forceinline__ void ec_add_from(uint32_t x1[ACVM_LIMBS], uint32_t y1[ACVM_LIMBS],
                                            uint32_t z1[ACVM_LIMBS], const Src& q, const F& f) {
    uint32_t z2[ACVM_LIMBS], t[ACVM_LIMBS];
    q.z(z2, f);
    // Identities first (the reference's last selects: Q at infinity wins).
    if (is_zero(z2)) return;
    if (is_zero(z1)) {
        q.x(x1, f);
        q.y(y1, f);
#pragma unroll
        for (int i = 0; i < ACVM_LIMBS; ++i) z1[i] = z2[i];
        return;
    }

    uint32_t z1z1[ACVM_LIMBS], z2z2[ACVM_LIMBS], u1[ACVM_LIMBS], s1[ACVM_LIMBS];
    uint32_t h[ACVM_LIMBS], rr[ACVM_LIMBS];
    mont_mul(z1z1, z1, z1, f);
    mont_mul(z2z2, z2, z2, f);
    mont_mul(u1, x1, z2z2, f);
    q.x(t, f);
    mont_mul(t, t, z1z1, f);         // U2
    sub_mod(h, t, u1, f);            // H = U2 - U1
    mont_mul(s1, y1, z2, f);
    mont_mul(s1, s1, z2z2, f);       // S1
    q.y(t, f);
    mont_mul(t, t, z1, f);
    mont_mul(t, t, z1z1, f);         // S2
    sub_mod(rr, t, s1, f);           // r = S2 - S1

    if (is_zero(h) && is_zero(rr)) {
        ec_dbl<A>(x1, y1, z1, f);       // P == Q
        return;
    }
    // add-2007-bl (mirrors ec.pt_add).  P == -Q has H == 0 and r != 0: the
    // last product makes Z3 = 0, the reference's explicit select.  X1 and Y1
    // are dead from here on and take X3 and Y3.
    uint32_t I[ACVM_LIMBS], J[ACVM_LIMBS];
    dbl_mod(I, h, f);
    mont_mul(I, I, I, f);            // I = (2H)^2
    mont_mul(J, h, I, f);
    dbl_mod(rr, rr, f);              // r2 = 2r
    mont_mul(u1, u1, I, f);          // V, over U1
    mont_mul(x1, rr, rr, f);
    sub_mod(x1, x1, J, f);
    dbl_mod(t, u1, f);
    sub_mod(x1, x1, t, f);           // X3 = r2^2 - J - 2V
    mont_mul(J, s1, J, f);           // S1 J
    sub_mod(t, u1, x1, f);
    mont_mul(y1, rr, t, f);
    dbl_mod(J, J, f);
    sub_mod(y1, y1, J, f);           // Y3 = r2 (V - X3) - 2 S1 J
    add_mod(t, z1, z2, f);
    mont_mul(t, t, t, f);
    sub_mod(t, t, z1z1, f);
    sub_mod(t, t, z2z2, f);
    mont_mul(z1, t, h, f);           // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
}

// P <- P + Q, complete.  Q's coordinates lie 8 limbs each at qx, qy, qz.
template <int A, class F>
__device__ __forceinline__ void ec_add(uint32_t x1[ACVM_LIMBS], uint32_t y1[ACVM_LIMBS],
                                       uint32_t z1[ACVM_LIMBS], const uint32_t* qx,
                                       const uint32_t* qy, const uint32_t* qz, const F& f) {
    ec_add_from<A>(x1, y1, z1, PointAt{qx, qy, qz}, f);
}

// P <- P + Q for a finite Q with Z = one (R mod p): madd-2007-bl, the branches
// of ec_add.  Q's X and Y lie 8 limbs each at qx, qy.
template <int A, class F>
__device__ __forceinline__ void ec_madd(uint32_t x1[ACVM_LIMBS], uint32_t y1[ACVM_LIMBS],
                                        uint32_t z1[ACVM_LIMBS], const uint32_t* qx,
                                        const uint32_t* qy, const F& f) {
    if (is_zero(z1)) {
        load_fe(x1, qx);
        load_fe(y1, qy);
#pragma unroll
        for (int i = 0; i < ACVM_LIMBS; ++i) z1[i] = f.r[i];
        return;
    }
    uint32_t z1z1[ACVM_LIMBS], h[ACVM_LIMBS], rr[ACVM_LIMBS], t[ACVM_LIMBS];
    mont_mul(z1z1, z1, z1, f);
    load_fe(t, qx);
    mont_mul(t, t, z1z1, f);         // U2
    sub_mod(h, t, x1, f);            // H = U2 - X1
    load_fe(t, qy);
    mont_mul(t, t, z1, f);
    mont_mul(t, t, z1z1, f);         // S2
    sub_mod(rr, t, y1, f);           // r = S2 - Y1

    if (is_zero(h) && is_zero(rr)) {
        ec_dbl<A>(x1, y1, z1, f);    // P == Q
        return;
    }
    // P == -Q has H == 0: Z3 = 2 Z1 H = 0.
    uint32_t I[ACVM_LIMBS], J[ACVM_LIMBS], V[ACVM_LIMBS];
    dbl_mod(I, h, f);
    mont_mul(I, I, I, f);            // I = (2H)^2
    mont_mul(J, h, I, f);
    dbl_mod(rr, rr, f);              // r2 = 2r
    mont_mul(V, x1, I, f);           // V = X1 I; X1 is dead from here on
    mont_mul(x1, rr, rr, f);
    sub_mod(x1, x1, J, f);
    dbl_mod(t, V, f);
    sub_mod(x1, x1, t, f);           // X3 = r2^2 - J - 2V
    mont_mul(J, y1, J, f);           // Y1 J
    sub_mod(t, V, x1, f);
    mont_mul(y1, rr, t, f);
    dbl_mod(J, J, f);
    sub_mod(y1, y1, J, f);           // Y3 = r2 (V - X3) - 2 Y1 J
    mont_mul(z1, z1, h, f);
    dbl_mod(z1, z1, f);              // Z3 = 2 Z1 H
}
