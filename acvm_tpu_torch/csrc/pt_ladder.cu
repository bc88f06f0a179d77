// Variable-base scalar multiplication on an a = 0 curve (Grumpkin), the whole
// double-and-add ladder in one launch: out[:, b] = scalar[b] * base[:, b].
//
// Replaces the ladder of acvm_tpu/tpu/ec_pallas.py::scalar_mul_fused, a scan
// of 256 steps that each call the complete-addition kernel twice and select.
// Each step, MSB first, is
//
//     acc = acc + acc;   if (bit) acc = acc + base;
//
// with the group law of ec.cuh (dbl-2009-l, add-2007-bl), so X, Y and Z equal
// the reference ladder's limb for limb.  The scalar is taken as it comes, all
// 256 bits, not reduced.
//
// What bounds it: a step is a chain of dependent Montgomery products, and a
// warp's product costs its scheduler about one product's worth of multiply-add
// issue whatever the number of lanes that use it.  With a thread an instance a
// batch of 2,048 is 64 warps, each waiting out 256 x (7 + 16) products one
// after the other.  Here four consecutive lanes (a team) own one instance, so
// a warp holds 8 instances and the batch is 256 one-warp blocks over all 132
// SMs, and a step's products run in rounds, one product a thread a round: a
// round costs the warp one product, whatever its four threads multiply.  From
// the formulas' dependencies a step takes six rounds where it took 23
// products one after the other:
//
//   R1  (2Y) Z, (3X) X, Y^2                    Z3 = 2 Y Z, E = 3 X^2, B = Y^2
//   R2  B^2, (4X) B, E^2, Z3^2                  C, D = 4 X B, F = E^2, Z1Z1
//   R3  E (D - X3), X3 Z2^2, Qx Z1Z1, (2Qy) Z1  X3 = F - 2D, Y3 = E (D - X3) - 8C; U1, U2, 2 Qy Z1
//   R4  Y3 (2 Z2^3), (2 Qy Z1) Z1Z1, (2H)^2, (Z1 + Z2)^2     2 S1, 2 S2, I, H = U2 - U1
//   R5  r2^2, H I, U1 I, ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H       r2 = 2 S2 - 2 S1
//   R6  r2 (V - X3), (2 S1) J                                X3 = r2^2 - J - 2V
//
// R1-R3 are the doubling; R3's other three threads start the addition on the
// doubled point, and R4-R6 finish it.  Every intermediate the formulas keep
// is the same field element as in ec.cuh's chains, and every element is
// canonical, so the same value is the same bits: a product takes a small
// multiple of an operand where ec.cuh doubles or triples the product after
// it (2Y Z, 3X X, 4X B = 2((X + B)^2 - X^2 - B^2)), and the addition carries
// 2 S1 and 2 S2 (r2 = 2 S2 - 2 S1, Y3 = r2 (V - X3) - (2 S1) J), so a linear
// step comes off the path between two rounds.  The base never changes: it is
// read once into shared memory with Z2^2, 2 Z2^3 and 2 Qy.
//
// A team's point, its base and the step's intermediates live in the team's
// slice of shared memory.  Each thread loads its operands, multiplies, and
// stores its result; `__syncwarp` separates the rounds.  The four threads of a
// team run one instruction stream and pick their operands by selects.  A load
// reads one slot for all four, or slots that differ modulo 4 (the slots'
// order); a store is one member's; and neighbouring teams' slices start an
// odd number of 16-byte steps apart: no two lanes of a quarter-warp (two
// teams) meet in a bank.  What is left between two rounds' products is the
// linear step that needs the first one's result (X3 = F - 2D and D - X3
// before R3, H and 2H before R4, r2 before R5, X3 and V - X3 before R6): the
// rest is made beside a product.
//
// Branches are decided per team from shared values, the same in its four
// threads, and a round runs when any team of the warp needs it:
//   * the accumulator at infinity is not doubled (leading zero bits are free);
//   * a clear bit or a base at infinity skips the addition;
//   * a doubled accumulator at infinity takes the base's coordinates;
//   * P == Q at the addition (H = r = 0) doubles instead, a second pass of
//     R1-R3 for the teams that met it;
//   * P == -Q makes Z3 = 0 through R5's product, as the reference does.
// A masked team (past the batch) has a zero base and a zero scalar: it is at
// infinity throughout and stores nothing.
#include "ec.cuh"
#include "pow.cuh"   // copy_fe

#define LADDER_TEAMS 8   // instances a one-warp block

// A team's slots, one field element each.  The slots that one load
// instruction reads for a team's four threads differ modulo 4 (see the
// rounds), so that with the slices below no two lanes of a quarter-warp meet
// in a bank.
enum LadderSlot {
    SX, SY, SZ, SE,                     // the accumulator, Jacobian; E = 3 X^2
    SB, SD, Z2C2, QYZ1,                 // Y^2, D = 4 X B, 2 QZ^3, 2 Qy Z1
    QX, Q2Y, QZ, SC,                    // the base's X, 2 Qy, Z; C = B^2
    Z2Z2, Z1Z1, SF, QY,                 // QZ^2, Z1^2, F = E^2, the base's Y
    U1, U2, S1, S2,                     // the addition's products: U1, U2, 2 S1, 2 S2
    SI, ZS, SJ, SV,
    S1J, R2R2,                          // 2 S1 J, r2^2
    LADDER_SLOTS
};
// Two 16-byte halves a slot and one more: neighbouring teams' slices start an
// odd number of 16-byte steps apart, so they never share a bank group.
#define LADDER_STRIDE (2 * LADDER_SLOTS + 1)

#define FULL_WARP 0xffffffffu

__device__ __forceinline__ void get(uint32_t r[ACVM_LIMBS], const uint4* t, int s) {
    const uint4 lo = t[2 * s], hi = t[2 * s + 1];
    r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
    r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void put(uint4* t, int s, const uint32_t r[ACVM_LIMBS]) {
    t[2 * s] = make_uint4(r[0], r[1], r[2], r[3]);
    t[2 * s + 1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// r = x where `take`, else r as it is: a thread picks its operand without a
// branch, so the four threads run one instruction stream.
__device__ __forceinline__ void take_if(uint32_t r[ACVM_LIMBS], bool take, const uint32_t x[ACVM_LIMBS]) {
#pragma unroll
    for (int j = 0; j < ACVM_LIMBS; ++j) r[j] = take ? x[j] : r[j];
}

__device__ __forceinline__ int pick(int m, int s0, int s1, int s2, int s3) {
    return m == 0 ? s0 : m == 1 ? s1 : m == 2 ? s2 : s3;
}

// What the doubling leaves the addition in registers, made beside products
// that do not need them: Z1 + Z2 and Z1Z1 + Z2Z2.
struct Carry {
    uint32_t zq[ACVM_LIMBS];
    uint32_t zz[ACVM_LIMBS];
};

// R1-R3: P <- 2P for the teams with `active`, and U1, U2 and 2 Qy Z1 of the
// addition of the base to the doubled point.  The other teams run the same
// products on whatever their slots hold and keep X, Y and Z.  Every thread
// runs every line; a thread's operands and stores are its own.
__device__ __forceinline__ void double_rounds(uint4* t, int m, bool active, Carry& c,
                                              const Field& f) {
    uint32_t a[ACVM_LIMBS], b[ACVM_LIMBS], p[ACVM_LIMBS], u[ACVM_LIMBS], x4[ACVM_LIMBS];
    // R1: (2Y) Z, (3X) X, Y^2 (and Y^2 again in the fourth thread); beside
    // them 4X for R2.
    get(b, t, SX);
    get(u, t, SY);
    get(p, t, SZ);
    dbl_mod(x4, b, f);                      // 2X
    add_mod(a, x4, b, f);                   // 3X
    dbl_mod(x4, x4, f);                     // 4X
    take_if(a, m >= 2, u);
    take_if(b, m >= 2, u);
    take_if(b, m == 0, p);
    dbl_mod(p, u, f);                       // 2Y
    take_if(a, m == 0, p);
    mont_mul(p, a, b, f);
    if (m == 0 && active) put(t, SZ, p);    // Z3 = 2 Y Z
    if (m == 1) put(t, SE, p);              // E = 3 X^2
    if (m == 2) put(t, SB, p);              // B = Y^2
    __syncwarp();
    // R2: B^2, (4X) B, E^2, Z3^2; beside them Z3 + QZ.
    get(b, t, pick(m, SB, SB, SE, SZ));
    copy_fe(a, b);
    take_if(a, m == 1, x4);
    get(u, t, SZ);
    get(x4, t, QZ);
    mont_mul(p, a, b, f);
    add_mod(c.zq, u, x4, f);
    if (m == 0) put(t, SC, p);
    if (m == 1) put(t, SD, p);
    if (m == 2) put(t, SF, p);
    if (m == 3) put(t, Z1Z1, p);
    __syncwarp();
    // R3: E (D - X3), X3 Z2Z2, Qx Z1Z1, (2 Qy) Z1; beside them 8C and
    // Z1Z1 + Z2Z2.
    uint32_t d[ACVM_LIMBS], x3[ACVM_LIMBS], c8[ACVM_LIMBS];
    get(a, t, pick(m, SE, SE, QX, Q2Y));
    get(b, t, pick(m, Z2Z2, Z2Z2, Z1Z1, SZ));
    get(d, t, SD);
    get(x3, t, SF);
    dbl_mod(u, d, f);
    sub_mod(x3, x3, u, f);                  // X3 = F - 2D
    sub_mod(d, d, x3, f);                   // D - X3
    take_if(a, m == 1, x3);
    take_if(b, m == 0, d);
    mont_mul(p, a, b, f);
    get(c8, t, SC);
    dbl_mod(c8, c8, f);
    dbl_mod(c8, c8, f);
    dbl_mod(c8, c8, f);                     // 8C
    get(u, t, Z1Z1);
    get(x4, t, Z2Z2);
    add_mod(c.zz, u, x4, f);
    sub_mod(u, p, c8, f);                   // Y3 = E (D - X3) - 8C
    if (m == 0 && active) {
        put(t, SX, x3);
        put(t, SY, u);
    }
    if (m == 1) put(t, U1, p);
    if (m == 2) put(t, U2, p);
    if (m == 3) put(t, QYZ1, p);
    __syncwarp();
}

// R4-R6: P <- P + Q for the teams with `full` (P and Q finite), on the slots
// R3 left.  Returns whether this team met P == Q, which it leaves unchanged.
__device__ __forceinline__ bool add_rounds(uint4* t, int m, bool full, const Carry& c,
                                           const Field& f) {
    uint32_t a[ACVM_LIMBS], b[ACVM_LIMBS], p[ACVM_LIMBS], h[ACVM_LIMBS], u1[ACVM_LIMBS];
    // R4: 2 S1 = Y1 (2 Z2^3), 2 S2 = (2 Qy Z1) Z1Z1, I = (2H)^2, (Z1 + Z2)^2.
    get(a, t, pick(m, SY, QYZ1, SY, SY));
    get(b, t, pick(m, Z2C2, Z1Z1, Z2C2, Z2C2));
    get(h, t, U2);
    get(u1, t, U1);
    sub_mod(h, h, u1, f);                   // H = U2 - U1
    dbl_mod(p, h, f);
    take_if(a, m == 2, p);
    take_if(a, m == 3, c.zq);
    take_if(b, m >= 2, a);
    mont_mul(p, a, b, f);
    if (m == 0) put(t, S1, p);
    if (m == 1) put(t, S2, p);
    if (m == 2) put(t, SI, p);
    if (m == 3) put(t, ZS, p);
    __syncwarp();
    // P == Q (H = 0, r = 0) from the same values in the team's four threads.
    uint32_t s1[ACVM_LIMBS], r2[ACVM_LIMBS];
    get(r2, t, S2);
    get(s1, t, S1);
    sub_mod(r2, r2, s1, f);                 // r2 = 2 (S2 - S1)
    const bool same = full && is_zero(h) && is_zero(r2);
    const bool commit = full && !same;
    // R5: r2^2, J = H I, V = U1 I, Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H.
    get(b, t, SI);
    get(a, t, ZS);
    sub_mod(a, a, c.zz, f);
    take_if(b, m == 3, h);
    take_if(a, m == 2, u1);
    take_if(a, m == 1, h);
    take_if(a, m == 0, r2);
    take_if(b, m == 0, r2);
    mont_mul(p, a, b, f);
    if (m == 0) put(t, R2R2, p);
    if (m == 1) put(t, SJ, p);
    if (m == 2) put(t, SV, p);
    if (m == 3 && commit) put(t, SZ, p);    // Z3; P == -Q makes it 0 through H
    __syncwarp();
    // R6: X3 = r2^2 - J - 2V, then r2 (V - X3) and (2 S1) J.
    uint32_t x3[ACVM_LIMBS], v[ACVM_LIMBS];
    get(x3, t, R2R2);
    get(b, t, SJ);
    get(v, t, SV);
    sub_mod(x3, x3, b, f);
    dbl_mod(a, v, f);
    sub_mod(x3, x3, a, f);                  // X3 = r2^2 - J - 2V
    sub_mod(v, v, x3, f);
    copy_fe(a, s1);
    take_if(a, m == 0, r2);
    take_if(b, m == 0, v);
    mont_mul(p, a, b, f);
    if (m == 0 && commit) put(t, SX, x3);
    if (m == 1) put(t, S1J, p);
    __syncwarp();
    if (m == 0 && commit) {
        get(a, t, S1J);
        sub_mod(p, p, a, f);                // Y3 = r2 (V - X3) - 2 S1 J
        put(t, SY, p);
    }
    __syncwarp();
    return same;
}

__global__ void __launch_bounds__(32)
pt_ladder_kernel(const uint32_t* __restrict__ base, long long b_coord, long long b_inst,
                 const uint32_t* __restrict__ scalars, uint32_t* __restrict__ out,
                 long long o_coord, long long o_inst, long long B, const Field f) {
    __shared__ uint4 slices[LADDER_TEAMS * LADDER_STRIDE];
    const int m = threadIdx.x & 3;
    const long long b = (long long)blockIdx.x * LADDER_TEAMS + (threadIdx.x >> 2);
    const bool live = b < B;
    uint4* t = slices + (threadIdx.x >> 2) * LADDER_STRIDE;
    uint32_t v[ACVM_LIMBS], w[ACVM_LIMBS];

    // The base (zero in a masked team) and the accumulator at infinity.
#pragma unroll
    for (int i = 0; i < ACVM_LIMBS; ++i) v[i] = 0;
    if (m < 3) {
        put(t, SX + m, v);
        if (live) load_fe(v, base + b * b_inst + m * b_coord);
        put(t, pick(m, QX, QY, QZ, QZ), v);
    }
    __syncwarp();
    if (m == 0) {                           // Z2^2, 2 Z2^3, 2 Qy
        get(v, t, QZ);
        mont_mul(w, v, v, f);
        put(t, Z2Z2, w);
        mont_mul(w, v, w, f);
        dbl_mod(w, w, f);
        put(t, Z2C2, w);
        get(v, t, QY);
        dbl_mod(v, v, f);
        put(t, Q2Y, v);
    }
    __syncwarp();
    get(v, t, QZ);
    const bool base_inf = is_zero(v);

    const uint32_t* k = scalars + b * ACVM_LIMBS;
    Carry carry;
#pragma unroll 1
    for (int limb = ACVM_LIMBS - 1; limb >= 0; --limb) {
        const uint32_t word = live ? k[limb] : 0u;
#pragma unroll 1
        for (int bit = 31; bit >= 0; --bit) {
            const bool add = ((word >> bit) & 1u) && !base_inf;
            get(v, t, SZ);
            bool doubling = !is_zero(v);
            // One pass for the step; a second doubles the teams that met P == Q.
#pragma unroll 1
            for (int pass = 0; pass < 2; ++pass) {
                if (__any_sync(FULL_WARP, doubling)) double_rounds(t, m, doubling, carry, f);
                if (pass == 1) break;
                get(v, t, SZ);
                const bool at_inf = is_zero(v);
                if (add && at_inf && m < 3) {   // infinity + Q = Q
                    get(w, t, pick(m, QX, QY, QZ, QZ));
                    put(t, SX + m, w);
                }
                __syncwarp();
                const bool full = add && !at_inf;
                if (!__any_sync(FULL_WARP, full)) break;
                doubling = add_rounds(t, m, full, carry, f);
                if (!__any_sync(FULL_WARP, doubling)) break;
            }
        }
    }
    if (live && m < 3) {
        get(v, t, SX + m);
        store_fe(out + b * o_inst + m * o_coord, v);
    }
}

extern "C" int acvm_pt_ladder(const void* base, long long b_coord, long long b_inst,
                              const void* scalars, void* out, long long o_coord,
                              long long o_inst, long long B, const uint32_t* field_words,
                              void* stream) {
    if (B <= 0) return 0;
    pt_ladder_kernel<<<(unsigned)((B + LADDER_TEAMS - 1) / LADDER_TEAMS), 32, 0,
                       (cudaStream_t)stream>>>(
        (const uint32_t*)base, b_coord, b_inst, (const uint32_t*)scalars, (uint32_t*)out,
        o_coord, o_inst, B, field_from_words(field_words));
    return (int)cudaGetLastError();
}
