// Native Grumpkin elliptic-curve code for the host side of the port.
//
// The reference delegates its EC gadgets (fixed-base scalar mul, Pedersen,
// Schnorr) to a prebuilt barretenberg C++/WASM binary hosted in wasmer
// (barretenberg_blackbox_solver/src/wasm/).  This is the port's copy of the
// JAX package's native equivalent (acvm_tpu/native/grumpkin_native.cc, the
// same C ABI, version 1): BN254-Fr Montgomery arithmetic on 4x64-bit limbs
// (unsigned __int128 products) and Jacobian-coordinate Grumpkin group ops,
// exposed through a C ABI consumed via ctypes
// (acvm_tpu_torch/native/__init__.py).  Its callers: the window tables of the
// device MSM (gpu/ec.py::_window_table_np) and the host black boxes
// (blackbox/grumpkin.py: fixed-base multiplication, Pedersen, Schnorr).
//
// Curve: y^2 = x^3 - 17 over Fr_bn254; group order = Fq_bn254 (the 2-cycle).

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef std::uint64_t u64;

namespace {

struct Fe {
    u64 v[4];
};

static const Fe MOD = {{0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                        0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
static const Fe R2 = {{0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                       0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL}};
static const Fe R1 = {{0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL,
                       0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL}};
static const u64 N0INV = 0xc2e1f593efffffffULL;
// exponent p-2 for Fermat inversion
static const u64 PM2[4] = {0x43e1f593efffffffULL, 0x2833e84879b97091ULL,
                           0xb85045b68181585dULL, 0x30644e72e131a029ULL};

static inline bool geq(const Fe &a, const Fe &b) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] > b.v[i]) return true;
        if (a.v[i] < b.v[i]) return false;
    }
    return true;
}

static inline bool is_zero(const Fe &a) {
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline void sub_mod_p(Fe &a) {
    // a -= p (caller guarantees a >= p)
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - MOD.v[i] - borrow;
        a.v[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

static inline Fe add(const Fe &a, const Fe &b) {
    Fe r;
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        r.v[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || geq(r, MOD)) sub_mod_p(r);
    return r;
}

static inline Fe sub(const Fe &a, const Fe &b) {
    Fe r;
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        r.v[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            u128 s = (u128)r.v[i] + MOD.v[i] + carry;
            r.v[i] = (u64)s;
            carry = s >> 64;
        }
    }
    return r;
}

// CIOS Montgomery multiplication, 4x64.
static Fe mont_mul(const Fe &a, const Fe &b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[4] + carry;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);

        u64 m = t[0] * N0INV;
        carry = ((u128)t[0] + (u128)m * MOD.v[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 s2 = (u128)t[j] + (u128)m * MOD.v[j] + carry;
            t[j - 1] = (u64)s2;
            carry = s2 >> 64;
        }
        u128 s3 = (u128)t[4] + carry;
        t[3] = (u64)s3;
        t[4] = t[5] + (u64)(s3 >> 64);
        t[5] = 0;
    }
    Fe r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || geq(r, MOD)) sub_mod_p(r);
    return r;
}

static inline Fe to_mont(const Fe &a) { return mont_mul(a, R2); }

static inline Fe from_mont(const Fe &a) {
    Fe one = {{1, 0, 0, 0}};
    return mont_mul(a, one);
}

static Fe inv_mont(const Fe &a) {
    // a^(p-2), all in Montgomery form; returns zero for zero input.
    if (is_zero(a)) return a;
    Fe result = R1;  // Montgomery one
    Fe base = a;
    for (int limb = 0; limb < 4; ++limb) {
        u64 bits = PM2[limb];
        for (int i = 0; i < 64; ++i) {
            if (bits & 1) result = mont_mul(result, base);
            base = mont_mul(base, base);
            bits >>= 1;
        }
    }
    return result;
}

static void fe_from_be(Fe &r, const std::uint8_t *bytes) {
    for (int i = 0; i < 4; ++i) {
        u64 limb = 0;
        for (int j = 0; j < 8; ++j) limb = (limb << 8) | bytes[(3 - i) * 8 + j];
        r.v[i] = limb;
    }
}

static void fe_to_be(const Fe &a, std::uint8_t *bytes) {
    for (int i = 0; i < 4; ++i) {
        u64 limb = a.v[3 - i];
        for (int j = 0; j < 8; ++j)
            bytes[i * 8 + j] = (std::uint8_t)(limb >> (8 * (7 - j)));
    }
}

// ---------------------------------------------------------------------------
// Jacobian point ops (a = 0, b = -17).  Infinity: z == 0.
// ---------------------------------------------------------------------------

struct Pt {
    Fe x, y, z;  // Montgomery form
};

static inline bool pt_is_inf(const Pt &p) { return is_zero(p.z); }

static Pt pt_double(const Pt &p) {
    if (pt_is_inf(p)) return p;
    // dbl-2009-l (a=0): A=X^2, B=Y^2, C=B^2, D=2((X+B)^2-A-C), E=3A, F=E^2
    Fe A = mont_mul(p.x, p.x);
    Fe B = mont_mul(p.y, p.y);
    Fe C = mont_mul(B, B);
    Fe t = add(p.x, B);
    t = mont_mul(t, t);
    t = sub(sub(t, A), C);
    Fe D = add(t, t);
    Fe E = add(add(A, A), A);
    Fe F = mont_mul(E, E);
    Pt r;
    r.x = sub(F, add(D, D));
    Fe C8 = add(C, C);
    C8 = add(C8, C8);
    C8 = add(C8, C8);
    r.y = sub(mont_mul(E, sub(D, r.x)), C8);
    r.z = mont_mul(p.y, p.z);
    r.z = add(r.z, r.z);
    return r;
}

static Pt pt_add(const Pt &p, const Pt &q) {
    if (pt_is_inf(p)) return q;
    if (pt_is_inf(q)) return p;
    // add-2007-bl
    Fe Z1Z1 = mont_mul(p.z, p.z);
    Fe Z2Z2 = mont_mul(q.z, q.z);
    Fe U1 = mont_mul(p.x, Z2Z2);
    Fe U2 = mont_mul(q.x, Z1Z1);
    Fe S1 = mont_mul(mont_mul(p.y, q.z), Z2Z2);
    Fe S2 = mont_mul(mont_mul(q.y, p.z), Z1Z1);
    Fe H = sub(U2, U1);
    Fe Rr = sub(S2, S1);
    if (is_zero(H)) {
        if (is_zero(Rr)) return pt_double(p);
        Pt inf;
        std::memset(&inf, 0, sizeof(inf));
        return inf;
    }
    Fe I = add(H, H);
    I = mont_mul(I, I);
    Fe J = mont_mul(H, I);
    Fe r2 = add(Rr, Rr);
    Fe V = mont_mul(U1, I);
    Pt out;
    out.x = sub(sub(mont_mul(r2, r2), J), add(V, V));
    Fe S1J = mont_mul(S1, J);
    out.y = sub(mont_mul(r2, sub(V, out.x)), add(S1J, S1J));
    Fe zz = add(p.z, q.z);
    zz = mont_mul(zz, zz);
    out.z = mont_mul(sub(sub(zz, Z1Z1), Z2Z2), H);
    return out;
}

static Pt pt_mul(const Pt &p, const std::uint8_t scalar_be[32]) {
    Pt r;
    std::memset(&r, 0, sizeof(r));
    for (int i = 0; i < 256; ++i) {
        r = pt_double(r);
        int byte = i / 8;
        int bit = 7 - (i % 8);
        if ((scalar_be[byte] >> bit) & 1) r = pt_add(r, p);
    }
    return r;
}

static void pt_to_affine_bytes(const Pt &p, std::uint8_t out[64]) {
    if (pt_is_inf(p)) {
        std::memset(out, 0, 64);
        return;
    }
    Fe zinv = inv_mont(p.z);
    Fe zinv2 = mont_mul(zinv, zinv);
    Fe zinv3 = mont_mul(zinv2, zinv);
    Fe x = from_mont(mont_mul(p.x, zinv2));
    Fe y = from_mont(mont_mul(p.y, zinv3));
    fe_to_be(x, out);
    fe_to_be(y, out + 32);
}

static Pt pt_from_affine_bytes(const std::uint8_t xy[64]) {
    Pt p;
    Fe x, y;
    fe_from_be(x, xy);
    fe_from_be(y, xy + 32);
    p.x = to_mont(x);
    p.y = to_mont(y);
    if (is_zero(x) && is_zero(y)) {
        std::memset(&p.z, 0, sizeof(p.z));
    } else {
        p.z = R1;  // one
    }
    return p;
}

}  // namespace

extern "C" {

// point (affine BE x||y, 64 bytes) * scalar (BE 32 bytes) -> affine BE out.
void grumpkin_mul(const std::uint8_t *point_xy, const std::uint8_t *scalar_be,
                  std::uint8_t *out_xy) {
    Pt p = pt_from_affine_bytes(point_xy);
    Pt r = pt_mul(p, scalar_be);
    pt_to_affine_bytes(r, out_xy);
}

// sum_i points[i] * scalars[i]; points/scalars are packed 64/32-byte entries.
void grumpkin_msm(const std::uint8_t *points, const std::uint8_t *scalars,
                  std::size_t n, std::uint8_t *out_xy) {
    Pt acc;
    std::memset(&acc, 0, sizeof(acc));
    for (std::size_t i = 0; i < n; ++i) {
        Pt p = pt_from_affine_bytes(points + 64 * i);
        acc = pt_add(acc, pt_mul(p, scalars + 32 * i));
    }
    pt_to_affine_bytes(acc, out_xy);
}

// Batched single-point multiply: out[i] = point * scalars[i].
void grumpkin_mul_batch(const std::uint8_t *point_xy,
                        const std::uint8_t *scalars, std::size_t n,
                        std::uint8_t *out_xy) {
    Pt p = pt_from_affine_bytes(point_xy);
    for (std::size_t i = 0; i < n; ++i) {
        Pt r = pt_mul(p, scalars + 32 * i);
        pt_to_affine_bytes(r, out_xy + 64 * i);
    }
}

// p1 + p2 in affine bytes.
void grumpkin_add(const std::uint8_t *p1_xy, const std::uint8_t *p2_xy,
                  std::uint8_t *out_xy) {
    Pt r = pt_add(pt_from_affine_bytes(p1_xy), pt_from_affine_bytes(p2_xy));
    pt_to_affine_bytes(r, out_xy);
}

// Batched field ops (values BE 32 bytes): out = a * b mod p and a^-1 mod p.
void bn254fr_mul_batch(const std::uint8_t *a, const std::uint8_t *b,
                       std::size_t n, std::uint8_t *out) {
    for (std::size_t i = 0; i < n; ++i) {
        Fe fa, fb;
        fe_from_be(fa, a + 32 * i);
        fe_from_be(fb, b + 32 * i);
        Fe r = from_mont(mont_mul(to_mont(fa), to_mont(fb)));
        fe_to_be(r, out + 32 * i);
    }
}

void bn254fr_inv_batch(const std::uint8_t *a, std::size_t n, std::uint8_t *out) {
    for (std::size_t i = 0; i < n; ++i) {
        Fe fa;
        fe_from_be(fa, a + 32 * i);
        Fe r = from_mont(inv_mont(to_mont(fa)));
        fe_to_be(r, out + 32 * i);
    }
}

int acvm_native_abi_version() { return 1; }

}  // extern "C"
