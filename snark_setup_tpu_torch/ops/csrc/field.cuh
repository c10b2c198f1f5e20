// Montgomery arithmetic on one prime field, one element per thread.
//
// An element is NL 32-bit limbs, little-endian, in Montgomery form with
// R = 2^(32 NL) — the same R as the package's 16-bit-limb planes
// (L = 2 NL limbs, R = 2^(16 L)), so values are interchangeable and every
// function here returns the canonical representative < N, bit-identical to
// the plain PyTorch field layer (ops/fp.py).
//
// Elements are passed by pointer and live in per-thread local memory: the
// hardware interleaves local memory per thread, so limb l of every thread of
// a warp sits in one 128-byte line. The multiplication loads one operand into
// registers, streams the other limb by limb, and keeps the running
// accumulator in registers (inner loops fully unrolled, outer loop rolled:
// ~150 machine ops of code instead of ~2500, and no code-cache
// pressure in a ladder that calls it ~3000 times).
//
// What bounds this code on an H100: the 32-bit integer multiply-add
// throughput. A product costs 2 NL^2 wide multiply-adds (NL^2 for the schoolbook,
// NL^2 for the interleaved reduction), each two IMAD slots, against 3 NL
// words of local-memory traffic that stay in L1.
//
// The modulus-dependent constants sit in __constant__ memory (a multiply-add
// takes a constant-bank operand directly); the host wrapper uploads them on
// the launch stream before each launch.
#pragma once
#include <cstdint>

#ifndef NL
#error "compile with -DNL=<number of 32-bit limbs>"
#endif

struct FieldConsts {
    uint32_t N[NL];     // modulus
    uint32_t one[NL];   // R mod N (Montgomery 1)
    uint32_t beta[NL];  // cube root of unity (Montgomery form), GLV endomorphism
    uint32_t n0;        // -N^{-1} mod 2^32
};

__constant__ FieldConsts FC;

typedef uint32_t fe[NL];

__device__ __forceinline__ void fset(uint32_t* r, const uint32_t* a) {
#pragma unroll
    for (int j = 0; j < NL; ++j) r[j] = a[j];
}

__device__ __forceinline__ void fzero(uint32_t* r) {
#pragma unroll
    for (int j = 0; j < NL; ++j) r[j] = 0;
}

__device__ __forceinline__ void fone(uint32_t* r) {
#pragma unroll
    for (int j = 0; j < NL; ++j) r[j] = FC.one[j];
}

// r = t - N if t >= N else t   (t < 2N, both in registers)
__device__ __forceinline__ void cond_sub_store(uint32_t* r, const uint32_t* t) {
    uint32_t d[NL];
    int64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        c += (int64_t)t[j] - (int64_t)FC.N[j];
        d[j] = (uint32_t)c;
        c >>= 32;  // arithmetic shift: borrow stays -1
    }
    const uint32_t keep = (uint32_t)c;  // 0xFFFFFFFF if t < N (borrow), else 0
#pragma unroll
    for (int j = 0; j < NL; ++j) r[j] = (t[j] & keep) | (d[j] & ~keep);
}

// r = a + b mod N   (a + b < 2N < R: no carry out of the top limb)
__device__ __noinline__ void fadd(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint32_t s[NL];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        c += (uint64_t)a[j] + b[j];
        s[j] = (uint32_t)c;
        c >>= 32;
    }
    cond_sub_store(r, s);
}

// r = a - b mod N
__device__ __noinline__ void fsub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint32_t d[NL];
    int64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        c += (int64_t)a[j] - (int64_t)b[j];
        d[j] = (uint32_t)c;
        c >>= 32;
    }
    const uint32_t borrow = (uint32_t)c;  // all ones if a < b
    uint64_t k = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        k += (uint64_t)d[j] + (FC.N[j] & borrow);
        r[j] = (uint32_t)k;
        k >>= 32;
    }
}

// r = -a mod N  (0 -> 0)
__device__ __noinline__ void fneg(uint32_t* r, const uint32_t* a) {
    uint32_t d[NL];
    uint32_t nz = 0;
    int64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        nz |= a[j];
        c += (int64_t)FC.N[j] - (int64_t)a[j];
        d[j] = (uint32_t)c;
        c >>= 32;
    }
    const uint32_t m = nz ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int j = 0; j < NL; ++j) r[j] = d[j] & m;
}

// r = -a mod N where neg is 1, a where it is 0 (0 stays 0)
__device__ __forceinline__ void cond_neg(uint32_t* a, uint32_t neg) {
    uint32_t d[NL];
    uint32_t nz = 0;
    int64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        nz |= a[j];
        c += (int64_t)FC.N[j] - (int64_t)a[j];
        d[j] = (uint32_t)c;
        c >>= 32;
    }
    const uint32_t m = (neg && nz) ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int j = 0; j < NL; ++j) a[j] = (d[j] & m) | (a[j] & ~m);
}

// r = sel ? a : b, branch-free (sel is 0 or 1)
__device__ __forceinline__ void fselect(uint32_t* r, uint32_t sel, const uint32_t* a, const uint32_t* b) {
    const uint32_t m = 0u - sel;
#pragma unroll
    for (int j = 0; j < NL; ++j) r[j] = (a[j] & m) | (b[j] & ~m);
}

// One CIOS round pair: t += a * bi (schoolbook row), t[NL+1] catches overflow.
__device__ __forceinline__ void mac_row(uint32_t* t, const uint32_t* a, uint32_t bi) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        c += (uint64_t)a[j] * bi + t[j];
        t[j] = (uint32_t)c;
        c >>= 32;
    }
    c += t[NL];
    t[NL] = (uint32_t)c;
    t[NL + 1] += (uint32_t)(c >> 32);
}

// t = (t + m N) / 2^32 with m chosen so the low limb cancels.
__device__ __forceinline__ void redc_row(uint32_t* t) {
    const uint32_t m = t[0] * FC.n0;
    uint64_t c = ((uint64_t)m * FC.N[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
        c += (uint64_t)m * FC.N[j] + t[j];
        t[j - 1] = (uint32_t)c;
        c >>= 32;
    }
    c += t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
    t[NL + 1] = 0;
}

// r = a * b * R^{-1} mod N   (interleaved Montgomery multiplication, CIOS)
__device__ __noinline__ void fmul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint32_t ra[NL], t[NL + 2];
#pragma unroll
    for (int j = 0; j < NL; ++j) ra[j] = a[j];
#pragma unroll
    for (int j = 0; j < NL + 2; ++j) t[j] = 0;
#pragma unroll 1
    for (int i = 0; i < NL; ++i) {
        mac_row(t, ra, b[i]);
        redc_row(t);
    }
    cond_sub_store(r, t);  // t < 2N, t[NL] == 0
}

// r = (a1 * b1 + a2 * b2) * R^{-1} mod N: two products under ONE reduction.
// The running value stays below 3N(1 + 2^-32) + 2 N 2^32 inside a round, which
// the two spare accumulator words hold, and the exact result
// (a1 b1 + a2 b2 + M N) / R < N (1 + 2N/R) is < 2N because 2N < R (the host
// wrapper checks it), so one conditional subtraction makes it canonical.
__device__ __noinline__ void fmul2(uint32_t* r, const uint32_t* a1, const uint32_t* b1,
                                   const uint32_t* a2, const uint32_t* b2) {
    uint32_t ra1[NL], ra2[NL], t[NL + 2];
#pragma unroll
    for (int j = 0; j < NL; ++j) { ra1[j] = a1[j]; ra2[j] = a2[j]; }
#pragma unroll
    for (int j = 0; j < NL + 2; ++j) t[j] = 0;
#pragma unroll 1
    for (int i = 0; i < NL; ++i) {
        mac_row(t, ra1, b1[i]);
        mac_row(t, ra2, b2[i]);
        redc_row(t);
    }
    cond_sub_store(r, t);
}

// r = w * a mod N for a small w >= 1: binary addition chain, canonical at
// every step (w is |3b| <= 12 for every curve in scope).
__device__ __noinline__ void small_mul(uint32_t* r, const uint32_t* a, uint32_t w) {
    fe addend, acc;
    fset(addend, a);
    bool have = false;
    while (w) {
        if (w & 1u) {
            if (have) fadd(acc, acc, addend); else { fset(acc, addend); have = true; }
        }
        w >>= 1;
        if (w) fadd(addend, addend, addend);
    }
    fset(r, acc);
}

// 16-bit limb planes in global memory <-> 32-bit limbs. Plane element
// [l * B + lane] holds limb l of lane `lane` (values < 2^16 in a 32-bit word;
// the tensors are int32 on the Python side, the same bits).
__device__ __forceinline__ void load_planes(uint32_t* r, const uint32_t* planes, int64_t B, int64_t lane) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        const uint32_t lo = planes[(int64_t)(2 * j) * B + lane];
        const uint32_t hi = planes[(int64_t)(2 * j + 1) * B + lane];
        r[j] = (lo & 0xFFFFu) | (hi << 16);
    }
}

__device__ __forceinline__ void store_planes(uint32_t* planes, const uint32_t* a, int64_t B, int64_t lane) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        planes[(int64_t)(2 * j) * B + lane] = a[j] & 0xFFFFu;
        planes[(int64_t)(2 * j + 1) * B + lane] = a[j] >> 16;
    }
}
