// Montgomery helpers on one prime field, one element per thread, for the
// stacked-product kernels (stacked_mul.cu and the opt-in routes'
// stacked_routes.cuh).
//
// An element is NL 32-bit limbs, little-endian, in Montgomery form with
// R = 2^(32 NL) — the same R as the package's 16-bit-limb planes
// (L = 2 NL limbs, R = 2^(16 L)), so values are interchangeable and every
// function here returns the canonical representative < N, bit-identical to
// the plain PyTorch field layer (ops/fp.py).
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
    uint32_t beta[NL];  // unused (zeros): the layout the stacked wrappers pack
    uint32_t n0;        // -N^{-1} mod 2^32
};

__constant__ FieldConsts FC;

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
