// 16-bit limb planes <-> 32-bit limbs, one element per thread, for the
// stacked-product kernels (stacked_mul.cu and the opt-in routes'
// stacked_routes.cuh).
//
// An element is NL 32-bit limbs, little-endian, in Montgomery form with
// R = 2^(32 NL) — the same R as the package's 16-bit-limb planes
// (L = 2 NL limbs, R = 2^(16 L)), so values are interchangeable with the
// plain PyTorch field layer (ops/fp.py). The kernels take their modulus
// constants by value (stacked_mul.cu: K5Consts, stacked_routes.cuh:
// TcConsts).
#pragma once
#include <cstdint>

#ifndef NL
#error "compile with -DNL=<number of 32-bit limbs>"
#endif

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
