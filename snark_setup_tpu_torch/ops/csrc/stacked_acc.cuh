// The exact weighted accumulation of K7 (stacked_mul_v3.cu): one thread's
// (2 NL + 1)-word sum of w * u * v over the stacked rows, in registers (a
// weight times a 2 NL-word product needs the extra word). The text is K5's
// first form (stacked_mul.cu before its redesign), unchanged.
#pragma once
#include <cstdint>

#ifndef NL
#error "compile with -DNL=<number of 32-bit limbs>"
#endif

#define ACC (2 * NL + 1)

// acc += w * u * v   (acc has ACC words; the sum never leaves them)
__device__ __forceinline__ void mac_weighted(uint32_t* acc, const uint32_t* u, const uint32_t* v,
                                             uint32_t w) {
    uint32_t wu[NL + 1];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        c += (uint64_t)u[j] * w;
        wu[j] = (uint32_t)c;
        c >>= 32;
    }
    wu[NL] = (uint32_t)c;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
        c = 0;
#pragma unroll
        for (int j = 0; j <= NL; ++j) {
            c += (uint64_t)wu[j] * v[i] + acc[i + j];
            acc[i + j] = (uint32_t)c;
            c >>= 32;
        }
#pragma unroll
        for (int k = i + NL + 1; k < ACC; ++k) {
            c += acc[k];
            acc[k] = (uint32_t)c;
            c >>= 32;
        }
    }
}
