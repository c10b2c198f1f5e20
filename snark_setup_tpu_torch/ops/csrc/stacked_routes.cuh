// Shared pieces of the stacked product's kernels (K5 and the opt-in routes
// K6, K7 and K8): the row maps, the modulus by value with the conditional
// negation that reads it, and the shared-memory opt-in. K6's column schoolbook is in
// stacked_cols.cu, K7 and K8's reduction in toeplitz_tc.cuh.
#pragma once
#include <cuda_runtime.h>

#include "field.cuh"

#define L16 (2 * NL)  // 16-bit limbs of an element (the reference's L)

// table: W (G * S) | urow (S) | vrow (S) | uneg (S), int32 (K5's layout)
struct StackRows {
    const int* W;
    const int* urow;
    const int* vrow;
    const int* uneg;
};

__device__ __forceinline__ StackRows stack_rows(const int* table, int g, int S, int G) {
    StackRows t;
    t.W = table + (int64_t)g * S;
    t.urow = table + (int64_t)G * S;
    t.vrow = t.urow + S;
    t.uneg = t.vrow + S;
    return t;
}

// The routes' field constants, by value: the kernels' __grid_constant__
// parameter, packed by the host wrapper (ops/cuda_routes.py). K7 and K8
// fold n0 and N' into their constant matrices.
struct TcConsts {
    uint32_t N[NL];
};

// r = -a mod N where neg is 1, a where it is 0 (0 stays 0), N by value
__device__ __forceinline__ void cond_neg_n(uint32_t* a, uint32_t neg, const uint32_t* N) {
    uint32_t d[NL];
    uint32_t nz = 0;
    int64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        nz |= a[j];
        c += (int64_t)N[j] - (int64_t)a[j];
        d[j] = (uint32_t)c;
        c >>= 32;
    }
    const uint32_t m = (neg && nz) ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int j = 0; j < NL; ++j) a[j] = (d[j] & m) | (a[j] & ~m);
}

// r = t - N if t >= N else t   (t < 2N), N by value
__device__ __forceinline__ void cond_sub_n(uint32_t* r, const uint32_t* t, const uint32_t* N) {
    uint32_t d[NL];
    int64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        c += (int64_t)t[j] - (int64_t)N[j];
        d[j] = (uint32_t)c;
        c >>= 32;
    }
    const uint32_t keep = (uint32_t)c;  // all ones where t < N
#pragma unroll
    for (int j = 0; j < NL; ++j) r[j] = (t[j] & keep) | (d[j] & ~keep);
}

// Shared memory above the default 48 KB needs the opt-in attribute, set
// once per kernel (the bytes never change within a library).
template <typename Kern>
static cudaError_t allow_smem(Kern kernel, int bytes, int* done) {
    if (*done) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) *done = 1;
    return err;
}
