// Shared pieces of the stacked product's opt-in routes: the product columns
// in the reference's 16-bit form (kernel K6), the row maps and the
// shared-memory opt-in (K6, K7, K8). K7 and K8's reduction is in
// toeplitz_tc.cuh.
//
// K6 computes, per lane and output group g, from the stacked operands u_r
// (row urow[r] of U, negated mod N where uneg[r]) and v_r (row vrow[r] of V)
// with weights W[g, r]:
//
//     c[k] = sum_r W[g, r] (sum_{i+j=k} lo16(a_i b_j) + sum_{i+j=k-1} hi16(a_i b_j))
//
// over the 16-bit limbs a of u_r and b of v_r (L16 = 2 NL of them): the
// reference's unreduced column form (pallas_field.py: _school_cols_accum),
// 2 L16 columns below 2^32 (the host wrappers check L16 max_g sum W < 2^15).
//
// Layout: one block holds TILE lanes of one output group, one thread per
// lane. Each thread's columns live in shared memory, column k of thread t at
// cs[k * TILE + t] (consecutive threads on consecutive words: no bank
// conflicts), so only the thread itself touches them.
#pragma once
#include <cuda_runtime.h>

#include "field.cuh"

#define L16 (2 * NL)  // 16-bit limbs of an element (the reference's L)
#define TILE 64       // lanes per block, one thread each; two warps

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

// The 16-bit limbs of u_r, negated mod N where the row map says so.
__device__ __forceinline__ void load_u16(uint32_t* a, const uint32_t* U, const StackRows& t, int r,
                                         int64_t B, int SU, int64_t lane) {
    uint32_t u[NL];
    load_planes(u, U + (int64_t)t.urow[r] * B, (int64_t)SU * B, lane);
    cond_neg(u, (uint32_t)t.uneg[r]);
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        a[2 * j] = u[j] & 0xFFFFu;
        a[2 * j + 1] = u[j] >> 16;
    }
}

// cs[k * TILE + tid] = c[k] for this thread's lane (0 where `valid` is false).
//
// Product scanning with a sliding window: the limbs of u_r stay in
// registers, the rows run over the limbs of v_r (read from device memory,
// coalesced across the warp), and a window of L16 + 1 running column sums
// holds the columns i .. i + L16 of row i. After row i, column i is final:
// it leaves the window, weighted, into shared memory. The columns are sums
// of products of the two operands' limbs, symmetric in the operands, so
// scanning v's limbs by rows gives the reference's columns exactly.
__device__ __forceinline__ void school16_columns(uint32_t* cs, const uint32_t* __restrict__ U,
                                                 const uint32_t* __restrict__ V, const StackRows& t,
                                                 int S, int64_t B, int SU, int SV, int64_t lane,
                                                 bool valid) {
    const int tid = threadIdx.x;
#pragma unroll 4
    for (int k = 0; k < 2 * L16; ++k) cs[k * TILE + tid] = 0;
    if (!valid) return;
#pragma unroll 1
    for (int r = 0; r < S; ++r) {
        const uint32_t w = (uint32_t)t.W[r];
        if (w == 0) continue;
        uint32_t a[L16];
        load_u16(a, U, t, r, B, SU, lane);
        const uint32_t* vp = V + (int64_t)t.vrow[r] * B + lane;
        const int64_t vstride = (int64_t)SV * B;
        uint32_t win[L16 + 1];
#pragma unroll
        for (int j = 0; j <= L16; ++j) win[j] = 0;
#pragma unroll 1
        for (int i = 0; i < L16; ++i) {
            const uint32_t vi = vp[i * vstride];
#pragma unroll
            for (int j = 0; j < L16; ++j) {
                const uint32_t p = a[j] * vi;  // < 2^32: both limbs < 2^16
                win[j] += p & 0xFFFFu;
                win[j + 1] += p >> 16;
            }
            cs[i * TILE + tid] += w * win[0];
#pragma unroll
            for (int j = 0; j < L16; ++j) win[j] = win[j + 1];
            win[L16] = 0;
        }
#pragma unroll 4
        for (int j = 0; j < L16; ++j) cs[(L16 + j) * TILE + tid] += w * win[j];
    }
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
