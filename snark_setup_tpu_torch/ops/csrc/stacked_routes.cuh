// Shared pieces of the stacked product's three opt-in routes: the product
// columns in the reference's 16-bit form (kernels K6 and K7) and the Montgomery
// reduction as two constant Toeplitz products on the tensor cores (K7 and K8).
//
// Every route computes, per lane and output group g, from the stacked
// operands u_r (row urow[r] of U, negated mod N where uneg[r]) and v_r (row
// vrow[r] of V) with weights W[g, r]:
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
// conflicts), so only the thread itself touches them until the reduction's
// first barrier.
#pragma once
#include <cuda_runtime.h>
#include <mma.h>

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

// Byte k of lane n in the blocked (K x TILE) operand of a Toeplitz product:
// [K / 16][TILE][16], so that every 16 x 16 fragment starts on a 256-byte
// boundary (wmma loads want 256-bit alignment).
__device__ __forceinline__ void bt_put(unsigned char* bt, int k, int n, uint32_t v) {
    bt[((k >> 4) * TILE + n) * 16 + (k & 15)] = (unsigned char)v;
}

// Y (M x TILE int32, row-major, shared) = A (M x K bytes) . Bt (K x TILE
// bytes) on the tensor cores: u8 x u8 -> s32 fragments of 16 x 16 x 16,
// exact (every sum < 2^24). A is the constant matrix in device memory,
// blocked as [K / 16][M][16]; Bt the byte planes in shared memory, blocked
// as `bt_put` writes them. The two warps of the block share out the
// (M / 16) x (TILE / 16) output fragments.
template <int M, int K>
__device__ __forceinline__ void toeplitz_product(const unsigned char* __restrict__ A,
                                                 const unsigned char* Bt, int* Y) {
    using namespace nvcuda;
    constexpr int NT = TILE / 16;
    constexpr int NW = TILE / 32;
    const int warp = threadIdx.x >> 5;
#pragma unroll 1
    for (int f = warp; f < (M / 16) * NT; f += NW) {
        const int mi = f / NT, ni = f % NT;
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
        wmma::fill_fragment(acc, 0);
#pragma unroll 1
        for (int kt = 0; kt < K / 16; ++kt) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, A + ((int64_t)kt * M + mi * 16) * 16, 16);
            wmma::load_matrix_sync(fb, Bt + ((int64_t)kt * TILE + ni * 16) * 16, 16);
            wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Y + mi * 16 * TILE + ni * 16, acc, TILE, wmma::mem_row_major);
    }
}

// The reference's _redc_v2_kernel for this thread's lane: from the columns
// cs (2 L16 x TILE, each < 2^32) to the canonical Montgomery product
// (res, NL words).
//
//   m16 = fold(T_low4 . bytes4(c[:L16]))   (unresolved low columns: mod R
//                                            drops what escapes them)
//   m   = resolve(m16) mod R
//   u16 = fold(T_full . bytes2(m))         (u = m N)
//   s   = resolve(c + u16); res = s[L16:] - N if >= N
//
// `fused_s` = 0 resolves c before adding u16, as the reference does where
// c + u16 might not fit 32 bits; the carries here run in 64 bits, so both
// orders give the same exact value. Every thread of the block must call
// this (it holds __syncthreads); bt (4 L16 x TILE bytes) and ys (4 L16 x
// TILE int32) are shared scratch, cs is read and not written.
__device__ __forceinline__ void toeplitz_redc(const uint32_t* cs, unsigned char* bt, int* ys,
                                              const unsigned char* __restrict__ tlow,
                                              const unsigned char* __restrict__ tfull, int fused_s,
                                              uint32_t* res) {
    const int tid = threadIdx.x;
#pragma unroll 4
    for (int i = 0; i < L16; ++i) {
        const uint32_t c = cs[i * TILE + tid];
        bt_put(bt, i, tid, c & 0xFFu);
        bt_put(bt, L16 + i, tid, (c >> 8) & 0xFFu);
        bt_put(bt, 2 * L16 + i, tid, (c >> 16) & 0xFFu);
        bt_put(bt, 3 * L16 + i, tid, c >> 24);
    }
    __syncthreads();
    toeplitz_product<2 * L16, 4 * L16>(tlow, bt, ys);
    __syncthreads();
    // rows r < L16 are byte digit 2r of m, rows L16 + r digit 2r + 1
    uint32_t carry = 0;
#pragma unroll 4
    for (int r = 0; r < L16; ++r) {
        const uint64_t v = (uint64_t)(uint32_t)ys[r * TILE + tid] +
                           ((uint64_t)(uint32_t)ys[(L16 + r) * TILE + tid] << 8) + carry;
        const uint32_t m = (uint32_t)v & 0xFFFFu;
        carry = (uint32_t)(v >> 16);
        bt_put(bt, r, tid, m & 0xFFu);
        bt_put(bt, L16 + r, tid, m >> 8);
    }
    __syncthreads();
    toeplitz_product<4 * L16, 2 * L16>(tfull, bt, ys);
    __syncthreads();
    uint64_t cc = 0, sc = 0;
#pragma unroll
    for (int k = 0; k < 2 * L16; ++k) {
        const uint64_t u16 = (uint64_t)(uint32_t)ys[k * TILE + tid] +
                             ((uint64_t)(uint32_t)ys[(2 * L16 + k) * TILE + tid] << 8);
        uint64_t ck = cs[k * TILE + tid];
        if (!fused_s) {
            ck += cc;
            cc = ck >> 16;
            ck &= 0xFFFFu;
        }
        const uint64_t v = ck + u16 + sc;
        sc = v >> 16;
        if (k >= L16) {
            const int j = k - L16;
            const uint32_t limb = (uint32_t)v & 0xFFFFu;
            if (j & 1) res[j >> 1] |= limb << 16;
            else res[j >> 1] = limb;
        }
    }
    cond_sub_store(res, res);  // s[L16:] < 2N (the wrapper checks sum W * N < R, 2N < R)
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
