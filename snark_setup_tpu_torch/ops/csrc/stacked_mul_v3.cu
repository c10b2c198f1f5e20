// Stacked weighted Montgomery products: K5's exact 32-bit schoolbook, then
// the reduction as two constant Toeplitz products on the int8 tensor cores
// (kernel K7).
//
// Replaces the reference's hybrid kernel (snark_setup_tpu/ops/
// pallas_field.py:536, PallasFieldMul.v3 / _make_kernel_v3 :368,
// _redc_v2_kernel :297). It computes K5's function,
//
//     out[:, g, lane] = (sum_r W[g, r] u_r v_r) R^{-1} mod N,  canonical,
//
// with K5's row maps (u_r negated mod N where uneg[r]). The reference takes
// 16-bit schoolbook columns into its tensor-core reduction; here each
// thread (one lane) accumulates the weighted sum exactly in registers with
// K5's 32-bit multiply-adds (stacked_acc.cuh: mac_weighted, 2 NL + 1 words)
// and hands the resolved sum to the warp's tensor-core reduction
// (toeplitz_tc.cuh: tc_redc): 2 byte planes in, not 4. Out come K5's limbs.
//
// Bound on an H100: the multiply-adds of the schoolbook on the IMAD pipe,
// as K5's: NL (NL + 1) wide multiply-adds per non-zero weight; per output
// the reduction's 12 L16^2 byte multiply-adds go to the tensor cores
// (7.0 ps a lane at L16 = 24 on 989.5e12 /s) in place of K5's NL^2 wide
// ones, and the thread folds the digit rows: ~4 NL byte carries and 2 NL
// word sums. Bytes: 2 L16 words in per non-zero weight, L16 out.
//
// Block: 4 warps, 128 lanes of one output group; the two packed matrices
// staged once a block (27 KB at NL 24, 9 KB at NL 12) plus 6 / 5 KB of
// scratch a warp: 51 / 29 KB a block. Registers, spills and warps an SM
// from ptxas are in PERF.md (K5's 168 registers at NL 24 hold it to 12
// warps an SM).
#include <cstring>

#include "stacked_acc.cuh"
#include "toeplitz_tc.cuh"

extern __shared__ __align__(1024) unsigned char smem[];

#define WARPS 4
#define BLOCK (32 * WARPS)
#define SMEM_BYTES (TC_BYTES + WARPS * TC_WARP_BYTES)

__global__ void __launch_bounds__(BLOCK)
stacked_mul_v3_kernel(const uint32_t* __restrict__ U, const uint32_t* __restrict__ V,
                      uint32_t* __restrict__ out, const int* __restrict__ table, int64_t B, int S,
                      int G, int SU, int SV, const unsigned char* __restrict__ tmats,
                      const __grid_constant__ TcConsts fc) {
    tc_stage(smem, tmats);  // lands while the schoolbook runs
    const int64_t lane = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
    const int g = blockIdx.y;
    const StackRows t = stack_rows(table, g, S, G);
    uint32_t acc[ACC];
#pragma unroll
    for (int k = 0; k < ACC; ++k) acc[k] = 0;
    if (lane < B) {  // lanes past B reduce zeros: every thread takes part in the warp's products
#pragma unroll 1
        for (int r = 0; r < S; ++r) {
            const uint32_t w = (uint32_t)t.W[r];
            if (w == 0) continue;
            uint32_t u[NL], v[NL];
            load_planes(u, U + (int64_t)t.urow[r] * B, (int64_t)SU * B, lane);
            load_planes(v, V + (int64_t)t.vrow[r] * B, (int64_t)SV * B, lane);
            cond_neg_n(u, (uint32_t)t.uneg[r], fc.N);
            mac_weighted(acc, u, v, w);
        }
    }
    tc_wait();
    uint32_t res[NL];
    tc_redc(acc, res, smem + TC_BYTES + (threadIdx.x >> 5) * TC_WARP_BYTES, smem, fc.N);
    if (lane < B) store_planes(out + (int64_t)g * B, res, (int64_t)G * B, lane);
}

static int smem_allowed = 0;

// Plain C entry point (loaded with ctypes); arguments as K5's
// stacked_mul_launch except `consts`, a HOST pointer to the TcConsts words
// (passed by value), and `tmats`, the device buffer of both packed
// matrices (TC_BYTES). Returns cudaGetLastError().
extern "C" int stacked_mul_v3_launch(const void* U, const void* V, void* out, const void* table,
                                     long long B, int S, int G, int SU, int SV, const void* consts,
                                     const void* tmats, void* stream) {
    TcConsts fc;
    memcpy(&fc, consts, sizeof fc);
    cudaError_t err = allow_smem(stacked_mul_v3_kernel, SMEM_BYTES, &smem_allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((B + BLOCK - 1) / BLOCK), (unsigned)G);
    stacked_mul_v3_kernel<<<grid, BLOCK, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint32_t*)U, (const uint32_t*)V, (uint32_t*)out, (const int*)table, (int64_t)B, S, G,
        SU, SV, (const unsigned char*)tmats, fc);
    return (int)cudaGetLastError();
}

extern "C" int stacked_mul_v3_nl(void) { return NL; }
extern "C" int stacked_mul_v3_tc_bytes(void) { return TC_BYTES; }
