// Stacked weighted Montgomery products, one thread per (lane, output group).
//
// Replaces the reference's stacked-product kernel (snark_setup_tpu/ops/
// pallas_field.py, PallasFieldMul.__call__ / _make_kernel). It computes the
// same function:
//
//     out[:, g, lane] = (sum_r W[g, r] * u_r * v_r) * R^{-1} mod N,  canonical,
//
// where u_r is row urow[r] of U, negated mod N where uneg[r] is set, and v_r
// is row vrow[r] of V. U (L, SU, B), V (L, SV, B) and out (L, G, B) are planes
// of 16-bit limbs in 32-bit words (L = 2 NL); W (G, S) holds small
// non-negative weights. With identity row maps and no negation this is
// exactly the reference's primitive; the maps let the extension towers
// (ops/ext.py) feed their coefficient planes in place, where the reference
// first gathers (and negates) an (L, S*T, B) copy of each operand.
//
// Per thread: an exact (2 NL + 1)-word accumulator of the weighted sum
// (stacked_acc.cuh, shared with K7), then one Montgomery
// reduction and one conditional subtraction. The host wrapper
// (ops/cuda_mul.py) checks max_g sum_r W[g, r] * N < R and 2 N < R: then the
// reduced value is below 2 N and one subtraction makes it canonical.
//
// Bound on an H100: integer multiply-adds. Per lane and output group the
// kernel moves 2 NL words per non-zero weight in and NL words out, and does
// NL (NL + 1) wide multiply-adds per non-zero weight plus NL^2 for the
// reduction: ~8 multiply-adds per byte at NL = 12, ~16 at NL = 24, above the
// card's 16.75e12 / 3.35e12 = 5 per byte. The product and the reduction are
// fully unrolled, so the accumulator, the weighted operand and the other
// operand stay in registers (about 100 words at NL = 24); the loop over the
// stacked rows is rolled. Weights and row maps are a small int32 table in
// device memory that every thread of a block reads at the same address.
#include <cuda_runtime.h>
#include "field.cuh"
#include "stacked_acc.cuh"

#define BLOCK 128

// acc = acc * R^{-1} (exact: acc + M N with the low NL words cancelled),
// result in acc[NL .. 2 NL]
__device__ __forceinline__ void redc_wide(uint32_t* acc) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
        const uint32_t m = acc[i] * FC.n0;
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < NL; ++j) {
            c += (uint64_t)m * FC.N[j] + acc[i + j];
            acc[i + j] = (uint32_t)c;
            c >>= 32;
        }
#pragma unroll
        for (int k = i + NL; k < ACC; ++k) {
            c += acc[k];
            acc[k] = (uint32_t)c;
            c >>= 32;
        }
    }
}

// table: W (G * S) | urow (S) | vrow (S) | uneg (S), int32
__global__ void __launch_bounds__(BLOCK)
stacked_mul_kernel(const uint32_t* __restrict__ U, const uint32_t* __restrict__ V,
                   uint32_t* __restrict__ out, const int* __restrict__ table, int64_t B, int S,
                   int G, int SU, int SV) {
    const int64_t lane = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
    const int g = blockIdx.y;
    if (lane >= B) return;  // ragged edge: the last block is partly idle
    const int* W = table + (int64_t)g * S;
    const int* urow = table + (int64_t)G * S;
    const int* vrow = urow + S;
    const int* uneg = vrow + S;

    uint32_t acc[ACC];
#pragma unroll
    for (int k = 0; k < ACC; ++k) acc[k] = 0;
#pragma unroll 1
    for (int r = 0; r < S; ++r) {
        const uint32_t w = (uint32_t)W[r];
        if (w == 0) continue;
        uint32_t u[NL], v[NL];
        // limb l of row s sits at (l * SU + s) * B + lane: plane stride SU * B
        load_planes(u, U + (int64_t)urow[r] * B, (int64_t)SU * B, lane);
        load_planes(v, V + (int64_t)vrow[r] * B, (int64_t)SV * B, lane);
        cond_neg(u, (uint32_t)uneg[r]);
        mac_weighted(acc, u, v, w);
    }
    redc_wide(acc);
    uint32_t res[NL];
    cond_sub_store(res, acc + NL);  // acc[2 NL] == 0: the value is < 2 N < R
    store_planes(out + (int64_t)g * B, res, (int64_t)G * B, lane);
}

// Plain C entry point (loaded with ctypes). `consts` is a DEVICE pointer to
// the FieldConsts block (N, R mod N, beta — unused here —, n0 = -N^{-1} mod
// 2^32), copied to constant memory on `stream` ahead of the launch, as the
// ladder kernel does. `table` is a device pointer (layout above). Returns
// cudaGetLastError().
extern "C" int stacked_mul_launch(const void* U, const void* V, void* out, const void* table,
                                  long long B, int S, int G, int SU, int SV, const void* consts,
                                  void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemcpyToSymbolAsync(FC, consts, sizeof(FieldConsts), 0,
                                              cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((B + BLOCK - 1) / BLOCK), (unsigned)G);
    stacked_mul_kernel<<<grid, BLOCK, 0, s>>>((const uint32_t*)U, (const uint32_t*)V,
                                              (uint32_t*)out, (const int*)table, (int64_t)B, S,
                                              G, SU, SV);
    return (int)cudaGetLastError();
}

extern "C" int stacked_mul_nl(void) { return NL; }
