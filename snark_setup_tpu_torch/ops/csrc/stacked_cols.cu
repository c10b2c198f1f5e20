// Stacked weighted product columns, not reduced (kernel K6).
//
// Replaces the reference's columns-only kernel (snark_setup_tpu/ops/
// pallas_field.py, PallasFieldMul.cols / _make_cols_kernel). It computes the
// same function:
//
//     out[k, g, lane] = sum_r W[g, r] cols16(u_r * v_r)[k],  k < 2 L16,
//
// the reference's column form (low 16 bits of every limb product in column
// i + j, high 16 bits in column i + j + 1; stacked_routes.cuh), with u_r and
// v_r read through K5's row maps (u_r negated mod N where uneg[r]). The
// caller reduces the columns with the matrix-product Toeplitz reduction
// (ops/fp.py: FpOps.redc_cols_matmul). U, V are (L16, SU|SV, B) planes of
// 16-bit limbs in 32-bit words; out is (2 L16, G, B) int64 (a column can
// reach 2^32 - 1, which int32 would read as negative).
//
// Bound on an H100: bytes at the BLS12-377 shapes, multiply-adds at the MNT
// ones. Per lane and output group the kernel reads 2 L16 words per non-zero
// weight and writes 2 L16 eight-byte columns, and does L16^2 multiply-adds
// per non-zero weight: ~2 multiply-adds per byte at L16 = 24, 5-6 at L16 =
// 48, against the card's 16.75e12 / 3.35e12 = 5. One thread per
// (lane, output group), K5's shape: the limbs of u_r in registers, the rows
// over v_r's limbs, a sliding window of running column sums (no (L, L)
// table anywhere), each finished column added into shared memory.
#include "stacked_routes.cuh"

extern __shared__ __align__(1024) unsigned char smem[];

#define SMEM_BYTES (2 * L16 * TILE * 4)

__global__ void __launch_bounds__(TILE)
stacked_cols_kernel(const uint32_t* __restrict__ U, const uint32_t* __restrict__ V,
                    long long* __restrict__ out, const int* __restrict__ table, int64_t B, int S,
                    int G, int SU, int SV) {
    uint32_t* cs = (uint32_t*)smem;
    const int64_t lane = (int64_t)blockIdx.x * TILE + threadIdx.x;
    const int g = blockIdx.y;
    const StackRows t = stack_rows(table, g, S, G);
    school16_columns(cs, U, V, t, S, B, SU, SV, lane, lane < B);
    if (lane >= B) return;  // ragged edge: the last block is partly idle
#pragma unroll 4
    for (int k = 0; k < 2 * L16; ++k)
        out[((int64_t)k * G + g) * B + lane] = (long long)cs[k * TILE + threadIdx.x];
}

static int smem_allowed = 0;

// Plain C entry point (loaded with ctypes); arguments as K5's
// stacked_mul_launch, out an int64 device buffer. Returns cudaGetLastError().
extern "C" int stacked_cols_launch(const void* U, const void* V, void* out, const void* table,
                                   long long B, int S, int G, int SU, int SV, const void* consts,
                                   void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemcpyToSymbolAsync(FC, consts, sizeof(FieldConsts), 0,
                                              cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(stacked_cols_kernel, SMEM_BYTES, &smem_allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((B + TILE - 1) / TILE), (unsigned)G);
    stacked_cols_kernel<<<grid, TILE, SMEM_BYTES, s>>>((const uint32_t*)U, (const uint32_t*)V,
                                                       (long long*)out, (const int*)table,
                                                       (int64_t)B, S, G, SU, SV);
    return (int)cudaGetLastError();
}

extern "C" int stacked_cols_nl(void) { return NL; }
