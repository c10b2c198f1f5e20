// Stacked weighted Montgomery products: 16-bit schoolbook columns, then the
// reduction as two constant Toeplitz products on the tensor cores (kernel K7).
//
// Replaces the reference's hybrid kernel (snark_setup_tpu/ops/
// pallas_field.py, PallasFieldMul.v3 / _make_kernel_v3, _redc_v2_kernel).
// It computes K5's function,
//
//     out[:, g, lane] = (sum_r W[g, r] u_r v_r) R^{-1} mod N,  canonical,
//
// by the reference's route: the columns of K6 (stacked_routes.cuh:
// school16_columns), then m = c N' mod R as T_low4 (2 L16 x 4 L16 bytes)
// times the four byte planes of the low L16 columns, and u = m N as T_full
// (4 L16 x 2 L16 bytes) times the two byte planes of m, both as u8 x u8 ->
// s32 tensor-core products in which the block's 64 lanes are the wide
// dimension (toeplitz_redc). Out comes the same limbs as K5's.
//
// Bound on an H100: bytes at the BLS12-377 shapes, the CUDA cores' multiply-
// adds at the MNT ones. Per lane and output group: 2 L16
// words in per non-zero weight and L16 out; L16^2 multiply-adds per non-zero
// weight on the CUDA cores (16.75e12 /s), and 16 L16^2 byte multiply-adds
// for the two Toeplitz products on the int8 tensor cores (989.5e12 /s):
// 9216 at L16 = 24, 9.3 ps, against K5's NL^2 = 144 wide multiply-adds of
// its reduction, 8.6 ps on the CUDA cores. The design keeps the columns,
// the byte planes and the products' results in shared memory (1792 L16
// bytes a block: 84 KB at L16 = 48), the constant matrices in device memory
// (L2-resident, 18 KB each at L16 = 48), read by wmma fragment loads.
#include "stacked_routes.cuh"

extern __shared__ __align__(1024) unsigned char smem[];

#define CS_BYTES (2 * L16 * TILE * 4)
#define BT_BYTES (4 * L16 * TILE)
#define SMEM_BYTES (CS_BYTES + BT_BYTES + 4 * L16 * TILE * 4)

__global__ void __launch_bounds__(TILE)
stacked_mul_v3_kernel(const uint32_t* __restrict__ U, const uint32_t* __restrict__ V,
                      uint32_t* __restrict__ out, const int* __restrict__ table, int64_t B, int S,
                      int G, int SU, int SV, const unsigned char* __restrict__ tlow,
                      const unsigned char* __restrict__ tfull) {
    uint32_t* cs = (uint32_t*)smem;
    unsigned char* bt = smem + CS_BYTES;
    int* ys = (int*)(smem + CS_BYTES + BT_BYTES);
    const int64_t lane = (int64_t)blockIdx.x * TILE + threadIdx.x;
    const int g = blockIdx.y;
    const StackRows t = stack_rows(table, g, S, G);
    school16_columns(cs, U, V, t, S, B, SU, SV, lane, lane < B);
    uint32_t res[NL];
    toeplitz_redc(cs, bt, ys, tlow, tfull, 1, res);  // every thread: it holds barriers
    if (lane < B) store_planes(out + (int64_t)g * B, res, (int64_t)G * B, lane);
}

static int smem_allowed = 0;

// Plain C entry point (loaded with ctypes); arguments as K5's
// stacked_mul_launch plus the blocked byte matrices tlow ([4 L16 / 16][2 L16]
// [16]) and tfull ([2 L16 / 16][4 L16][16]), device pointers. Returns
// cudaGetLastError().
extern "C" int stacked_mul_v3_launch(const void* U, const void* V, void* out, const void* table,
                                     long long B, int S, int G, int SU, int SV, const void* consts,
                                     const void* tlow, const void* tfull, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemcpyToSymbolAsync(FC, consts, sizeof(FieldConsts), 0,
                                              cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(stacked_mul_v3_kernel, SMEM_BYTES, &smem_allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((B + TILE - 1) / TILE), (unsigned)G);
    stacked_mul_v3_kernel<<<grid, TILE, SMEM_BYTES, s>>>(
        (const uint32_t*)U, (const uint32_t*)V, (uint32_t*)out, (const int*)table, (int64_t)B, S, G,
        SU, SV, (const unsigned char*)tlow, (const unsigned char*)tfull);
    return (int)cudaGetLastError();
}

extern "C" int stacked_mul_v3_nl(void) { return NL; }
