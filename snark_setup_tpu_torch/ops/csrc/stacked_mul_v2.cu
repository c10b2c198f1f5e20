// Stacked weighted Montgomery products: f32 byte-plane schoolbook, then K7's
// Toeplitz reduction on the tensor cores (kernel K8).
//
// Replaces the reference's fused f32 kernel (snark_setup_tpu/ops/
// pallas_field.py, PallasFieldMul.v2 / _make_kernel_v2, _school_f32_accum).
// It computes K5's function by the reference's route: with a = al + 2^8 ah
// and b = bl + 2^8 bh per 16-bit limb, three float32 column planes
//
//     A1[k] = sum w al_i bl_j,  A2[k] = sum w (al_i bh_j + ah_i bl_j),
//     A3[k] = sum w ah_i bh_j    (i + j = k, over the stacked rows),
//
// then c[k] = A1[k] + 2^8 A2[k] + A3[k - 1] in 32 bits, then the reduction of
// stacked_routes.cuh (toeplitz_redc). The host wrapper takes only weights
// that the reference's v2_bounds accepts: every term is an integer and every
// partial sum of a plane stays below 2^24, so each f32 addition is exact and
// the order of the additions cannot change a bit; this kernel sums per
// stacked row and column, in another order than the reference's.
//
// Bound on an H100: bytes at the BLS12-377 shape, the fp32 FMAs at the MNT4
// ones. Per lane and output group: 2 L16
// words in per non-zero weight and L16 out; 4 L16^2 f32 multiply-adds per
// non-zero weight (33.5e12 /s), the Toeplitz products as K7's. The reference
// keeps A1, A2 and A3 as three 2 L16 planes per lane: 288 floats at L16 = 48,
// more than a thread's 255 registers. Here they live in shared memory, and
// the product is scanned column by column with three running sums, the
// operands' (weighted) byte planes in shared memory as float2 pairs (2560
// L16 bytes a block: 120 KB at L16 = 48; the reduction reuses them).
#include "stacked_routes.cuh"

extern __shared__ __align__(1024) unsigned char smem[];

#define A_BYTES (3 * 2 * L16 * TILE * 4)
#define OP_BYTES (2 * L16 * TILE * 8)
#define SMEM_BYTES (A_BYTES + OP_BYTES)

__global__ void __launch_bounds__(TILE)
stacked_mul_v2_kernel(const uint32_t* __restrict__ U, const uint32_t* __restrict__ V,
                      uint32_t* __restrict__ out, const int* __restrict__ table, int64_t B, int S,
                      int G, int SU, int SV, const unsigned char* __restrict__ tlow,
                      const unsigned char* __restrict__ tfull, int fused_s) {
    float* A1 = (float*)smem;
    float* A2 = A1 + 2 * L16 * TILE;
    float* A3 = A2 + 2 * L16 * TILE;
    float2* ua = (float2*)(smem + A_BYTES);  // (w al_i, w ah_i), [L16][TILE]
    float2* vb = ua + L16 * TILE;            // (bl_j, bh_j)
    const int tid = threadIdx.x;
    const int64_t lane = (int64_t)blockIdx.x * TILE + tid;
    const int g = blockIdx.y;
    const StackRows t = stack_rows(table, g, S, G);
#pragma unroll 4
    for (int k = 0; k < 2 * L16; ++k) A1[k * TILE + tid] = A2[k * TILE + tid] = A3[k * TILE + tid] = 0.f;
    if (lane < B) {
#pragma unroll 1
        for (int r = 0; r < S; ++r) {
            const uint32_t w = (uint32_t)t.W[r];
            if (w == 0) continue;
            const float wf = (float)w;
            uint32_t a[L16];
            load_u16(a, U, t, r, B, SU, lane);
#pragma unroll
            for (int i = 0; i < L16; ++i)
                ua[i * TILE + tid] = make_float2((float)(a[i] & 0xFFu) * wf, (float)(a[i] >> 8) * wf);
            const uint32_t* vp = V + (int64_t)t.vrow[r] * B + lane;
#pragma unroll 4
            for (int j = 0; j < L16; ++j) {
                const uint32_t b = vp[(int64_t)j * SV * B];
                vb[j * TILE + tid] = make_float2((float)(b & 0xFFu), (float)(b >> 8));
            }
#pragma unroll 1
            for (int k = 0; k < 2 * L16 - 1; ++k) {
                const int lo = k < L16 ? 0 : k - L16 + 1;
                const int hi = k < L16 ? k : L16 - 1;
                float a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
                for (int i = lo; i <= hi; ++i) {
                    const float2 x = ua[i * TILE + tid];
                    const float2 y = vb[(k - i) * TILE + tid];
                    a1 = fmaf(x.x, y.x, a1);
                    a2 = fmaf(x.x, y.y, a2);
                    a2 = fmaf(x.y, y.x, a2);
                    a3 = fmaf(x.y, y.y, a3);
                }
                A1[k * TILE + tid] += a1;
                A2[k * TILE + tid] += a2;
                A3[k * TILE + tid] += a3;
            }
        }
    }
    // the operand region becomes the columns and the byte planes, the
    // A-planes' region the products' results: wait until every thread is
    // out of its schoolbook
    __syncthreads();
    uint32_t* cs = (uint32_t*)(smem + A_BYTES);
    unsigned char* bt = smem + A_BYTES + 2 * L16 * TILE * 4;
    int* ys = (int*)smem;
    uint32_t prev = 0;
#pragma unroll 4
    for (int k = 0; k < 2 * L16; ++k) {
        const uint32_t a3 = (uint32_t)A3[k * TILE + tid];
        cs[k * TILE + tid] = (uint32_t)A1[k * TILE + tid] + ((uint32_t)A2[k * TILE + tid] << 8) + prev;
        prev = a3;
    }
    uint32_t res[NL];  // (the reduction's first barrier precedes its writes over the A-planes)
    toeplitz_redc(cs, bt, ys, tlow, tfull, fused_s, res);
    if (lane < B) store_planes(out + (int64_t)g * B, res, (int64_t)G * B, lane);
}

static int smem_allowed = 0;

// Plain C entry point (loaded with ctypes); arguments as K7's
// stacked_mul_v3_launch plus fused_s (from v2_bounds). Returns
// cudaGetLastError().
extern "C" int stacked_mul_v2_launch(const void* U, const void* V, void* out, const void* table,
                                     long long B, int S, int G, int SU, int SV, const void* consts,
                                     const void* tlow, const void* tfull, int fused_s,
                                     void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemcpyToSymbolAsync(FC, consts, sizeof(FieldConsts), 0,
                                              cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(stacked_mul_v2_kernel, SMEM_BYTES, &smem_allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((B + TILE - 1) / TILE), (unsigned)G);
    stacked_mul_v2_kernel<<<grid, TILE, SMEM_BYTES, s>>>(
        (const uint32_t*)U, (const uint32_t*)V, (uint32_t*)out, (const int*)table, (int64_t)B, S, G,
        SU, SV, (const unsigned char*)tlow, (const unsigned char*)tfull, fused_s);
    return (int)cudaGetLastError();
}

extern "C" int stacked_mul_v2_nl(void) { return NL; }
