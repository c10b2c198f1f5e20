// Stacked weighted Montgomery products: float32 byte-plane schoolbook on the
// FMA pipe, then the tensor-core Toeplitz reduction (kernel K8).
//
// Replaces the reference's fused f32 kernel (snark_setup_tpu/ops/
// pallas_field.py:596, PallasFieldMul.v2 / _make_kernel_v2 :330,
// _school_f32_accum :242, _redc_v2_kernel :297). It computes K5's function
// by the reference's route: with a = al + 2^8 ah and b = bl + 2^8 bh per
// 16-bit limb, three float32 column planes
//
//     A1[k] = sum w al_i bl_j,  A2[k] = sum w (al_i bh_j + ah_i bl_j),
//     A3[k] = sum w ah_i bh_j    (i + j = k, over the stacked rows),
//
// then c[k] = A1[k] + 2^8 A2[k] + A3[k - 1], resolved into 2 NL words, then
// the reduction of toeplitz_tc.cuh. Exactness does not depend on the order
// of the additions: every term is a non-negative integer and the host
// wrapper takes only weights that the reference's v2_bounds accepts, under
// which every whole column sum is below 2^24, so every partial sum is an
// integer below 2^24 and every f32 addition is exact. The kernel adds in
// another order than the reference's (per thread, then across the team, and
// over the stacked rows) and gets the same bits.
//
// Bound on an H100: its own f32 FMAs, 16 NL^2 per non-zero weight (4 L16^2)
// at 33.5e12 /s, 4x K5's multiply-adds: this route cannot beat K5, its
// target is that floor. Bytes: 2 L16 words in per non-zero weight, L16 out.
//
// Layout: a team of T8 = L16 / 12 threads of one warp per lane (2 at NL 12,
// 4 at NL 24), thread tm of the team owning 12 limbs of v_r, j in
// [12 tm, 12 tm + 12), as 24 floats in registers. The limbs of u_r stay as
// NL words in registers; each step i takes limb i's two bytes to weighted
// floats (a byte permute into a float's mantissa and one FMA each) and does
// 48 FMAs into a window of 3 x 12 running column sums (columns i + 12 tm ..
// + 11). Column i + 12 tm is then complete in this thread and is added into
// the warp's column planes in shared memory, which every thread of the team
// feeds: thread tm + 1 adds to a column 12 steps before thread tm does, and
// a __syncwarp every 12 steps orders the two. So no FMA is wasted (each
// thread does exactly its 48 x 12 products), each operand byte is loaded
// once a row, and shared memory takes 3 read-modify-writes per 48 FMAs. The
// planes' row stride SK makes those conflict-free. After the last row each
// thread combines 24 columns of c; then 2 (NL 24) / 4 (NL 12) warps of the
// block take its lanes 32 to a warp, one thread a lane, resolve c into
// 2 NL words and run tc_redc, whose per-lane folds are serial: spread over
// 32 lanes a warp they cost a quarter / half of what the teams' 8 / 16
// lanes a warp would.
//
// Block: 8 warps, 64 lanes at NL 24 (128 at NL 12); shared memory: the two
// packed matrices (27 / 9 KB) and ~10 KB of planes a warp (the reduction's
// scratch reuses them): 105 / 87 KB, two blocks = 16 warps an SM.
#include <cstring>

#include "toeplitz_tc.cuh"

extern __shared__ __align__(1024) unsigned char smem[];

#define C8 12                  // limbs of v a thread owns
#define T8 (L16 / C8)          // threads a lane
#define LANES8 (32 / T8)       // lanes a warp
#define KC (2 * L16 / T8)      // columns each thread combines
#define WARPS 8
#define BLOCK (32 * WARPS)
#define LPB (WARPS * LANES8)   // lanes a block

// Words between two columns of a warp's planes (plane p of lane l at
// p LANES8 + l): the smallest stride from 3 LANES8 up at which the T8
// threads of a team, adding to columns 12 apart, hit T8 disjoint runs of
// LANES8 banks (C8 SK mod 32 an odd multiple of LANES8).
constexpr int plane_stride() {
    int sk = 3 * LANES8;
    while ((C8 * sk) % 32 % LANES8 != 0 || (C8 * sk) % 32 / LANES8 % 2 != 1) ++sk;
    return sk;
}
constexpr int SK = plane_stride();
#define PLANE_BYTES (2 * L16 * SK * 4)
#define SMEM_BYTES (TC_BYTES + WARPS * PLANE_BYTES)

static_assert(T8 * C8 == L16, "the team's v limbs must cover the element");
static_assert(TC_WARP_BYTES <= PLANE_BYTES, "the reduction's scratch reuses the planes");
static_assert(LPB == 32 * (WARPS / T8), "the reducing warps take every lane of the block");

// 2^23 + byte `sel` of x as a float: (x's byte in the mantissa of 0x4B000000)
__device__ __forceinline__ float magic_byte(uint32_t x, uint32_t sel) {
    return __uint_as_float(__byte_perm(x, 0x4B00u, 0x5440u | sel));
}

__global__ void __launch_bounds__(BLOCK, 2)
stacked_mul_v2_kernel(const uint32_t* __restrict__ U, const uint32_t* __restrict__ V,
                      uint32_t* __restrict__ out, const int* __restrict__ table, int64_t B, int S,
                      int G, int SU, int SV, const unsigned char* __restrict__ tmats,
                      const __grid_constant__ TcConsts fc) {
    tc_stage(smem, tmats);  // lands while the schoolbook runs
    const int lid = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int l = lid % LANES8, tm = lid / LANES8;  // lane of the warp, thread of the team
    const int64_t lane = (int64_t)blockIdx.x * LPB + warp * LANES8 + l;
    const bool valid = lane < B;  // lanes past B sum zeros: every thread takes part
    const int g = blockIdx.y;
    const StackRows t = stack_rows(table, g, S, G);
    float* A = (float*)(smem + TC_BYTES + warp * PLANE_BYTES);
    float* mine = A + tm * C8 * SK + l;  // plane p of column tm C8 + k at mine[k SK + p LANES8]
    for (int o = lid; o < 2 * L16 * SK; o += 32) A[o] = 0.f;
    __syncwarp();
#pragma unroll 1
    for (int r = 0; r < S; ++r) {
        const uint32_t w = (uint32_t)t.W[r];
        if (w == 0) continue;
        uint32_t u[NL];
        float bl[C8], bh[C8];
#pragma unroll
        for (int j = 0; j < NL; ++j) u[j] = 0;
#pragma unroll
        for (int c = 0; c < C8; ++c) bl[c] = bh[c] = 0.f;
        if (valid) {
            load_planes(u, U + (int64_t)t.urow[r] * B, (int64_t)SU * B, lane);
            cond_neg_n(u, (uint32_t)t.uneg[r], fc.N);
            const uint32_t* vp = V + ((int64_t)tm * C8 * SV + t.vrow[r]) * B + lane;
#pragma unroll
            for (int c = 0; c < C8; ++c) {
                const uint32_t b = vp[(int64_t)c * SV * B];
                bl[c] = (float)(b & 0xFFu);
                bh[c] = (float)(b >> 8);
            }
        }
        const float wf = (float)w, wm = -8388608.f * wf;  // (2^23 + x) w - 2^23 w = x w, exactly
        float a1[C8], a2[C8], a3[C8];
#pragma unroll
        for (int c = 0; c < C8; ++c) a1[c] = a2[c] = a3[c] = 0.f;
#pragma unroll
        for (int i = 0; i < L16; ++i) {
            const float al = fmaf(magic_byte(u[i >> 1], 2 * (i & 1)), wf, wm);
            const float ah = fmaf(magic_byte(u[i >> 1], 2 * (i & 1) + 1), wf, wm);
#pragma unroll
            for (int c = 0; c < C8; ++c) {
                a1[c] = fmaf(al, bl[c], a1[c]);
                a2[c] = fmaf(al, bh[c], a2[c]);
                a2[c] = fmaf(ah, bl[c], a2[c]);
                a3[c] = fmaf(ah, bh[c], a3[c]);
            }
            float* col = mine + i * SK;  // column i + tm C8: complete here
            col[0] += a1[0];
            col[LANES8] += a2[0];
            col[2 * LANES8] += a3[0];
#pragma unroll
            for (int c = 0; c + 1 < C8; ++c) {
                a1[c] = a1[c + 1];
                a2[c] = a2[c + 1];
                a3[c] = a3[c + 1];
            }
            a1[C8 - 1] = a2[C8 - 1] = a3[C8 - 1] = 0.f;
            if (i % C8 == C8 - 1) __syncwarp();
        }
#pragma unroll
        for (int c = 0; c + 1 < C8; ++c) {  // columns L16 + tm C8 + c
            float* col = mine + (L16 + c) * SK;
            col[0] += a1[c];
            col[LANES8] += a2[c];
            col[2 * LANES8] += a3[c];
        }
        __syncwarp();
    }
    // c[k] = A1[k] + 2^8 A2[k] + A3[k - 1] < 2^32 (v2_bounds), into A1[k]'s slot
    uint32_t* cc = (uint32_t*)A;
#pragma unroll 4
    for (int k = tm * KC; k < (tm + 1) * KC; ++k) {
        const float* col = A + k * SK + l;
        const uint32_t a3 = k ? (uint32_t)A[(k - 1) * SK + 2 * LANES8 + l] : 0u;
        cc[k * SK + l] = (uint32_t)col[0] + ((uint32_t)col[LANES8] << 8) + a3;
    }
    tc_wait();  // every team's columns are combined; the constants have landed
    // The reduction: warp w < WARPS / T8 takes the block's lanes 32 w .. 32 w
    // + 31, one thread a lane (the folds are serial per lane: 32 lanes a warp
    // share them), with warp T8 w's planes, which no other warp reads, as
    // its scratch; the other warps are done.
    if (warp >= WARPS / T8) return;
    const int bl = 32 * warp + lid;
    const uint32_t* cl = (const uint32_t*)(smem + TC_BYTES + (bl / LANES8) * PLANE_BYTES) + bl % LANES8;
    uint32_t c[2 * NL];
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < 2 * NL; ++k) {
        carry += (uint64_t)cl[2 * k * SK] + ((uint64_t)cl[(2 * k + 1) * SK] << 16);
        c[k] = (uint32_t)carry;
        carry >>= 32;
    }
    __syncwarp();
    uint32_t res[NL];
    tc_redc(c, res, smem + TC_BYTES + T8 * warp * PLANE_BYTES, smem, fc.N);
    const int64_t out_lane = (int64_t)blockIdx.x * LPB + bl;
    if (out_lane < B) store_planes(out + (int64_t)g * B, res, (int64_t)G * B, out_lane);
}

static int smem_allowed = 0;

// Plain C entry point (loaded with ctypes); arguments as K7's
// stacked_mul_v3_launch. Returns cudaGetLastError().
extern "C" int stacked_mul_v2_launch(const void* U, const void* V, void* out, const void* table,
                                     long long B, int S, int G, int SU, int SV, const void* consts,
                                     const void* tmats, void* stream) {
    TcConsts fc;
    memcpy(&fc, consts, sizeof fc);
    cudaError_t err = allow_smem(stacked_mul_v2_kernel, SMEM_BYTES, &smem_allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((B + LPB - 1) / LPB), (unsigned)G);
    stacked_mul_v2_kernel<<<grid, BLOCK, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint32_t*)U, (const uint32_t*)V, (uint32_t*)out, (const int*)table, (int64_t)B, S, G,
        SU, SV, (const unsigned char*)tmats, fc);
    return (int)cudaGetLastError();
}

extern "C" int stacked_mul_v2_nl(void) { return NL; }
extern "C" int stacked_mul_v2_tc_bytes(void) { return TC_BYTES; }
