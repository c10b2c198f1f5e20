// Stacked weighted product columns, not reduced (kernel K6).
//
// Replaces the reference's columns-only kernel (snark_setup_tpu/ops/
// pallas_field.py:636, PallasFieldMul.cols / _make_cols_kernel :441). It
// computes the same function:
//
//     out[k, g, lane] = sum_r W[g, r] cols16(u_r * v_r)[k],  k < 2 L16,
//
// the reference's column form (pallas_field.py: _school_cols_accum): over
// the 16-bit limbs a of u_r and b of v_r,
//
//     col[k] = sum_{i+j=k} lo16(a_j b_i) + sum_{i+j=k-1} hi16(a_j b_i),
//
// with u_r and v_r read through K5's row maps (u_r negated mod N where
// uneg[r]). U, V are (L16, SU|SV, B) planes of 16-bit limbs in 32-bit words;
// out is (2 L16, G, B) 32-bit words, the reference's uint32 columns (the
// host wrappers check 2 L16 2^16 max_g sum W < 2^32, so no column wraps).
// The caller reduces them with the matrix-product Toeplitz reduction
// (ops/fp.py: FpOps.redc_cols_matmul), which reads the words as unsigned.
//
// Two multiply-adds a 16x16 limb product. With p = a b < 2^32,
//
//     S_p[k] = sum_{i+j=k} a_j b_i mod 2^32          (mad.lo)
//     S_h[k] = sum_{i+j=k} hi32((a_j << 16) b_i)     (mad.hi: = hi16(a_j b_i))
//     col[k] = S_p[k] - 2^16 S_h[k] + S_h[k-1]  mod 2^32,
//
// exact because the sum of the lo16 parts is below L16 2^16 < 2^32. The
// identity is linear, so each thread folds the part of a pair's columns
// that its own products give, and the team's parts add up, mod 2^32, to
// the pair's columns; the weighted sum over the pairs is below 2^32, so
// the words that come out are exact.
//
// Layout: a team of T6 = L16 / C6 threads of one warp per lane (4 at NL 24,
// 2 at NL 12), thread tm holding limbs [C6 tm, C6 tm + C6) of v_r and all
// of u_r (NL packed words, negated by every thread of the team at once:
// one pass of the warp) in registers. Step j of a pair takes limb j of u_r
// and that limb shifted up 16 bits from one word (a mask or a shift each)
// and does 2 C6 multiply-adds into a window of C6 running S_p and S_h sums,
// columns j + C6 tm .. j + C6 tm + C6 - 1. Column j + C6 tm is then
// complete for this thread: it is combined and folded, weighted, into the
// thread's L16 + C6 column sums, which stay in registers across the
// stacked pairs. Operands are read once a pair, the limbs of v_r split over
// the team and both coalesced across lanes; the warp reads 32 weights at a
// time and walks only the non-zero ones (a ballot). After the last pair
// the team adds its overlapping column sums into the warp's column planes
// in shared memory in T6 + 1 rounds (in round s thread tm adds its columns
// C6 (tm + s) .. + C6 - 1: disjoint across the team, conflict-free at the
// stride SK6) and each thread writes 2 C6 columns of its lane.
//
// Bound on an H100: bytes at the BLS12-377 shapes, multiply-adds at the MNT
// ones. Per lane and output group the kernel reads 2 L16 words per non-zero
// weight and writes 2 L16 words. Its own floor is L16^2 products per
// non-zero weight, each a mad.lo (IMAD, 16.75e12 /s) and a mad.hi
// (IMAD.HI, which runs at 0.40x IMAD's rate: scripts/imad_rate.py); the
// folds add 2-3 multiply-adds per column of a thread's window, L16 + C6 a
// pair, ~10 % at NL 24. Registers, spills and times are in PERF.md.
#include <cstring>

#include "stacked_routes.cuh"

extern __shared__ __align__(16) unsigned char smem[];

constexpr int C6 = 12;                 // limbs of v_r a thread holds
constexpr int WARPS6 = 4;
constexpr int T6 = L16 / C6;           // threads a lane
constexpr int LANES6 = 32 / T6;        // lanes a warp
constexpr int BLOCK6 = 32 * WARPS6;
constexpr int LPB6 = WARPS6 * LANES6;  // lanes a block
constexpr int NACC = L16 + C6;         // a thread's column sums

static_assert(T6 * C6 == L16 && 32 % T6 == 0, "the team's v limbs must cover the element in one warp");

// Words between two columns of a warp's planes (column k of lane l at
// k SK6 + l): the smallest stride from LANES6 up at which the T6 threads of
// a team, adding to columns C6 apart, hit T6 disjoint runs of LANES6 banks
// (C6 SK6 mod 32 an odd multiple of LANES6).
constexpr int plane_stride6() {
    if (T6 == 1) return 32;
    int sk = LANES6;
    while ((C6 * sk) % 32 % LANES6 != 0 || (C6 * sk) % 32 / LANES6 % 2 != 1) ++sk;
    return sk;
}
constexpr int SK6 = plane_stride6();
constexpr int PLANE_WORDS = 2 * L16 * SK6;
constexpr int SMEM_BYTES = WARPS6 * PLANE_WORDS * 4;

// acc += w cols(u v) over this thread's limbs of v (the thread's part of
// the pair's columns, C6 tm .. C6 tm + NACC - 1), u row `urow` of U
// negated where `uneg`, v row `vrow` of V.
__device__ __forceinline__ void add_pair(uint32_t (&acc)[NACC], const uint32_t* __restrict__ U,
                                         const uint32_t* __restrict__ V, int urow, int vrow, uint32_t uneg,
                                         uint32_t w, int64_t B, int SU, int SV, int64_t lane, int tm,
                                         bool valid, const uint32_t* N) {
    uint32_t u[NL], b[C6];
#pragma unroll
    for (int j = 0; j < NL; ++j) u[j] = 0;
#pragma unroll
    for (int c = 0; c < C6; ++c) b[c] = 0;
    if (valid) {
        load_planes(u, U + (int64_t)urow * B, (int64_t)SU * B, lane);
        cond_neg_n(u, uneg, N);
        const uint32_t* vp = V + ((int64_t)tm * C6 * SV + vrow) * B + lane;
#pragma unroll
        for (int c = 0; c < C6; ++c) b[c] = vp[(int64_t)c * SV * B];
    }
    uint32_t sp[C6], sh[C6], hprev = 0;  // the window: columns j + C6 tm + c
#pragma unroll
    for (int c = 0; c < C6; ++c) sp[c] = sh[c] = 0;
#pragma unroll
    for (int j = 0; j < L16; ++j) {
        const uint32_t x = u[j >> 1];
        const uint32_t a = (j & 1) ? x >> 16 : x & 0xFFFFu;
        const uint32_t ah = (j & 1) ? x & 0xFFFF0000u : x << 16;  // a << 16
#pragma unroll
        for (int c = 0; c < C6; ++c) {
            sp[c] += a * b[c];            // mad.lo
            sh[c] += __umulhi(ah, b[c]);  // mad.hi
        }
        acc[j] += w * (sp[0] - (sh[0] << 16) + hprev);  // column j + C6 tm is complete
        hprev = sh[0];
#pragma unroll
        for (int c = 0; c + 1 < C6; ++c) {
            sp[c] = sp[c + 1];
            sh[c] = sh[c + 1];
        }
        sp[C6 - 1] = sh[C6 - 1] = 0;
    }
#pragma unroll
    for (int c = 0; c + 1 < C6; ++c) {  // columns L16 + C6 tm + c
        acc[L16 + c] += w * (sp[c] - (sh[c] << 16) + hprev);
        hprev = sh[c];
    }
    acc[NACC - 1] += w * hprev;
}

__global__ void __launch_bounds__(BLOCK6)
stacked_cols_kernel(const uint32_t* __restrict__ U, const uint32_t* __restrict__ V,
                    uint32_t* __restrict__ out, const int* __restrict__ table, int64_t B, int S, int G,
                    int SU, int SV, const __grid_constant__ TcConsts fc) {
    const int lid = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int l = lid % LANES6, tm = lid / LANES6;  // lane of the warp, thread of the team
    const int64_t lane = (int64_t)blockIdx.x * LPB6 + warp * LANES6 + l;
    const bool valid = lane < B;  // lanes past B sum zeros: every thread takes part
    const int g = blockIdx.y;
    const StackRows t = stack_rows(table, g, S, G);
    uint32_t acc[NACC];  // columns C6 tm .. C6 tm + NACC - 1 of this thread's products
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0;
    // The weights 32 at a time: lane k reads row r0 + k's (one coalesced
    // load), a ballot marks the non-zero ones and the warp walks only
    // those: no dependent load per zero weight.
#pragma unroll 1
    for (int r0 = 0; r0 < S; r0 += 32) {
        const uint32_t wl = r0 + lid < S ? (uint32_t)t.W[r0 + lid] : 0u;
#pragma unroll 1
        for (uint32_t live = __ballot_sync(0xFFFFFFFFu, wl != 0); live; live &= live - 1) {
            const int k = __ffs(live) - 1, r = r0 + k;
            add_pair(acc, U, V, t.urow[r], t.vrow[r], (uint32_t)t.uneg[r], __shfl_sync(0xFFFFFFFFu, wl, k), B,
                     SU, SV, lane, tm, valid, fc.N);
        }
    }
    uint32_t* P = (uint32_t*)smem + warp * PLANE_WORDS + l;  // column k of this lane at P[k SK6]
#pragma unroll
    for (int k = 0; k < 2 * C6; ++k) P[(2 * C6 * tm + k) * SK6] = 0;
    __syncwarp();
#pragma unroll
    for (int s = 0; s <= T6; ++s) {
#pragma unroll
        for (int c = 0; c < C6; ++c) P[(C6 * (tm + s) + c) * SK6] += acc[C6 * s + c];
        __syncwarp();
    }
    if (!valid) return;
#pragma unroll
    for (int k = 2 * C6 * tm; k < 2 * C6 * tm + 2 * C6; ++k) out[((int64_t)k * G + g) * B + lane] = P[k * SK6];
}

static int smem_allowed = 0;

// Plain C entry point (loaded with ctypes); arguments as K5's
// stacked_mul_launch except `consts`, a HOST pointer to the TcConsts words
// (passed by value: no constant-memory copy before the launch), and `out`,
// a 32-bit device buffer. Returns cudaGetLastError().
extern "C" int stacked_cols_launch(const void* U, const void* V, void* out, const void* table,
                                   long long B, int S, int G, int SU, int SV, const void* consts,
                                   void* stream) {
    TcConsts fc;
    memcpy(&fc, consts, sizeof fc);
    cudaError_t err = allow_smem(stacked_cols_kernel, SMEM_BYTES, &smem_allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((B + LPB6 - 1) / LPB6), (unsigned)G);
    stacked_cols_kernel<<<grid, BLOCK6, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint32_t*)U, (const uint32_t*)V, (uint32_t*)out, (const int*)table, (int64_t)B, S, G, SU,
        SV, fc);
    return (int)cudaGetLastError();
}

extern "C" int stacked_cols_nl(void) { return NL; }
