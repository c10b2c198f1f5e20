// Stacked weighted Montgomery products, one thread per (lane, output group).
//
// Replaces the reference's stacked-product kernel (snark_setup_tpu/ops/
// pallas_field.py:498, PallasFieldMul.__call__ / _make_kernel :420). It
// computes the same function:
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
// Per thread: an exact (2 NL + 1)-word accumulator of the weighted sum, then
// one Montgomery reduction and one conditional subtraction. The host wrapper
// (ops/cuda_mul.py) checks max_g sum_r W[g, r] * N < R and 2 N < R: then the
// reduced value is below 2 N and one subtraction makes it canonical.
//
// Bound on an H100: the IMAD pipe. Per lane and output group the kernel
// moves 2 NL words per non-zero weight in and NL words out; its
// multiply-adds are 32x32 -> 64-bit IMAD.WIDE, which issue at 0.32x IMAD's
// rate (scripts/imad_rate.py), well above the bytes' time. The first form
// ran per non-zero weight the weighted operand w u (NL multiply-adds) and NL
// rows of NL + 1 into the accumulator, each row's carry rippled through
// every word above it, then the reduction's NL rows of NL, rippled the same
// way (its text stays as K7's accumulation, stacked_acc.cuh); its
// constants were copied to constant memory before every launch. This form:
//   - u v by one Karatsuba level: three independent half products of
//     (NL / 2)^2 multiply-adds (3/4 of the schoolbook's, and three chains
//     where there was one), the middle one on the half sums with their carry
//     bits folded in by masked additions;
//   - the weight applied to the product: a weight of 1 (most rows of the
//     towers) adds it, any other multiplies it in (2 NL multiply-adds);
//   - the reduction's rows leave their carry pending in a word owed at the
//     next row's top, not rippled up the accumulator;
//   - N and n0 by value in the __grid_constant__ parameter (K5Consts):
//     nothing is copied to constant memory before the launch.
// It holds 112 / 203 registers at NL 12 / 24 (the first form 94 / 168) and
// measured 1.17x faster than the first form, launch-weighted over the main
// paths' shapes (PERF.md, scripts/compare_kernels.py).
// Weights and row maps are a small int32 table in device memory that every
// thread of a block reads at the same address (one output group a block
// row), so every branch on a weight is uniform across the block.
#include <cuda_runtime.h>
#include <cstring>

#include "stacked_routes.cuh"

#define BLOCK 128
#define ACC (2 * NL + 1)
#define H (NL / 2)
static_assert(NL % 2 == 0, "Karatsuba splits NL in halves");

// N and n0 = -N^{-1} mod 2^32, packed by ops/cuda_mul.py: StackedMul
struct K5Consts {
    uint32_t N[NL];
    uint32_t n0;
};

// X[0 .. 2 H) = a * b for H-word a, b: every row's last carry lands in a
// word no row has written yet, so nothing ripples
__device__ __forceinline__ void half_product(uint32_t* X, const uint32_t* a, const uint32_t* b) {
#pragma unroll
    for (int k = 0; k < 2 * H; ++k) X[k] = 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < H; ++j) {
            c += (uint64_t)a[j] * b[i] + X[i + j];
            X[i + j] = (uint32_t)c;
            c >>= 32;
        }
        X[i + H] = (uint32_t)c;
    }
}

// T[0 .. 2 NL) = u * v by one Karatsuba level:
//   u v = P0 + (M - P0 - P2) X + P2 X^2,  X = 2^(32 H),
//   P0 = u_lo v_lo, P2 = u_hi v_hi, M = (u_lo + u_hi)(v_lo + v_hi)
__device__ __forceinline__ void kara_product(uint32_t* T, const uint32_t* u, const uint32_t* v) {
    // half sums: H words and a carry bit each
    uint32_t su[H], sv[H];
    uint64_t cu = 0, cv = 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
        cu += (uint64_t)u[j] + u[H + j];
        su[j] = (uint32_t)cu;
        cu >>= 32;
        cv += (uint64_t)v[j] + v[H + j];
        sv[j] = (uint32_t)cv;
        cv >>= 32;
    }
    // M = su sv + cu sv X + cv su X + cu cv X^2 (NL + 1 words)
    uint32_t M[NL + 1];
    half_product(M, su, sv);
    const uint32_t mu = 0u - (uint32_t)cu, mv = 0u - (uint32_t)cv;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
        c += (uint64_t)M[H + j] + (sv[j] & mu) + (su[j] & mv);
        M[H + j] = (uint32_t)c;
        c >>= 32;
    }
    M[NL] = (uint32_t)c + ((uint32_t)cu & (uint32_t)cv);
    half_product(T, u, v);           // P0 in T[0 .. NL)
    half_product(T + NL, u + H, v + H);  // P2 in T[NL .. 2 NL)
    // D = M - P0 - P2 >= 0 (it is u_lo v_hi + u_hi v_lo), in place of M
    int64_t d = 0;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
        d += (int64_t)M[k] - (int64_t)T[k] - (int64_t)T[NL + k];
        M[k] = (uint32_t)d;
        d >>= 32;  // arithmetic: a borrow stays negative
    }
    M[NL] = (uint32_t)((int64_t)M[NL] + d);
    // T += D X (the product is below 2^(64 NL): nothing leaves T)
    c = 0;
#pragma unroll
    for (int k = 0; k <= NL; ++k) {
        c += (uint64_t)T[H + k] + M[k];
        T[H + k] = (uint32_t)c;
        c >>= 32;
    }
#pragma unroll
    for (int k = H + NL + 1; k < 2 * NL; ++k) {
        c += T[k];
        T[k] = (uint32_t)c;
        c >>= 32;
    }
}

// acc += w * u * v
__device__ __forceinline__ void mac_weighted(uint32_t* acc, const uint32_t* u, const uint32_t* v,
                                             uint32_t w) {
    uint32_t T[2 * NL];
    kara_product(T, u, v);
    uint64_t c = 0;
    if (w == 1) {  // uniform: one weight row a block
#pragma unroll
        for (int k = 0; k < 2 * NL; ++k) {
            c += (uint64_t)acc[k] + T[k];
            acc[k] = (uint32_t)c;
            c >>= 32;
        }
    } else {
#pragma unroll
        for (int k = 0; k < 2 * NL; ++k) {
            c += (uint64_t)T[k] * w + acc[k];
            acc[k] = (uint32_t)c;
            c >>= 32;
        }
    }
    acc[2 * NL] += (uint32_t)c;
}

// acc = acc * R^{-1} (exact), result in acc[NL .. 2 NL]. Row i's carry and
// the carry pending from row i - 1 both land at weight i + NL; what that sum
// carries out (0 .. 2) is pending at i + NL + 1, where row i + 1's carry
// lands: no row ripples up the accumulator.
__device__ __forceinline__ void redc_wide(uint32_t* acc, const K5Consts& fc) {
    uint32_t pending = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
        const uint32_t m = acc[i] * fc.n0;
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < NL; ++j) {
            c += (uint64_t)m * fc.N[j] + acc[i + j];
            acc[i + j] = (uint32_t)c;
            c >>= 32;
        }
        c += (uint64_t)acc[i + NL] + pending;
        acc[i + NL] = (uint32_t)c;
        pending = (uint32_t)(c >> 32);
    }
    acc[2 * NL] += pending;
}

// table: W (G * S) | urow (S) | vrow (S) | uneg (S), int32
__global__ void __launch_bounds__(BLOCK)
stacked_mul_kernel(const uint32_t* __restrict__ U, const uint32_t* __restrict__ V,
                   uint32_t* __restrict__ out, const int* __restrict__ table, int64_t B, int S,
                   int G, int SU, int SV, const __grid_constant__ K5Consts fc) {
    const int64_t lane = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
    const int g = blockIdx.y;
    if (lane >= B) return;  // ragged edge: the last block is partly idle
    const StackRows t = stack_rows(table, g, S, G);

    uint32_t acc[ACC];
#pragma unroll
    for (int k = 0; k < ACC; ++k) acc[k] = 0;
#pragma unroll 1
    for (int r = 0; r < S; ++r) {
        const uint32_t w = (uint32_t)t.W[r];
        if (w == 0) continue;
        uint32_t u[NL], v[NL];
        // limb l of row s sits at (l * SU + s) * B + lane: plane stride SU * B
        load_planes(u, U + (int64_t)t.urow[r] * B, (int64_t)SU * B, lane);
        load_planes(v, V + (int64_t)t.vrow[r] * B, (int64_t)SV * B, lane);
        cond_neg_n(u, (uint32_t)t.uneg[r], fc.N);
        mac_weighted(acc, u, v, w);
    }
    redc_wide(acc, fc);
    uint32_t res[NL];
    cond_sub_n(res, acc + NL, fc.N);  // acc[2 NL] == 0: the value is < 2 N < R
    store_planes(out + (int64_t)g * B, res, (int64_t)G * B, lane);
}

// Plain C entry point (loaded with ctypes). `consts` is a HOST pointer to the
// K5Consts words (N, then n0), passed to the kernel by value; `table` is a
// device pointer (layout above). Returns cudaGetLastError().
extern "C" int stacked_mul_launch(const void* U, const void* V, void* out, const void* table,
                                  long long B, int S, int G, int SU, int SV, const void* consts,
                                  void* stream) {
    K5Consts fc;
    memcpy(&fc, consts, sizeof fc);
    const dim3 grid((unsigned)((B + BLOCK - 1) / BLOCK), (unsigned)G);
    stacked_mul_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)U, (const uint32_t*)V, (uint32_t*)out, (const int*)table, (int64_t)B, S, G, SU,
        SV, fc);
    return (int)cudaGetLastError();
}

extern "C" int stacked_mul_nl(void) { return NL; }
