// GLV decomposition + window-digit extraction, two threads per lane.
//
// Replaces the reference's digits kernel (snark_setup_tpu/ops/pallas_glv.py:
// 215 PallasGLVDigits.__call__, kernel body _make_kernel :92). Per lane, for
// a scalar k < r given as LS 16-bit limbs:
//   c_i   = (k * mu_i + 2^(S-1)) >> S            (Barrett rounding, S = 16 (LS + LC))
//   k1    = k - sgn * c_1 |a1| - sgn * c_2 |a2|  (pos/neg sums, then |pos - neg|)
//   k2    =   - sgn * c_1 |b1| - sgn * c_2 |b2|
//   d1,d2 = the 4-bit windows of |k1|, |k2|, most significant first
//   neg   = k1 < 0,  flip = (k1 < 0) != (k2 < 0)
// The exact integer model is GLVOps.decompose_host (ops/glv.py); the plain
// PyTorch version is ops/cuda_glv.py:glv_digits_plain.
//
// Bound on an H100: bytes, and tiny — a lane reads LS words and writes
// 2 nwin + 2 (~0.0024 ms at 16384 lanes on BW6-761), against a few hundred
// 16x16-bit multiply-adds a lane. What held the first form at ~20x that:
// limb arrays sized for any curve with run-time bounds (so in local
// memory), constants read from a device tensor staged through shared memory,
// and one thread per lane in blocks of 128 (4 warps an SM at 16384 lanes,
// each waiting out a serial chain of multiply-adds). Here:
//   - the geometry is compile-time, one library per curve (ops/build.py:
//     TARGETS, -DDIG_LS= ...; the wrapper checks it against the curve's):
//     every loop unrolls and every limb array lives in registers;
//   - the constants reach the kernel by value in its __grid_constant__
//     parameter, zero-padded to DIG_MU / DIG_CO limbs;
//   - a pair of threads shares a lane: thread 0 computes c_1 and then k1
//     with its digits, thread 1 c_2 and then k2, the pair swapping c_1 /
//     c_2 and the signs by shuffles — twice the threads in flight and half
//     the chain (one thread a lane measured 1.3-2.1x slower at 16384 lanes on
//     an H100).
// Products run column by column into a 64-bit accumulator (every column sum
// is below 2^48): no separate carry pass.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#if !defined(DIG_LS) || !defined(DIG_LC) || !defined(DIG_LT) || !defined(DIG_LH) || !defined(DIG_NWIN) || \
    !defined(DIG_MU) || !defined(DIG_CO)
#error "compile with the curve's geometry: -DDIG_LS= -DDIG_LC= -DDIG_LT= -DDIG_LH= -DDIG_NWIN= -DDIG_MU= -DDIG_CO="
#endif
#define DIG_BLOCK 64  // threads a block: 32 lanes
#define DIG_S (DIG_LS + DIG_LC)  // Barrett shift in limbs
static_assert(4 * DIG_LH >= DIG_NWIN && DIG_LH <= DIG_LT, "digits outside the magnitude");

// The per-curve constants (packed by ops/cuda_glv.py: digits_consts).
struct DigitsConsts {
    uint32_t mu[2][DIG_MU];      // Barrett reciprocals of g_1, g_2, 16-bit limbs
    uint32_t coeff[4][DIG_CO];   // |coefficient| limbs of the terms k1: c_1, c_2; k2: c_1, c_2
    uint32_t to_neg[4];          // 1 where the term goes to the negative sum
};

struct DigitsParams {
    const uint32_t* k;  // (LS, B) raw scalar limbs
    uint32_t* d[2];     // (nwin, B) digit planes of |k1|, |k2|
    uint32_t* neg;      // (B,)
    uint32_t* flip;     // (B,)
    long long B;
    DigitsConsts c;
};

// c = (k * mu_m + 2^(S-1)) >> S, LC limbs
__device__ __forceinline__ void barrett(const DigitsConsts& C, int m, const uint32_t (&kk)[DIG_LS],
                                        uint32_t (&c)[DIG_LC]) {
    uint32_t mu[DIG_MU];
#pragma unroll
    for (int i = 0; i < DIG_MU; ++i) mu[i] = C.mu[m][i];
    uint64_t acc = 0;
#pragma unroll
    for (int col = 0; col < DIG_S + DIG_LC; ++col) {
#pragma unroll
        for (int i = 0; i < DIG_LS; ++i) {
            if (col - i >= 0 && col - i < DIG_MU) acc += (uint64_t)kk[i] * mu[col - i];
        }
        if (col == DIG_S - 1) acc += 0x8000u;  // round to nearest
        if (col >= DIG_S) c[col - DIG_S] = (uint32_t)(acc & 0xFFFFu);
        acc >>= 16;
    }
}

// (magnitude limbs, sign) of (o == 0 ? k : 0) + sum_pos - sum_neg over LT
// limbs, for output o (0: k1, 1: k2) from c_1, c_2
__device__ __forceinline__ uint32_t signed_combine(const DigitsConsts& C, int o, const uint32_t (&kk)[DIG_LS],
                                                   const uint32_t (&c1)[DIG_LC], const uint32_t (&c2)[DIG_LC],
                                                   uint32_t (&mag)[DIG_LH]) {
    uint32_t co[2][DIG_CO];
    uint64_t negm[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int i = 0; i < DIG_CO; ++i) co[s][i] = C.coeff[2 * o + s][i];
        negm[s] = C.to_neg[2 * o + s] ? ~0ull : 0ull;
    }
    const uint32_t kmask = o == 0 ? 0xFFFFu : 0u;
    uint32_t P[DIG_LT], N[DIG_LT];
    uint64_t accP = 0, accN = 0;
#pragma unroll
    for (int col = 0; col < DIG_LT; ++col) {
        if (col < DIG_LS) accP += kk[col] & kmask;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            uint64_t v = 0;
#pragma unroll
            for (int i = 0; i < DIG_LC; ++i) {
                if (col - i >= 0 && col - i < DIG_CO) v += (uint64_t)(s ? c2[i] : c1[i]) * co[s][col - i];
            }
            accN += v & negm[s];
            accP += v & ~negm[s];
        }
        P[col] = (uint32_t)(accP & 0xFFFFu);
        accP >>= 16;
        N[col] = (uint32_t)(accN & 0xFFFFu);
        accN >>= 16;
    }
    // P < N ?
    uint32_t lt = 0, decided = 0;
#pragma unroll
    for (int col = DIG_LT - 1; col >= 0; --col) {
        const uint32_t less = P[col] < N[col], more = P[col] > N[col];
        lt |= ~decided & less;
        decided |= less | more;
    }
    int32_t borrow = 0;
#pragma unroll
    for (int col = 0; col < DIG_LH; ++col) {
        const int32_t a = lt ? N[col] : P[col], b = lt ? P[col] : N[col];
        const int32_t d = a - b + borrow;
        mag[col] = (uint32_t)d & 0xFFFFu;
        borrow = d >> 16;  // 0 or -1
    }
    return lt;
}

__global__ void __launch_bounds__(DIG_BLOCK) glv_digits_kernel(const __grid_constant__ DigitsParams p) {
    const long long g = (long long)blockIdx.x * DIG_BLOCK + threadIdx.x;
    const long long lane = g / 2;
    const int t = (int)(g % 2);  // this thread's output: k1 (0) or k2 (1)
    const bool live = lane < p.B;  // lanes past B compute on zeros (the pair's shuffles) and store nothing
    uint32_t kk[DIG_LS];
#pragma unroll
    for (int i = 0; i < DIG_LS; ++i) kk[i] = live ? p.k[(long long)i * p.B + lane] & 0xFFFFu : 0u;

    uint32_t mine[DIG_LC], c1[DIG_LC], c2[DIG_LC], mag[DIG_LH];
    barrett(p.c, t, kk, mine);
#pragma unroll
    for (int i = 0; i < DIG_LC; ++i) {
        const uint32_t other = __shfl_xor_sync(0xFFFFFFFFu, mine[i], 1);
        c1[i] = t ? other : mine[i];
        c2[i] = t ? mine[i] : other;
    }
    const uint32_t n = signed_combine(p.c, t, kk, c1, c2, mag);
    const uint32_t n_other = __shfl_xor_sync(0xFFFFFFFFu, n, 1);
    if (live) {
        uint32_t* d = p.d[t];
#pragma unroll
        for (int r = 0; r < DIG_NWIN; ++r) {
            const int j = DIG_NWIN - 1 - r;  // window index from the least significant end
            d[(long long)r * p.B + lane] = (mag[j >> 2] >> (4 * (j & 3))) & 15u;
        }
        if (t == 0) {
            p.neg[lane] = n;
            p.flip[lane] = n ^ n_other;
        }
    }
}

// Plain C entry point (loaded with ctypes). `k`, `d1`, `d2`, `neg`, `flip`
// are device pointers (contiguous); `consts` is a HOST pointer to a
// DigitsConsts block. Returns cudaGetLastError().
extern "C" int glv_digits_launch(const void* k, void* d1, void* d2, void* neg, void* flip, long long B,
                                 const void* consts, void* stream) {
    DigitsParams p;
    memset(&p, 0, sizeof p);
    p.k = (const uint32_t*)k;
    p.d[0] = (uint32_t*)d1;
    p.d[1] = (uint32_t*)d2;
    p.neg = (uint32_t*)neg;
    p.flip = (uint32_t*)flip;
    p.B = B;
    memcpy(&p.c, consts, sizeof(DigitsConsts));
    const long long threads = 2 * B;
    const unsigned blocks = (unsigned)((threads + DIG_BLOCK - 1) / DIG_BLOCK);
    glv_digits_kernel<<<blocks, DIG_BLOCK, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// [LS, LC, LT, LH, nwin, MU, CO]: the geometry this library was built for
extern "C" void glv_digits_config(long long* out) {
    const long long v[7] = {DIG_LS, DIG_LC, DIG_LT, DIG_LH, DIG_NWIN, DIG_MU, DIG_CO};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
}
