// GLV decomposition + window-digit extraction, one thread per lane.
//
// Replaces the reference's digits kernel (snark_setup_tpu/ops/pallas_glv.py,
// PallasGLVDigits / _make_kernel). Per lane, for a scalar k < r given as Ls
// 16-bit limbs:
//   c_i   = (k * mu_i + 2^(S-1)) >> S            (Barrett rounding, S = 16 S_limbs)
//   k1    = k - sgn * c_1 |a1| - sgn * c_2 |a2|  (pos/neg sums, then |pos - neg|)
//   k2    =   - sgn * c_1 |b1| - sgn * c_2 |b2|
//   d1,d2 = the 4-bit windows of |k1|, |k2|, most significant first
//   neg   = k1 < 0,  flip = (k1 < 0) != (k2 < 0)
// The exact integer model is GLVOps.decompose_host (ops/glv.py); the plain
// PyTorch version is ops/cuda_glv.py:glv_digits_plain.
//
// Bound on an H100: about even between bytes and integer operations, and
// tiny either way — a lane reads Ls words, writes 2 nwin + 2, and does
// ~2 Ls |mu| + 4 Lc |coeff| 16x16-bit multiply-adds (a few thousand). The
// design is therefore the simplest right one: products run column by column
// into a 64-bit accumulator (no separate carry pass), the limb arrays sit in
// per-thread local memory with run-time bounds so one binary serves every
// curve, and the per-curve constants arrive as one small device tensor staged
// through shared memory. The tensor's layout (32-bit words):
//   [0] Ls [1] S_limbs [2] Lc [3] LT [4] Lh [5] nwin [6] |mu_1| [7] |mu_2|
//   [8 + 2t], [9 + 2t] for term t (k1: c_1,c_2; k2: c_1,c_2): side, length
//        side 0 = absent, 1 = adds to the negative sum, 2 = to the positive
//   [16 + 64 m ...] mu_m limbs, m < 2;  [144 + 64 t ...] term t limbs, t < 4
#include <cuda_runtime.h>
#include <cstdint>

#define MAXL 64
#define NCONST 400
#define BLOCK 128

// (magnitude limbs, sign) of  (with_k ? k : 0) + sum_pos - sum_neg  over LT limbs
__device__ void signed_combine(const uint32_t* C, int tbase, bool with_k, const uint32_t* kk,
                               const uint32_t (*c)[MAXL], uint32_t* mag, uint32_t* negative) {
    const int Ls = C[0], Lc = C[2], LT = C[3];
    uint32_t P[MAXL], N[MAXL];
    uint64_t accP = 0, accN = 0;
    for (int col = 0; col < LT; ++col) {
        if (with_k && col < Ls) accP += kk[col];
        for (int t = 0; t < 2; ++t) {
            const uint32_t side = C[8 + 2 * (tbase + t)];
            const int n = C[9 + 2 * (tbase + t)];
            if (side == 0) continue;
            const uint32_t* coeff = C + 144 + 64 * (tbase + t);
            const int lo = col >= n ? col - n + 1 : 0;
            const int hi = col < Lc - 1 ? col : Lc - 1;
            uint64_t s = 0;
            for (int i = lo; i <= hi; ++i) s += (uint64_t)c[t][i] * coeff[col - i];
            if (side == 1) accN += s; else accP += s;
        }
        P[col] = (uint32_t)(accP & 0xFFFFu); accP >>= 16;
        N[col] = (uint32_t)(accN & 0xFFFFu); accN >>= 16;
    }
    // P < N ?
    uint32_t lt = 0, decided = 0;
    for (int col = LT - 1; col >= 0; --col) {
        const uint32_t less = P[col] < N[col], more = P[col] > N[col];
        lt |= (~decided & 1u) & less;
        decided |= less | more;
    }
    int32_t borrow = 0;
    for (int col = 0; col < LT; ++col) {
        const int32_t a = lt ? N[col] : P[col], b = lt ? P[col] : N[col];
        const int32_t d = a - b + borrow;
        mag[col] = (uint32_t)d & 0xFFFFu;
        borrow = d >> 16;  // 0 or -1
    }
    *negative = lt;
}

__global__ void __launch_bounds__(BLOCK)
glv_digits_kernel(const uint32_t* __restrict__ k, const uint32_t* __restrict__ consts,
                  uint32_t* __restrict__ d1, uint32_t* __restrict__ d2,
                  uint32_t* __restrict__ neg, uint32_t* __restrict__ flip, int64_t B) {
    __shared__ uint32_t C[NCONST];
    for (int i = threadIdx.x; i < NCONST; i += blockDim.x) C[i] = consts[i];
    __syncthreads();
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;

    const int Ls = C[0], S_limbs = C[1], Lc = C[2], nwin = C[5];
    uint32_t kk[MAXL];
    for (int i = 0; i < Ls; ++i) kk[i] = k[(int64_t)i * B + lane] & 0xFFFFu;

    uint32_t c[2][MAXL];
    for (int m = 0; m < 2; ++m) {
        const uint32_t* mu = C + 16 + 64 * m;
        const int nmu = C[6 + m];
        uint64_t acc = 0;
        for (int col = 0; col < S_limbs + Lc; ++col) {
            const int lo = col >= nmu ? col - nmu + 1 : 0;
            const int hi = col < Ls - 1 ? col : Ls - 1;
            for (int i = lo; i <= hi; ++i) acc += (uint64_t)kk[i] * mu[col - i];
            if (col == S_limbs - 1) acc += 0x8000u;  // round to nearest
            if (col >= S_limbs) c[m][col - S_limbs] = (uint32_t)(acc & 0xFFFFu);
            acc >>= 16;
        }
    }

    uint32_t m1[MAXL], m2[MAXL], n1, n2;
    signed_combine(C, 0, true, kk, c, m1, &n1);
    signed_combine(C, 2, false, kk, c, m2, &n2);

    for (int r = 0; r < nwin; ++r) {
        const int j = nwin - 1 - r;  // window index from the least significant end
        const int limb = j >> 2, sh = 4 * (j & 3);
        d1[(int64_t)r * B + lane] = (m1[limb] >> sh) & 15u;
        d2[(int64_t)r * B + lane] = (m2[limb] >> sh) & 15u;
    }
    neg[lane] = n1;
    flip[lane] = n1 ^ n2;
}

// Plain C entry point (loaded with ctypes). All pointers are device pointers.
// Returns cudaGetLastError().
extern "C" int glv_digits_launch(const void* k, const void* consts, void* d1, void* d2, void* neg,
                                 void* flip, long long B, void* stream) {
    const unsigned blocks = (unsigned)((B + BLOCK - 1) / BLOCK);
    glv_digits_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)k, (const uint32_t*)consts, (uint32_t*)d1, (uint32_t*)d2,
        (uint32_t*)neg, (uint32_t*)flip, (int64_t)B);
    return (int)cudaGetLastError();
}
