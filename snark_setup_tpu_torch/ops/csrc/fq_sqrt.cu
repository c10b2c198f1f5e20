// The decompression square root over Fq, the whole chain in one launch, one
// TEAM of threads of one warp per lane on the cooperative Montgomery layer
// (field_team.cuh). A second entry point, fq_pow_launch, runs the same power
// chain alone for an exponent passed by value: with p - 2 it is the
// inversion at the root of every batch inversion (see the end of the file).
//
// Replaces the Fq products of the square root's chains, which ran as one
// launch of the stacked-product kernel each (snark_setup_tpu/ops/
// pallas_field.py:498 PallasFieldMul.__call__ at S = G = 1, 1103
// launches a batch on BW6-761). The function is the reference's
// ExtSqrt.sqrt on a degree-1 field (snark_setup_tpu/ops/codec_jax.py),
// which ops/cuda_sqrt.py: fq_sqrt_plain repeats in plain PyTorch:
//
//   e == 1 (q = 3 mod 4):  r = a^((q + 1) / 4)
//   e  > 1:                branch-free Tonelli-Shanks with q - 1 = 2^e s,
//       w = a^((s - 1) / 2), r = a w, t = r w, c = z^s
//       for i = e .. 2:  b = t^(2^(i - 2));  flip = b != 1
//                        r = flip ? r c : r;  c = c^2;  t = flip ? t c : t
//   ok = (r^2 == a) | (a == 0)
//
// Every product is canonical, so root and mask equal the plain version's bit
// for bit. The exponent is binary, most significant bit first, a squaring
// per bit and a product by `a` per set bit, as ops/codec.py: ext_pow_const.
// The exponent's bits, its length, e and c reach the kernel by value in
// its __grid_constant__ parameter beside the layer's TeamConsts: nothing is
// copied to constant memory before the launch. Every loop bound and every
// branch reads only that parameter, so control flow is the same on every
// thread of the launch and the team's shuffles and ballots always meet; the
// per-lane choices are selects.
//
// Bound on an H100: 32-bit integer multiply-adds. A lane reads and writes
// L words and runs 1103 (BW6-761) / 1589 (BLS12-377) dependent products
// of 2 NL^2 multiply-adds; one team product is NL rounds of two TK-word
// mad.lo / mad.hi chains a thread and three shuffles. At 16384 lanes the
// launch is 16384 TEAM threads (31 warps an SM at NL 24), enough to keep
// the multiply-add pipe busy; at one lane it is latency: the chain's
// products in a row.
#include <cuda_runtime.h>
#include <cstring>
#include "field_team.cuh"

#define SQRT_BLOCK 128
#define SPB (SQRT_BLOCK / TEAM)  // lanes a block

struct SqrtParams {
    const uint32_t* in;  // (L, B) 16-bit limb planes, Montgomery form, canonical
    uint32_t* root;      // (L, B) planes of the root
    uint32_t* ok;        // (B,) 1 where a is a square (or 0)
    long long B;
    int nbits;           // bit length of the exponent (>= 1)
    int e;               // 2-adicity of q - 1
    uint32_t exp[NL];    // (q + 1) / 4 where e == 1, else (s - 1) / 2
    uint32_t c[NL];      // z^s, Montgomery form (read where e > 1)
    TeamConsts fc;       // N, R mod N, n0
};

// r = a b / R mod N (canonical; a, b canonical)
__device__ __forceinline__ void tmul(const Team& tm, tfe& r, const tfe& a, const tfe& b) {
    uint32_t x[1][1][TK], y[1][1][TK];
    tfe out[1];
    tset(x[0][0], a);
    tset(y[0][0], b);
    team_mont<1, 1>(tm, out, x, y);
    tset(r, out[0]);
}

// r = a^exp for a public exponent of nbits >= 1 bits, most significant bit
// first: a squaring per bit and a product by `a` per set bit
// (ops/codec.py: ext_pow_const). `exp` points into the launch's by-value
// parameter, so every thread reads the same bits.
__device__ __forceinline__ void tpow(const Team& tm, tfe& r, const tfe& a, const uint32_t* exp, int nbits) {
    tset(r, a);
#pragma unroll 1
    for (int k = nbits - 2; k >= 0; --k) {
        tmul(tm, r, r, r);
        if ((exp[k >> 5] >> (k & 31)) & 1u) tmul(tm, r, r, a);
    }
}

// lane b's element from (L, B) 16-bit planes into the team's registers (0
// where the lane is past B)
__device__ __forceinline__ void load_lane(const Team& tm, tfe& a, const uint32_t* in, long long B, long long b,
                                          bool live) {
#pragma unroll
    for (int m = 0; m < TK; ++m) {
        const int j = tm.t * TK + m;
        uint32_t w = 0;
        if (live) {
            const uint32_t lo = in[(long long)(2 * j) * B + b];
            const uint32_t hi = in[(long long)(2 * j + 1) * B + b];
            w = (lo & 0xFFFFu) | (hi << 16);
        }
        a[m] = w;
    }
}

__device__ __forceinline__ void store_lane(const Team& tm, uint32_t* out, long long B, long long b, const tfe& r) {
#pragma unroll
    for (int m = 0; m < TK; ++m) {
        const int j = tm.t * TK + m;
        out[(long long)(2 * j) * B + b] = r[m] & 0xFFFFu;
        out[(long long)(2 * j + 1) * B + b] = r[m] >> 16;
    }
}

// a == b over the team (the same answer on every thread of it)
__device__ __forceinline__ bool team_eq(const Team& tm, const tfe& a, const tfe& b) {
    uint32_t d = 0;
#pragma unroll
    for (int m = 0; m < TK; ++m) d |= a[m] ^ b[m];
    return !team_any(tm, d != 0);
}

__global__ void __launch_bounds__(SQRT_BLOCK) fq_sqrt_kernel(const __grid_constant__ SqrtParams p) {
    const Team tm = team_init(p.fc);
    const long long b = (long long)blockIdx.x * SPB + threadIdx.x / TEAM;
    const bool live = b < p.B;  // lanes past B compute on 0 and store nothing
    tfe a, one, zero;
    load_lane(tm, a, p.in, p.B, b, live);
#pragma unroll
    for (int m = 0; m < TK; ++m) {
        one[m] = p.fc.one[tm.t * TK + m];
        zero[m] = 0;
    }
    tfe acc;
    tpow(tm, acc, a, p.exp, p.nbits);
    tfe r;
    if (p.e == 1) {
        tset(r, acc);
    } else {
        tfe t, c;
        tmul(tm, r, a, acc);
        tmul(tm, t, r, acc);
#pragma unroll
        for (int m = 0; m < TK; ++m) c[m] = p.c[tm.t * TK + m];
#pragma unroll 1
        for (int i = p.e; i > 1; --i) {
            tfe sq;
            tset(sq, t);
#pragma unroll 1
            for (int k = 0; k < i - 2; ++k) tmul(tm, sq, sq, sq);
            const bool flip = !team_eq(tm, sq, one);
            // r c and c^2 are independent: one round loop for both
            uint32_t x[2][1][TK], y[2][1][TK];
            tfe out[2];
            tset(x[0][0], r);
            tset(y[0][0], c);
            tset(x[1][0], c);
            tset(y[1][0], c);
            team_mont<2, 1>(tm, out, x, y);
            tselect(r, flip, out[0], r);
            tset(c, out[1]);
            tfe tc;
            tmul(tm, tc, t, c);
            tselect(t, flip, tc, t);
        }
    }
    tfe rr;
    tmul(tm, rr, r, r);
    // both ballots on every thread (no short circuit)
    const bool squares = team_eq(tm, rr, a);
    const bool is_zero = team_eq(tm, a, zero);
    const bool ok = squares | is_zero;
    if (!live) return;  // after the last collective
    store_lane(tm, p.root, p.B, b, r);
    if (tm.t == 0) p.ok[b] = ok ? 1u : 0u;
}

// Plain C entry point (loaded with ctypes). `in`, `root` are contiguous
// (L, B) int32 planes and `ok` a (B,) int32 tensor on the card; `params` is
// a HOST pointer to the words ops/cuda_sqrt.py: sqrt_params packs: nbits,
// e, the exponent (NL words), c (NL words), then TeamConsts (N, R mod N,
// n0). Returns cudaGetLastError().
extern "C" int fq_sqrt_launch(const void* in, void* root, void* ok, long long B, const void* params,
                              void* stream) {
    SqrtParams p;
    memset(&p, 0, sizeof p);
    const uint32_t* w = (const uint32_t*)params;
    p.in = (const uint32_t*)in;
    p.root = (uint32_t*)root;
    p.ok = (uint32_t*)ok;
    p.B = B;
    p.nbits = (int)w[0];
    p.e = (int)w[1];
    memcpy(p.exp, w + 2, sizeof p.exp);
    memcpy(p.c, w + 2 + NL, sizeof p.c);
    memcpy(&p.fc, w + 2 + 2 * NL, sizeof(TeamConsts));
    const unsigned blocks = (unsigned)((B + SPB - 1) / SPB);
    fq_sqrt_kernel<<<blocks, SQRT_BLOCK, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

extern "C" int fq_sqrt_nl(void) { return NL; }

extern "C" int fq_sqrt_team(void) { return TEAM; }

// ---------------------------------------------------------------------------
// a^exp for a public exponent, Montgomery form in and out, one team a lane.
//
// With exp = p - 2 this is the Fermat inversion a^-1 (and 0 for 0) that
// ops/fp.py: FpOps.inv launches for the root of the product tree of every
// batch inversion (projective normalization before each write-back, the
// norm of an Fp2 / Fp3 inversion). It replaces the JAX package's Fermat
// chain of single products there (snark_setup_tpu/ops/pallas_field.py:498
// PallasFieldMul.__call__ at S = G = 1); ops/cuda_sqrt.py: fq_pow_plain
// repeats it in plain PyTorch. The callers pass one to a few lanes, so a
// launch is one block whose first team or teams are live: its time is the
// chain's ~1.5 nbits dependent products, latency and not throughput. The
// rest of the block runs the same chain on 0 and stores nothing, so every
// shuffle of the chain meets all 32 threads of the warp.
struct PowParams {
    const uint32_t* in;  // (L, B) 16-bit limb planes, Montgomery form, canonical
    uint32_t* out;       // (L, B) planes of a^exp
    long long B;
    int nbits;           // bit length of the exponent (>= 1)
    uint32_t exp[NL];
    TeamConsts fc;       // N, R mod N, n0
};

__global__ void __launch_bounds__(SQRT_BLOCK) fq_pow_kernel(const __grid_constant__ PowParams p) {
    const Team tm = team_init(p.fc);
    const long long b = (long long)blockIdx.x * SPB + threadIdx.x / TEAM;
    const bool live = b < p.B;
    tfe a, r;
    load_lane(tm, a, p.in, p.B, b, live);
    tpow(tm, r, a, p.exp, p.nbits);
    if (!live) return;  // after the last collective
    store_lane(tm, p.out, p.B, b, r);
}

// `in`, `out`: contiguous (L, B) int32 planes on the card; `params`: a HOST
// pointer to the words ops/cuda_sqrt.py: pow_params packs: nbits, the
// exponent (NL words), then TeamConsts. Returns cudaGetLastError().
extern "C" int fq_pow_launch(const void* in, void* out, long long B, const void* params, void* stream) {
    PowParams p;
    memset(&p, 0, sizeof p);
    const uint32_t* w = (const uint32_t*)params;
    p.in = (const uint32_t*)in;
    p.out = (uint32_t*)out;
    p.B = B;
    p.nbits = (int)w[0];
    memcpy(p.exp, w + 1, sizeof p.exp);
    memcpy(&p.fc, w + 1 + NL, sizeof(TeamConsts));
    const unsigned blocks = (unsigned)((B + SPB - 1) / SPB);
    fq_pow_kernel<<<blocks, SQRT_BLOCK, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
