// One complete group operation per lane: doubling (RCB Alg. 9) or addition
// (RCB Alg. 7) on y^2 = x^3 + b over the field of field_team.cuh, one TEAM
// of threads per lane, one launch per batch operation.
//
// Replaces the reference's fused group-op kernels (snark_setup_tpu/ops/
// pallas_group.py, PallasGroupOps.double / .add): those tile the batch over a
// sequential grid and keep a tile's field glue in on-chip vector memory; here
// every lane is independent and a team of threads of one warp owns it, each
// thread holding TK = NL / TEAM limbs of every coordinate in registers. The
// group law is group_team.cuh's, which the whole-ladder kernel shares: the
// formulas and their order of the plain group law (ops/curve.py), every
// field operation canonical, so the projective X, Y, Z equal the plain group
// law's limb for limb.
//
// Operands are the package's (L, *batch) 16-bit-limb int32 planes, read in
// place through a per-operand lane layout (Operand): limb plane l of lane b
// sits at ptr[l * ps + (b / inner) * s1 + (b % inner) * s2]. That takes
// contiguous batches, a batch-1 operand (s1 = s2 = 0: the Pippenger window
// combine, sum_reduce's odd tail), broadcasts (a zero stride) and the
// strided views sum_reduce and the Pippenger lane merge pass (even / odd
// lanes, the halves of the bucket rows) without a copy. A block of BLOCK
// threads serves LT = BLOCK / TEAM lanes: it stages its lanes' operands
// through shared memory (a warp loads consecutive lanes of one plane, and
// two 16-bit limbs pack into one 32-bit limb), every team reads its slices
// from there, and the results leave the same way, as (L, B) planes.
//
// Bound on an H100: integer multiply-adds at 16384 lanes, and below a few
// thousand lanes latency — one lane's chain of dependent products. A product
// is NL rounds of two TK-word multiply-add chains per thread and three
// shuffles; the team cuts one lane's serial chain by about TEAM against one
// thread per lane and fills the card with TEAM times the threads, and the
// independent products of each step share one round loop (two stages per
// double or add instead of 8 or 9 products in a row).
#include <cuda_runtime.h>
#include <cstring>
#include "group_team.cuh"

#define BLOCK 128
#define LT (BLOCK / TEAM)

struct Operand {
    const uint32_t* ptr;
    long long ps, inner, s1, s2;  // plane stride; lane b at (b / inner) * s1 + (b % inner) * s2
};

struct GroupParams {
    Operand in[6];  // p.x, p.y, p.z (, q.x, q.y, q.z)
    uint32_t* out[3];
    long long B;
    uint32_t b3w, b3neg;
    TeamConsts fc;
};

// Stage the first NIN operands of the block's LT lanes into box[o][lane][word].
template <int NIN>
__device__ __forceinline__ void stage_in(const GroupParams& p, uint32_t (*box)[LT][NL + 1], long long lane0) {
    const int l = threadIdx.x % LT, j0 = threadIdx.x / LT;  // BLOCK / LT == TEAM word rows per pass
    const long long b = lane0 + l;
    const bool live = b < p.B;
#pragma unroll
    for (int o = 0; o < NIN; ++o) {
        const Operand& op = p.in[o];
        long long off = 0;
        if (live) {  // lanes and inner sizes are below 2^31 (the wrapper checks): 32-bit division
            const unsigned ub = (unsigned)b, ui = (unsigned)op.inner;
            off = (long long)(ub / ui) * op.s1 + (long long)(ub % ui) * op.s2;
        }
#pragma unroll
        for (int s = 0; s < TK; ++s) {
            const int j = j0 + TEAM * s;
            uint32_t w = 0;
            if (live) {
                const uint32_t lo = op.ptr[(long long)(2 * j) * op.ps + off];
                const uint32_t hi = op.ptr[(long long)(2 * j + 1) * op.ps + off];
                w = (lo & 0xFFFFu) | (hi << 16);
            }
            box[o][l][j] = w;
        }
    }
}

__device__ __forceinline__ void stage_out(const GroupParams& p, uint32_t (*box)[LT][NL + 1], long long lane0) {
    const int l = threadIdx.x % LT, j0 = threadIdx.x / LT;
    const long long b = lane0 + l;
    if (b >= p.B) return;  // after the last barrier: no collective follows
#pragma unroll
    for (int o = 0; o < 3; ++o) {
#pragma unroll
        for (int s = 0; s < TK; ++s) {
            const int j = j0 + TEAM * s;
            const uint32_t w = box[o][l][j];
            p.out[o][(long long)(2 * j) * p.B + b] = w & 0xFFFFu;
            p.out[o][(long long)(2 * j + 1) * p.B + b] = w >> 16;
        }
    }
}

template <bool ADD>
__global__ void __launch_bounds__(BLOCK) group_kernel(const __grid_constant__ GroupParams p) {
    __shared__ uint32_t box[ADD ? 6 : 3][LT][NL + 1];
    const Team tm = team_init(p.fc);
    const long long lane0 = (long long)blockIdx.x * LT;
    stage_in<ADD ? 6 : 3>(p, box, lane0);
    __syncthreads();
    // lanes past B compute on zeros (every thread takes part in the
    // team's shuffles) and are not stored
    const int team = threadIdx.x / TEAM;
    TPoint a, r;
    team_from_box(tm, a.x, box[0], team);
    team_from_box(tm, a.y, box[1], team);
    team_from_box(tm, a.z, box[2], team);
    if (ADD) {
        TPoint b;
        team_from_box(tm, b.x, box[3], team);
        team_from_box(tm, b.y, box[4], team);
        team_from_box(tm, b.z, box[5], team);
        team_gadd(tm, r, a, b, p.b3w, p.b3neg);
    } else {
        team_gdbl(tm, r, a, p.b3w, p.b3neg);
    }
    __syncthreads();
    team_to_box(tm, box[0], team, r.x);
    team_to_box(tm, box[1], team, r.y);
    team_to_box(tm, box[2], team, r.z);
    __syncthreads();
    stage_out(p, box, lane0);
}

// Plain C entry points (loaded with ctypes). `operands` holds five int64
// per input (pointer, ps, inner, s1, s2: p.x, p.y, p.z, then q.x, q.y, q.z
// for the addition); `ox`, `oy`, `oz` are contiguous (L, B) planes; `consts`
// is a HOST pointer to a TeamConsts block. Each returns cudaGetLastError().
static int launch(bool add, const long long* operands, void* ox, void* oy, void* oz, long long B,
                  unsigned b3w, unsigned b3neg, const void* consts, void* stream) {
    GroupParams p;
    memset(&p, 0, sizeof p);
    for (int o = 0; o < (add ? 6 : 3); ++o) {
        const long long* d = operands + 5 * o;
        p.in[o].ptr = (const uint32_t*)(uintptr_t)d[0];
        p.in[o].ps = d[1];
        p.in[o].inner = d[2];
        p.in[o].s1 = d[3];
        p.in[o].s2 = d[4];
    }
    p.out[0] = (uint32_t*)ox;
    p.out[1] = (uint32_t*)oy;
    p.out[2] = (uint32_t*)oz;
    p.B = B;
    p.b3w = b3w;
    p.b3neg = b3neg;
    memcpy(&p.fc, consts, sizeof(TeamConsts));
    const unsigned blocks = (unsigned)((B + LT - 1) / LT);
    cudaStream_t s = (cudaStream_t)stream;
    if (add)
        group_kernel<true><<<blocks, BLOCK, 0, s>>>(p);
    else
        group_kernel<false><<<blocks, BLOCK, 0, s>>>(p);
    return (int)cudaGetLastError();
}

extern "C" int group_dbl_launch(const long long* operands, void* ox, void* oy, void* oz, long long B,
                                unsigned b3w, unsigned b3neg, const void* consts, void* stream) {
    return launch(false, operands, ox, oy, oz, B, b3w, b3neg, consts, stream);
}

extern "C" int group_add_launch(const long long* operands, void* ox, void* oy, void* oz, long long B,
                                unsigned b3w, unsigned b3neg, const void* consts, void* stream) {
    return launch(true, operands, ox, oy, oz, B, b3w, b3neg, consts, stream);
}

extern "C" int group_ops_nl(void) { return NL; }
extern "C" int group_ops_team(void) { return TEAM; }
