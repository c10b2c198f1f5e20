// Whole GLV windowed ladder, one TEAM of threads of one warp per lane (= per
// scalar multiplication), on the cooperative Montgomery layer
// (field_team.cuh) and the team group law (group_team.cuh) that the
// group-op kernel shares.
//
// Replaces the reference's fused-ladder kernel (snark_setup_tpu/ops/
// pallas_ladder.py:385 FusedGLVLadder.__call__, kernel body
// _make_ladder_kernel :247): that kernel tiles the batch over a sequential
// grid and keeps a tile's table and accumulator in on-chip vector memory;
// here every lane is independent, a team owns one lane for the whole ladder
// and the grid's sequential window loop is a loop inside the team.
//
// Per lane (the schedule of ops/cuda_ladder.py:glv_ladder_plain):
//   base      = (-1)^neg * P
//   T[j]      = j * base, j < 16        (1 doubling + 13 additions)
//   Tx2[j]    = beta * T[j].x           (endomorphism table: phi(x,y) = (beta x, y))
//   acc       = O
//   per window k, most significant first:
//       acc = 16 acc                    (4 doublings)
//       acc += T[d1[k]]
//       acc += (Tx2[d2[k]], ±T[d2[k]].y, T[d2[k]].z)   (y negated where flip)
// Every field operation is canonical, so X, Y, Z equal the plain version's
// limb for limb.
//
// Bound on an H100: 32-bit integer multiply-adds. A lane moves 6 L + 2 nwin
// + 2 words and does ~60 field products a window, each 2 NL^2 wide
// multiply-adds. What held the first form (one thread per lane, field.cuh)
// far above that bound, and what this design does about it:
//   1. Threads in flight: one thread per lane gave 4 warps an SM at 16384
//      lanes, each waiting out every dependent multiply-add of its chain.
//      A team multiplies the threads by TEAM, divides a product's serial
//      chain by about TEAM, and the group law issues its independent
//      products together (team_mont<NP, NR>; the beta table four at a time).
//   2. Local memory: field elements were by-pointer arguments of
//      out-of-line calls. Here an element is TK registers a thread and
//      every field and group function is inlined.
//   3. The table: 64 elements of NL words a lane (6 KB at NL 24). Thread t
//      of a team holds its slice, words t TK .. t TK + TK - 1 of every
//      entry, in per-thread local memory (the hardware interleaves it per
//      thread, so a warp's accesses to one word coalesce; it stays in L1 /
//      L2: 768 bytes a thread). The digits are the contributor's secret, so
//      a lookup scans all 16 entries of the thread's slice and keeps one by
//      mask: no address, local or global, depends on a digit. The same
//      slices in shared memory ([entry][coordinate][word][thread], 24 KB a
//      block of 32 threads, 9 warps an SM) measured 1.3x slower at 16384
//      lanes and 1.5x at 65536 on an H100, equal at 1-17 lanes. The kernel
//      is bound by its instruction stream at ~8 warps an SM (more warps,
//      from fewer registers or a smaller table, did not help), so its time
//      follows the number of waves of 8 warps.
//   4. Constants: copied to constant memory before every launch. Here N,
//      R mod N, n0 and beta reach the kernel by value in its
//      __grid_constant__ parameter.
#include <cuda_runtime.h>
#include <cstring>
#include "group_team.cuh"

#define LADDER_BLOCK 32  // one warp a block
#define LPB (LADDER_BLOCK / TEAM)  // lanes a block
#define TABLE 16
#define TCOORDS 4  // x, y, z, beta x of every entry

struct LadderParams {
    const uint32_t* in[3];  // P.x, P.y, P.z: (L, B) 16-bit limb planes
    const uint32_t* d1;     // (nwin, B) digits of |k1|, most significant window first
    const uint32_t* d2;     // (nwin, B) digits of |k2|
    const uint32_t* neg;    // (B,) k1 < 0
    const uint32_t* flip;   // (B,) sign(k1) != sign(k2)
    uint32_t* out[3];       // (L, B) planes of X, Y, Z
    long long B;
    int nwin;
    uint32_t b3w, b3neg;
    uint32_t beta[NL];      // cube root of unity in Fq, Montgomery form
    TeamConsts fc;
};

typedef uint32_t Table[TABLE][TCOORDS][TK];  // the thread's slices of the 16-entry table

__device__ __forceinline__ void tab_put(Table& tab, int j, int c, const tfe& a) {
#pragma unroll
    for (int m = 0; m < TK; ++m) tab[j][c][m] = a[m];
}

__device__ __forceinline__ void tab_put_point(Table& tab, int j, const TPoint& a) {
    tab_put(tab, j, 0, a.x);
    tab_put(tab, j, 1, a.y);
    tab_put(tab, j, 2, a.z);
}

// r = (coordinate cx, y, z) of entry e: every entry is read and one kept by
// mask, so no address depends on the secret digit e
__device__ __forceinline__ void tab_select(Table& tab, TPoint& r, uint32_t e, int cx) {
    tzero(r.x);
    tzero(r.y);
    tzero(r.z);
#pragma unroll
    for (int j = 0; j < TABLE; ++j) {
        const uint32_t k = 0u - (uint32_t)((uint32_t)j == e);
#pragma unroll
        for (int m = 0; m < TK; ++m) {
            r.x[m] |= tab[j][cx][m] & k;
            r.y[m] |= tab[j][1][m] & k;
            r.z[m] |= tab[j][2][m] & k;
        }
    }
}

// Stage the block's lanes of P into box[coordinate][lane][word] (two 16-bit
// limbs a word): a warp loads consecutive lanes of one plane.
__device__ __forceinline__ void ladder_stage_in(const LadderParams& p, uint32_t (*box)[LPB][NL + 1],
                                                long long lane0) {
    const int l = threadIdx.x % LPB, j0 = threadIdx.x / LPB;  // LADDER_BLOCK / LPB == TEAM word rows a pass
    const long long b = lane0 + l;
    const bool live = b < p.B;
#pragma unroll
    for (int o = 0; o < 3; ++o) {
#pragma unroll
        for (int s = 0; s < TK; ++s) {
            const int j = j0 + TEAM * s;
            uint32_t w = 0;
            if (live) {
                const uint32_t lo = p.in[o][(long long)(2 * j) * p.B + b];
                const uint32_t hi = p.in[o][(long long)(2 * j + 1) * p.B + b];
                w = (lo & 0xFFFFu) | (hi << 16);
            }
            box[o][l][j] = w;
        }
    }
}

__device__ __forceinline__ void ladder_stage_out(const LadderParams& p, uint32_t (*box)[LPB][NL + 1],
                                                 long long lane0) {
    const int l = threadIdx.x % LPB, j0 = threadIdx.x / LPB;
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

__global__ void __launch_bounds__(LADDER_BLOCK)
glv_ladder_kernel(const __grid_constant__ LadderParams p) {
    __shared__ uint32_t box[3][LPB][NL + 1];
    const Team tm = team_init(p.fc);
    const int team = threadIdx.x / TEAM;
    const long long lane0 = (long long)blockIdx.x * LPB, lane = lane0 + team;
    const bool live = lane < p.B;  // lanes past B compute on zeros and are not stored

    ladder_stage_in(p, box, lane0);
    __syncthreads();
    TPoint base;
    team_from_box(tm, base.x, box[0], team);
    team_from_box(tm, base.y, box[1], team);
    team_from_box(tm, base.z, box[2], team);

    // neg from the team's thread 0, flip from its thread 1: one load and
    // one shuffle each
    const uint32_t* sp = (tm.t & 1u) ? p.flip : p.neg;
    const uint32_t sw = (live && tm.t < 2) ? sp[lane] & 1u : 0u;
    const bool negb = __shfl_sync(FULL_MASK, sw, 0, TEAM) != 0;
    const bool flip = __shfl_sync(FULL_MASK, sw, 1, TEAM) != 0;
    tfe t, zero, one, beta;
    team_fneg(tm, t, base.y);
    tselect(base.y, negb, t, base.y);
    tzero(zero);
#pragma unroll
    for (int m = 0; m < TK; ++m) {
        one[m] = p.fc.one[tm.t * TK + m];
        beta[m] = p.beta[tm.t * TK + m];
    }

    // T[0] = O = (0 : 1 : 0), T[1] = base, T[2] = 2 base, T[j] = T[j-1] + base
    Table tab;
    tab_put(tab, 0, 0, zero);
    tab_put(tab, 0, 1, one);
    tab_put(tab, 0, 2, zero);
    tab_put_point(tab, 1, base);
    TPoint cur;
    team_gdbl(tm, cur, base, p.b3w, p.b3neg);
    tab_put_point(tab, 2, cur);
#pragma unroll 1
    for (int j = 3; j < TABLE; ++j) {
        team_gadd(tm, cur, cur, base, p.b3w, p.b3neg);
        tab_put_point(tab, j, cur);
    }
    // Tx2[j] = beta * T[j].x, four products under one round loop
#pragma unroll 1
    for (int j0 = 0; j0 < TABLE; j0 += 4) {
        uint32_t a4[4][1][TK], b4[4][1][TK];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int m = 0; m < TK; ++m) a4[i][0][m] = tab[j0 + i][0][m];
            tset(b4[i][0], beta);
        }
        tfe o[4];
        team_mont<4, 1>(tm, o, a4, b4);
#pragma unroll
        for (int i = 0; i < 4; ++i) tab_put(tab, j0 + i, 3, o[i]);
    }

    TPoint acc, sel;
    tzero(acc.x);
    tset(acc.y, one);
    tzero(acc.z);
    uint32_t w1 = 0, w2 = 0;  // this thread's digits of window k0 + t (k0 = k rounded down to TEAM)
#pragma unroll 1
    for (int k = 0; k < p.nwin; ++k) {
        const int kt = k & (TEAM - 1);
        if (kt == 0) {  // the same on every thread: each loads one window's digits
            const int kk = k + (int)tm.t;
            const bool have = live && kk < p.nwin;
            w1 = have ? p.d1[(long long)kk * p.B + lane] : 0u;
            w2 = have ? p.d2[(long long)kk * p.B + lane] : 0u;
        }
        const uint32_t e1 = __shfl_sync(FULL_MASK, w1, kt, TEAM);
        const uint32_t e2 = __shfl_sync(FULL_MASK, w2, kt, TEAM);
#pragma unroll 1
        for (int i = 0; i < 4; ++i) team_gdbl(tm, acc, acc, p.b3w, p.b3neg);
        // the two additions share one copy of the group law
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
            tab_select(tab, sel, h ? e2 : e1, h ? 3 : 0);
            team_fneg(tm, t, sel.y);
            tselect(sel.y, h && flip, t, sel.y);
            team_gadd(tm, acc, acc, sel, p.b3w, p.b3neg);
        }
    }

    __syncthreads();  // every team has read its input from the box
    team_to_box(tm, box[0], team, acc.x);
    team_to_box(tm, box[1], team, acc.y);
    team_to_box(tm, box[2], team, acc.z);
    __syncthreads();
    ladder_stage_out(p, box, lane0);
}

// Plain C entry point (loaded with ctypes). The point planes and outputs are
// contiguous (L, B), the digit planes (nwin, B), neg / flip (B,), all device
// pointers; `consts` is a HOST pointer to NL words of beta (Montgomery form)
// followed by a TeamConsts block. Returns cudaGetLastError() (a launch the
// card refuses, for its registers or shared memory, returns an error).
extern "C" int glv_ladder_launch(const void* px, const void* py, const void* pz, const void* d1,
                                 const void* d2, const void* neg, const void* flip, void* ox,
                                 void* oy, void* oz, long long B, int nwin, unsigned b3w,
                                 unsigned b3neg, const void* consts, void* stream) {
    LadderParams p;
    memset(&p, 0, sizeof p);
    p.in[0] = (const uint32_t*)px;
    p.in[1] = (const uint32_t*)py;
    p.in[2] = (const uint32_t*)pz;
    p.d1 = (const uint32_t*)d1;
    p.d2 = (const uint32_t*)d2;
    p.neg = (const uint32_t*)neg;
    p.flip = (const uint32_t*)flip;
    p.out[0] = (uint32_t*)ox;
    p.out[1] = (uint32_t*)oy;
    p.out[2] = (uint32_t*)oz;
    p.B = B;
    p.nwin = nwin;
    p.b3w = b3w;
    p.b3neg = b3neg;
    memcpy(p.beta, consts, sizeof p.beta);
    memcpy(&p.fc, (const uint32_t*)consts + NL, sizeof(TeamConsts));
    const unsigned blocks = (unsigned)((B + LPB - 1) / LPB);
    glv_ladder_kernel<<<blocks, LADDER_BLOCK, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

extern "C" int glv_ladder_nl(void) { return NL; }

extern "C" int glv_ladder_team(void) { return TEAM; }
