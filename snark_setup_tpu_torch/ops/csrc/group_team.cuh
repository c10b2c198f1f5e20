// The complete projective group law for y^2 = x^3 + b (a = 0) over the
// field of field_team.cuh, one TEAM of threads per point: Renes-Costello-
// Batina, eprint 2015/1060, Algorithm 7 (addition) and Algorithm 9
// (doubling). Branch-free: doubling, mixed cases and the point at infinity
// (0 : 1 : 0) need no special handling.
//
// One header for every kernel that runs the group law on the team layer:
// the group-op kernel (group_ops.cu) and the whole GLV ladder
// (glv_ladder.cu). The formulas and their order are those of the plain
// group law (ops/curve.py); every field operation returns the canonical
// value, so the projective X, Y, Z equal the plain group law's limb for
// limb. 3b is small for every curve in scope (b in {1, -1, 4}), so products
// by 3b are addition chains: `b3w` = |3b|, `b3neg` = 1 where 3b is negative.
//
// Outputs may alias inputs: every input is read before the first output
// word is written.
#pragma once
#include "field_team.cuh"

struct TPoint {
    tfe x, y, z;
};

// 3b * a = ±|3b| * a
__device__ __forceinline__ void team_mul_b3(const Team& tm, tfe& r, const tfe& a, uint32_t b3w, uint32_t b3neg) {
    team_small_mul(tm, r, a, b3w);
    if (b3neg) team_fneg(tm, r, r);  // uniform across the launch
}

// Algorithm 7: 12 products + 2 constant chains, 9 reductions (the last six
// products pairwise under one reduction each), issued in two stages of
// independent products (six, then three pairs) so that their chains overlap.
__device__ __forceinline__ void team_gadd(const Team& tm, TPoint& r, const TPoint& p, const TPoint& q,
                                          uint32_t b3w, uint32_t b3neg) {
    uint32_t a6[6][1][TK], b6[6][1][TK];
    tset(a6[0][0], p.x); tset(b6[0][0], q.x);
    tset(a6[1][0], p.y); tset(b6[1][0], q.y);
    tset(a6[2][0], p.z); tset(b6[2][0], q.z);
    team_fadd(tm, a6[3][0], p.x, p.y); team_fadd(tm, b6[3][0], q.x, q.y);
    team_fadd(tm, a6[4][0], p.x, p.z); team_fadd(tm, b6[4][0], q.x, q.z);
    team_fadd(tm, a6[5][0], p.y, p.z); team_fadd(tm, b6[5][0], q.y, q.z);
    tfe t[6];  // X1X2, Y1Y2, Z1Z2, then the three products of sums
    team_mont<6, 1>(tm, t, a6, b6);
    tfe u;
    team_fadd(tm, u, t[0], t[1]); team_fsub(tm, t[3], t[3], u);  // X1Y2 + X2Y1
    team_fadd(tm, u, t[0], t[2]); team_fsub(tm, t[4], t[4], u);  // X1Z2 + X2Z1
    team_fadd(tm, u, t[1], t[2]); team_fsub(tm, t[5], t[5], u);  // Y1Z2 + Y2Z1
    tfe z3, t4b, t1n, x3, z3p, t5n;
    team_mul_b3(tm, z3, t[2], b3w, b3neg);   // 3b Z1Z2
    team_mul_b3(tm, t4b, t[4], b3w, b3neg);  // 3b (X1Z2 + X2Z1)
    team_fadd(tm, t1n, t[0], t[0]); team_fadd(tm, t1n, t1n, t[0]);  // 3 X1X2
    team_fsub(tm, x3, t[1], z3);
    team_fadd(tm, z3p, t[1], z3);
    team_fneg(tm, t5n, t[5]);
    uint32_t a3[3][2][TK], b3[3][2][TK];
    tset(a3[0][0], x3);   tset(b3[0][0], z3p); tset(a3[0][1], t1n);  tset(b3[0][1], t4b);  // Y3
    tset(a3[1][0], t[3]); tset(b3[1][0], x3);  tset(a3[1][1], t5n);  tset(b3[1][1], t4b);  // X3
    tset(a3[2][0], t[5]); tset(b3[2][0], z3p); tset(a3[2][1], t[3]); tset(b3[2][1], t1n);  // Z3
    tfe o[3];
    team_mont<3, 2>(tm, o, a3, b3);
    tset(r.y, o[0]);
    tset(r.x, o[1]);
    tset(r.z, o[2]);
}

// Algorithm 9 with c = 3b Z^2 folded into the first round as Z * (|3b| Z):
// 8 products and reductions, in two stages of four independent products.
__device__ __forceinline__ void team_gdbl(const Team& tm, TPoint& r, const TPoint& p, uint32_t b3w,
                                          uint32_t b3neg) {
    tfe wz;
    team_small_mul(tm, wz, p.z, b3w);
    uint32_t a4[4][1][TK], b4[4][1][TK];
    tset(a4[0][0], p.y); tset(b4[0][0], p.y);
    tset(a4[1][0], p.y); tset(b4[1][0], p.z);
    tset(a4[2][0], p.x); tset(b4[2][0], p.y);
    tset(a4[3][0], p.z); tset(b4[3][0], wz);
    tfe t[4];  // Y^2, YZ, XY, c = 3b Z^2 (its sign below)
    team_mont<4, 1>(tm, t, a4, b4);
    if (b3neg) team_fneg(tm, t[3], t[3]);  // uniform across the launch
    tfe z3a, c3, t0p, ysum;
    team_fadd(tm, z3a, t[0], t[0]); team_fadd(tm, z3a, z3a, z3a); team_fadd(tm, z3a, z3a, z3a);  // 8 Y^2
    team_fadd(tm, c3, t[3], t[3]); team_fadd(tm, c3, c3, t[3]);
    team_fsub(tm, t0p, t[0], c3);
    team_fadd(tm, ysum, t[0], t[3]);
    tset(a4[0][0], t[3]); tset(b4[0][0], z3a);   // c * 8Y^2
    tset(a4[1][0], t0p);  tset(b4[1][0], ysum);
    tset(a4[2][0], t0p);  tset(b4[2][0], t[2]);
    tset(a4[3][0], t[1]); tset(b4[3][0], z3a);   // Z3
    tfe o[4];
    team_mont<4, 1>(tm, o, a4, b4);
    team_fadd(tm, r.x, o[2], o[2]);
    team_fadd(tm, r.y, o[0], o[1]);
    tset(r.z, o[3]);
}
