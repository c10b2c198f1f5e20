// Complete projective group law for y^2 = x^3 + b (a = 0) over the field of
// field.cuh, one point per thread: Renes–Costello–Batina, eprint 2015/1060,
// Algorithm 7 (addition) and Algorithm 9 (doubling). Branch-free: doubling,
// mixed cases and the point at infinity (0 : 1 : 0) need no special handling.
//
// 3b is small for every curve in scope (b in {1, -1, 4}), so products by 3b
// are short addition chains: `b3w` = |3b|, `b3neg` = 1 where 3b is negative.
// The formulas and their order are those of the plain PyTorch group law
// (ops/curve.py) and of the reference's fused ladder; since every field
// operation returns the canonical value, the projective X, Y, Z agree with
// them bit for bit.
//
// Outputs may alias inputs: every input is consumed before the first output
// limb is written.
#pragma once
#include "field.cuh"

struct Point {
    fe x, y, z;
};

__device__ __forceinline__ void pset(Point* r, const Point* p) {
    fset(r->x, p->x);
    fset(r->y, p->y);
    fset(r->z, p->z);
}

__device__ __forceinline__ void pinfinity(Point* r) {
    fzero(r->x);
    fone(r->y);
    fzero(r->z);
}

// r = ±w * a : multiply by the small curve constant 3b
__device__ __forceinline__ void mul_b3(uint32_t* r, const uint32_t* a, uint32_t b3w, uint32_t b3neg) {
    small_mul(r, a, b3w);
    if (b3neg) fneg(r, r);  // uniform across the launch: no divergence
}

// Algorithm 7: 12 products + 2 constant chains, 9 reductions (the last six
// products pairwise under one reduction each).
__device__ __noinline__ void gadd(Point* r, const Point* p, const Point* q, uint32_t b3w, uint32_t b3neg) {
    fe t0, t1, t2, t3, t4, t5, u, v;
    fmul(t0, p->x, q->x);
    fmul(t1, p->y, q->y);
    fmul(t2, p->z, q->z);
    fadd(u, p->x, p->y); fadd(v, q->x, q->y); fmul(t3, u, v);
    fadd(u, p->x, p->z); fadd(v, q->x, q->z); fmul(t4, u, v);
    fadd(u, p->y, p->z); fadd(v, q->y, q->z); fmul(t5, u, v);
    fadd(u, t0, t1); fsub(t3, t3, u);  // X1Y2 + X2Y1
    fadd(u, t0, t2); fsub(t4, t4, u);  // X1Z2 + X2Z1
    fadd(u, t1, t2); fsub(t5, t5, u);  // Y1Z2 + Y2Z1
    fe z3, t4b, t1n, x3, z3p, t5n;
    mul_b3(z3, t2, b3w, b3neg);    // 3b Z1Z2
    mul_b3(t4b, t4, b3w, b3neg);   // 3b (X1Z2 + X2Z1)
    fadd(t1n, t0, t0); fadd(t1n, t1n, t0);  // 3 X1X2
    fsub(x3, t1, z3);
    fadd(z3p, t1, z3);
    fneg(t5n, t5);
    fmul2(r->y, x3, z3p, t1n, t4b);
    fmul2(r->x, t3, x3, t5n, t4b);
    fmul2(r->z, t5, z3p, t3, t1n);
}

// Algorithm 9 with c = 3b Z^2 folded into the first round as Z * (|3b| Z):
// 8 products and reductions.
__device__ __noinline__ void gdbl(Point* r, const Point* p, uint32_t b3w, uint32_t b3neg) {
    fe t0, t1, m3, c, wz, z3a, c3, t0p, ysum, x3, y3a, x3b;
    small_mul(wz, p->z, b3w);
    fmul(t0, p->y, p->y);
    fmul(t1, p->y, p->z);
    fmul(m3, p->x, p->y);
    fmul(c, p->z, wz);
    if (b3neg) fneg(c, c);
    fadd(z3a, t0, t0); fadd(z3a, z3a, z3a); fadd(z3a, z3a, z3a);  // 8 Y^2
    fadd(c3, c, c); fadd(c3, c3, c);
    fsub(t0p, t0, c3);
    fadd(ysum, t0, c);
    fmul(x3, c, z3a);
    fmul(y3a, t0p, ysum);
    fmul(x3b, t0p, m3);
    fmul(r->z, t1, z3a);
    fadd(r->x, x3b, x3b);
    fadd(r->y, x3, y3a);
}
