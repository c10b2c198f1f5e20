// Montgomery arithmetic on one prime field, one element per TEAM of threads.
//
// A team of TEAM threads of one warp owns one element of NL 32-bit limbs:
// thread t of the team holds limbs t*TK .. t*TK + TK - 1 (TK = NL / TEAM)
// in registers, little-endian, in Montgomery form with R = 2^(32 NL) — the
// R of the package's 16-bit-limb planes, so values are interchangeable with
// field.cuh's and with the plain PyTorch field layer (ops/fp.py). Every
// field operation returns the canonical representative < N.
//
// Why teams: with one thread per element (field.cuh) an element lives in
// local memory, a product is one thread's serial chain of 2 NL^2 dependent
// multiply-adds, and a launch of B lanes has only B threads. Here a product
// is NL rounds of TK-word chains on every thread of the team: the team
// multiplies the threads in flight by TEAM, divides one element's serial
// chain by about TEAM and keeps an element in TK registers a thread.
//
// Products are interleaved Montgomery products (CIOS), distributed:
//   - round i broadcasts operand word b_i from its owner (__shfl_sync);
//   - every thread adds a_slice * b_i into its window slice A with a 64-bit
//     multiply-add chain, then q * N_slice, where q = A_0 * n0 is taken from
//     thread 0 (one shuffle: word 0 never waits for a carry from below);
//   - the window moves down one word: thread t takes thread t+1's bottom
//     word (a shuffle) into its top word. What a thread's chains
//     carry out of its slice lands at that same weight, so it is added
//     there; the overflow of that sum (a few units) stays with the thread as
//     the pending carry word C, owed to the next thread and added in the
//     next round's top word.
// After the last round the pending carries are handed up once (a
// shuffle) and the 0 / 1 carries that leaves are resolved in one
// step by a carry-lookahead over two ballots (team_lookahead). The same
// lookahead resolves the carries and borrows of additions, subtractions,
// negation and the conditional subtraction of N. tests/test_torch_team_
// model.py models every step of this file in Python and checks it against
// Python integers, bound by bound.
//
// Every function is inlined and takes its operands as register arrays of TK
// words: nothing here goes through local memory. All control flow is uniform
// across the warp (branch-free selects; the only branches are on values the
// same for every thread of the launch or of the block), so the full-mask
// shuffles and ballots are always met by all 32 threads. Nothing branches on
// the thread's index in the team: the shuffles' source lanes wrap around the
// team onto words known to be 0 instead.
//
// The modulus constants reach a kernel as a by-value __grid_constant__
// parameter (TeamConsts), packed by the host wrapper: no per-launch copy to
// constant memory.
#pragma once
#include <cstdint>

#ifndef NL
#error "compile with -DNL=<number of 32-bit limbs>"
#endif
#ifndef TEAM
#if NL == 12
#define TEAM 4
#else
#define TEAM 8
#endif
#endif
#define TK (NL / TEAM)
static_assert(NL % TEAM == 0 && (TEAM & (TEAM - 1)) == 0 && TEAM >= 2 && TEAM <= 16,
              "TEAM must be a power of two in [2, 16] dividing NL");

#define FULL_MASK 0xFFFFFFFFu
static_assert(TK >= 2, "a thread holds at least two limbs");

// 32-bit add / multiply-add with the carry flag (PTX .cc / c-prefixed
// forms): a multi-word chain is one instruction a word. The flag lives
// between consecutive volatile statements of one chain.
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

// N, R mod N, n0 = -N^{-1} mod 2^32 (packed by ops/cuda_group.py: team_consts)
struct TeamConsts {
    uint32_t N[NL];
    uint32_t one[NL];
    uint32_t n0;
};

typedef uint32_t tfe[TK];  // this thread's slice of one element

struct Team {
    uint32_t t;     // index within the team
    uint32_t base;  // the team's first lane in the warp
    uint32_t n[TK];  // this thread's slice of N
    uint32_t n0;
};

__device__ __forceinline__ Team team_init(const TeamConsts& fc) {
    Team tm;
    const uint32_t lane = threadIdx.x & 31u;
    tm.t = lane & (TEAM - 1);
    tm.base = lane & ~(uint32_t)(TEAM - 1);
#pragma unroll
    for (int m = 0; m < TK; ++m) {
        tm.n[m] = fc.N[tm.t * TK + m];
    }
    tm.n0 = fc.n0;
    return tm;
}

// Carry (or borrow) into this thread's slice from the slices below it, from
// g (a carry leaves this slice) and p (an incoming carry passes through
// it), which never both hold. `top` receives the carry out of the whole
// team (the same on every thread of the team).
__device__ __forceinline__ uint32_t team_lookahead(const Team& tm, bool g, bool p, uint32_t& top) {
    const uint32_t mask = (1u << TEAM) - 1u;
    const uint32_t G = (__ballot_sync(FULL_MASK, g) >> tm.base) & mask;
    const uint32_t P = (__ballot_sync(FULL_MASK, p) >> tm.base) & mask;
    const uint32_t c = ((G << 1) + P) ^ P;
    top = (c >> TEAM) & 1u;
    return (c >> tm.t) & 1u;
}

__device__ __forceinline__ bool team_any(const Team& tm, bool pred) {
    return ((__ballot_sync(FULL_MASK, pred) >> tm.base) & ((1u << TEAM) - 1u)) != 0;
}

// s += w (w < 2^32); returns the carry out of the slice (0 or 1)
__device__ __forceinline__ uint32_t slice_add_word(tfe& s, uint32_t w) {
    s[0] = add_cc(s[0], w);
#pragma unroll
    for (int m = 1; m < TK; ++m) s[m] = addc_cc(s[m], 0);
    return addc(0, 0);
}

// s -= w (w is 0 or 1)
__device__ __forceinline__ void slice_sub_bit(tfe& s, uint32_t w) {
    s[0] = sub_cc(s[0], w);
#pragma unroll
    for (int m = 1; m < TK - 1; ++m) s[m] = subc_cc(s[m], 0);
    s[TK - 1] = subc(s[TK - 1], 0);
}

// A += a * b over one slice: the low halves of the products in one carry
// chain, the high halves one word up in a second; returns the word carried
// out of the slice (below 2^32: A + a b < 2^(32 TK) 2^32)
__device__ __forceinline__ uint32_t slice_mac(tfe& A, const tfe& a, uint32_t b) {
    A[0] = mad_lo_cc(a[0], b, A[0]);
#pragma unroll
    for (int m = 1; m < TK; ++m) A[m] = madc_lo_cc(a[m], b, A[m]);
    uint32_t x = addc(0, 0);
    A[1] = mad_hi_cc(a[0], b, A[1]);
#pragma unroll
    for (int m = 1; m < TK - 1; ++m) A[m + 1] = madc_hi_cc(a[m], b, A[m + 1]);
    return madc_hi(a[TK - 1], b, x);
}

__device__ __forceinline__ bool slice_all_ones(const tfe& s) {
    uint32_t x = 0xFFFFFFFFu;
#pragma unroll
    for (int m = 0; m < TK; ++m) x &= s[m];
    return x == 0xFFFFFFFFu;
}

__device__ __forceinline__ bool slice_zero(const tfe& s) {
    uint32_t x = 0;
#pragma unroll
    for (int m = 0; m < TK; ++m) x |= s[m];
    return x == 0;
}

__device__ __forceinline__ void tset(tfe& r, const tfe& a) {
#pragma unroll
    for (int m = 0; m < TK; ++m) r[m] = a[m];
}

__device__ __forceinline__ void tzero(tfe& r) {
#pragma unroll
    for (int m = 0; m < TK; ++m) r[m] = 0;
}

// r = sel ? a : b (sel the same on every thread of the team)
__device__ __forceinline__ void tselect(tfe& r, bool sel, const tfe& a, const tfe& b) {
    const uint32_t k = sel ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int m = 0; m < TK; ++m) r[m] = (a[m] & k) | (b[m] & ~k);
}

// r = a + b over the team (exact); returns the carry out of the team
__device__ __forceinline__ uint32_t team_add_raw(const Team& tm, tfe& r, const tfe& a, const tfe& b) {
    r[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int m = 1; m < TK; ++m) r[m] = addc_cc(a[m], b[m]);
    const uint32_t c = addc(0, 0);
    uint32_t top;
    slice_add_word(r, team_lookahead(tm, c != 0, slice_all_ones(r), top));
    return top;
}

// r = a - b over the team (mod R); returns the borrow out of the team
__device__ __forceinline__ uint32_t team_sub_raw(const Team& tm, tfe& r, const tfe& a, const tfe& b) {
    r[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int m = 1; m < TK; ++m) r[m] = subc_cc(a[m], b[m]);
    const uint32_t c = subc(0, 0);  // all ones on a borrow
    uint32_t top;
    slice_sub_bit(r, team_lookahead(tm, c != 0, slice_zero(r), top));
    return top;
}

// r = a - N if a >= N else a   (a < 2N)
__device__ __forceinline__ void team_cond_sub_n(const Team& tm, tfe& r, const tfe& a) {
    tfe d;
    const uint32_t borrow = team_sub_raw(tm, d, a, tm.n);
    tselect(r, borrow != 0, a, d);
}

// r = a + b mod N   (a + b < 2N < R)
__device__ __forceinline__ void team_fadd(const Team& tm, tfe& r, const tfe& a, const tfe& b) {
    tfe s;
    team_add_raw(tm, s, a, b);
    team_cond_sub_n(tm, r, s);
}

// r = a - b mod N
__device__ __forceinline__ void team_fsub(const Team& tm, tfe& r, const tfe& a, const tfe& b) {
    tfe d, addend, zero;
    const uint32_t borrow = team_sub_raw(tm, d, a, b);
    tzero(zero);
    tselect(addend, borrow != 0, tm.n, zero);
    team_add_raw(tm, r, d, addend);  // the carry out cancels the borrow
}

// r = -a mod N (0 stays 0)
__device__ __forceinline__ void team_fneg(const Team& tm, tfe& r, const tfe& a) {
    tfe d, zero;
    const bool nz = team_any(tm, !slice_zero(a));
    team_sub_raw(tm, d, tm.n, a);
    tzero(zero);
    tselect(r, nz, d, zero);
}

// r[p] = (sum_s a[p][s] * b[p][s] + M_p N) / R, canonical, for NP
// independent products p, each the sum of its NR rows' products under ONE
// interleaved reduction. Round word j * TK + k of b[p][s] is broadcast to
// the team from thread j by a shuffle. The NP products share the round
// loop, so their dependent chains (and quotient shuffles) overlap: a group
// operation issues its independent products together. The caller
// guarantees sum_s a[p][s] < R and b[p][s] < N, so each reduced value is
// below 2N (N sum a / R + N, with 2N < R) and one conditional subtraction
// makes it canonical.
template <int NP, int NR>
__device__ __forceinline__ void team_mont(const Team& tm, tfe (&r)[NP], uint32_t (&a)[NP][NR][TK],
                                          uint32_t (&b)[NP][NR][TK]) {
    uint32_t A[NP][TK], C[NP];  // C: pending carry, owed at the bottom of the next thread's slice
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        tzero(A[p]);
        C[p] = 0;
    }
#pragma unroll 1
    for (int j = 0; j < TEAM; ++j) {  // the thread that owns this round's operand words
#pragma unroll
        for (int k = 0; k < TK; ++k) {
#pragma unroll
            for (int p = 0; p < NP; ++p) {
                // everything landing at weight t*TK + TK, as a 64-bit sum (lo, hi)
                uint32_t lo = C[p], hi = 0;
#pragma unroll
                for (int s = 0; s < NR; ++s) {
                    const uint32_t x = slice_mac(A[p], a[p][s], __shfl_sync(FULL_MASK, b[p][s][k], j, TEAM));
                    lo = add_cc(lo, x);
                    hi = addc(hi, 0);
                }
                const uint32_t q = __shfl_sync(FULL_MASK, A[p][0] * tm.n0, 0, TEAM);
                const uint32_t x = slice_mac(A[p], tm.n, q);
                lo = add_cc(lo, x);
                hi = addc(hi, 0);
                // thread 0's bottom word is now 0: move the window down one
                // word. The top thread reads thread 0's word (the source lane
                // wraps around the team), which is that 0: no branch on the
                // thread index, which the compiler would hoist into two copies
                // of the loop for different threads of one warp (divergent
                // shuffles).
                const uint32_t nxt = __shfl_sync(FULL_MASK, A[p][0], (tm.t + 1) & (TEAM - 1), TEAM);
                lo = add_cc(lo, nxt);
                hi = addc(hi, 0);
#pragma unroll
                for (int m = 0; m < TK - 1; ++m) A[p][m] = A[p][m + 1];
                A[p][TK - 1] = lo;
                C[p] = hi;
            }
        }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        // hand the pending carries up (thread 0 takes the top thread's, which
        // is 0: the value is below R) and resolve what is left (0 / 1 carries)
        const uint32_t inc = __shfl_sync(FULL_MASK, C[p], (tm.t + TEAM - 1) & (TEAM - 1), TEAM);
        const uint32_t g = slice_add_word(A[p], inc);
        uint32_t top;
        slice_add_word(A[p], team_lookahead(tm, g != 0, slice_all_ones(A[p]), top));
        team_cond_sub_n(tm, r[p], A[p]);
    }
}

// r = w * a mod N for a small w >= 1: binary addition chain, canonical at
// every step (w is |3b| <= 12 for every curve in scope; uniform per launch)
__device__ __forceinline__ void team_small_mul(const Team& tm, tfe& r, const tfe& a, uint32_t w) {
    tfe addend, acc;
    tset(addend, a);
    tset(acc, a);
    bool have = false;
    while (w) {
        if (w & 1u) {
            if (have) team_fadd(tm, acc, acc, addend); else { tset(acc, addend); have = true; }
        }
        w >>= 1;
        if (w) team_fadd(tm, addend, addend, addend);
    }
    tset(r, acc);
}

// the team's slice of lane `team`'s element in a staged box
__device__ __forceinline__ void team_from_box(const Team& tm, tfe& r, uint32_t (*box)[NL + 1],
                                              int team) {
#pragma unroll
    for (int m = 0; m < TK; ++m) r[m] = box[team][tm.t * TK + m];
}

__device__ __forceinline__ void team_to_box(const Team& tm, uint32_t (*box)[NL + 1], int team,
                                            const tfe& a) {
#pragma unroll
    for (int m = 0; m < TK; ++m) box[team][tm.t * TK + m] = a[m];
}
