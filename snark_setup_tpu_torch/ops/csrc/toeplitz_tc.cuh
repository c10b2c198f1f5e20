// The Montgomery reduction of the stacked product's routes K7 and K8 as two
// constant Toeplitz products on the int8 tensor cores.
//
// In: one lane's exact, resolved weighted sum c < R N (2 NL 32-bit words).
// Out: the canonical (c + m N) / R with m = c N' mod R, N' = -N^{-1} mod R:
//
//   y = T_low2 . bytes(c mod R)   (4 NL digit rows; m = resolve(y) mod R)
//   z = T_full . bytes(m)         (8 NL digit rows; u = m N = sum_d z_d 2^(8 d))
//   s = c + u, word by word as the rows of z come; res = s / R, minus N if >= N
//
// T_low2[d][i] is byte d - i of N' and T_full[d][i] byte d - i of N (0 where
// d - i is no byte index), both over byte digits in their natural order
// (ops/toeplitz.py: tc_matrices). Every operand and entry is a byte and a
// row sums at most 4 NL products: below 96 * 255^2 < 2^23, exact in s32.
// Because c comes in resolved, its low half is 4 NL bytes: two byte planes
// of the 16-bit limbs, where the reference's unresolved 16-bit columns need
// four (pallas_field.py: _redc_v2_kernel).
//
// Tensor cores: mma.sync m16n8k32 u8 x u8 -> s32 from PTX. A is the constant
// matrix (a tile of 16 digit rows by 32 byte columns), B the byte planes of
// 8 lanes (the lanes are the wide dimension N), D 16 digit rows by 8 lanes.
// Each warp reduces its own 32 lanes, one thread a lane (K8 hands its
// teams' sums to such warps), so after the constants are staged nothing
// waits on another warp. The A operands are packed on the host in fragment
// order (ops/toeplitz.py: mma_fragments): thread lid's four registers of
// tile (j, ks) are the 16 bytes at 512 (j KS + ks) + 16 lid, one
// conflict-free 16-byte load. Both matrices (27 KB at NL 24, 9 KB at NL 12)
// are copied into the block's shared memory once, by cp.async, issued at
// the kernel's start so that the copy lands while the schoolbook runs
// (tc_stage / tc_wait).
//
// A warp's scratch (TC_WARP_BYTES): bc, one row of TC_RB bytes a lane,
// holds c's low bytes and then m's (the product's B fragments are in
// registers by then); ys, 16 rows of TC_YS words, one D tile at a time.
// TC_RB = 32 KS + 16 and TC_YS = 8 mod 32 make the B-fragment loads, the
// lanes' 16-byte row stores and the D-tile stores free of bank conflicts.
// Each D tile is read back by the lanes' threads, one digit row per load,
// and folded in order: carries run through m's bytes, then through s's
// words. A tile of T_low2 needs only the k-steps at or below its digits, a
// tile of T_full those within 4 NL bytes of them (the rest are zero and
// skipped, at compile time). Folding two digits at a time, and a second D
// buffer to overlap the next tile's products with the fold, took K7 from
// 164 to 182-186 registers at NL 24, from 12 to 8 warps an SM: up to 1.2x
// slower (PERF.md).
#pragma once
#include <cuda_runtime.h>

#include "stacked_routes.cuh"

#define CB (4 * NL)              // bytes of c mod R (and of m): both products' depth
#define KS ((CB + 31) / 32)      // k-steps of 32 bytes
#define M1 (CB / 16)             // T_low2's tiles of 16 digit rows
#define M2 (2 * CB / 16)         // T_full's
#define TL_BYTES (M1 * KS * 512)
#define TC_BYTES ((M1 + M2) * KS * 512)

// TcConsts (the modulus by value), cond_neg_n and cond_sub_n are in
// stacked_routes.cuh, shared with K5 and K6.

#define TC_RB (32 * KS + 16)  // bytes a lane row of bc
#define TC_YS 40              // words a row of ys (32 lanes, = 8 mod 32)
#define TC_WARP_BYTES (32 * TC_RB + 16 * TC_YS * 4)

// Issue the copy of both packed matrices (TC_BYTES at `tmats`, device
// memory) into the start of the block's shared memory. Every thread calls it.
__device__ __forceinline__ void tc_stage(unsigned char* smem, const unsigned char* tmats) {
    const unsigned s0 = (unsigned)__cvta_generic_to_shared(smem);
    for (int o = threadIdx.x * 16; o < TC_BYTES; o += blockDim.x * 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s0 + o), "l"(tmats + o) : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for tc_stage's copy (every thread: it holds __syncthreads).
__device__ __forceinline__ void tc_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// B fragments of the warp's byte rows: lane nt 8 + g, bytes 32 ks + 4 tig
// .. + 3 and 16 further on.
__device__ __forceinline__ void tc_load_b(uint32_t (&b)[4][KS][2], const unsigned char* bc) {
    const int lid = threadIdx.x & 31;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            const unsigned char* p = bc + (nt * 8 + (lid >> 2)) * TC_RB + 32 * ks + 4 * (lid & 3);
            b[nt][ks][0] = *(const uint32_t*)p;
            b[nt][ks][1] = *(const uint32_t*)(p + 16);
        }
}

// Digit rows 16 j .. 16 j + 15 of (packed matrix `frag`) . B into ys, over
// the k-steps klo .. khi.
__device__ __forceinline__ void tc_tile(const unsigned char* frag, int j, int klo, int khi,
                                        const uint32_t (&b)[4][KS][2], int* ys) {
    const int lid = threadIdx.x & 31;
    int d[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        if (ks < klo || ks > khi) continue;
        const uint4 a = *(const uint4*)(frag + ((j * KS + ks) * 32 + lid) * 16);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_u8(d[nt], a, b[nt][ks][0], b[nt][ks][1]);
    }
    const int g = lid >> 2, col = 2 * (lid & 3);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
        *(int2*)(ys + g * TC_YS + nt * 8 + col) = make_int2(d[nt][0], d[nt][1]);
        *(int2*)(ys + (g + 8) * TC_YS + nt * 8 + col) = make_int2(d[nt][2], d[nt][3]);
    }
}

// The reduction for the warp's 32 lanes. Every thread of the warp calls it
// (it holds __syncwarp and mma.sync) with its lane's c (2 NL words, < R N)
// and gets res (NL words, canonical). `wbuf` is the warp's TC_WARP_BYTES of
// shared scratch, `consts` the staged matrices, N the modulus by value.
__device__ __forceinline__ void tc_redc(const uint32_t* c, uint32_t* res, unsigned char* wbuf,
                                        const unsigned char* consts, const uint32_t* N) {
    const int lid = threadIdx.x & 31;
    unsigned char* bc = wbuf;
    int* ys = (int*)(wbuf + 32 * TC_RB);
    uint4* row = (uint4*)(bc + lid * TC_RB);  // this lane's byte row
#pragma unroll
    for (int q = 0; q < NL / 4; ++q) row[q] = make_uint4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
    __syncwarp();
    uint32_t b[4][KS][2];
    tc_load_b(b, bc);
    // m: each tile's 16 digits resolved into 16 bytes of m, over c's bytes
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < M1; ++j) {
        tc_tile(consts, j, 0, (16 * j + 15) / 32, b, ys);
        __syncwarp();
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            w[q] = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const uint32_t v = (uint32_t)ys[(4 * q + e) * TC_YS + lid] + carry;
                w[q] |= (v & 0xFFu) << (8 * e);
                carry = v >> 8;
            }
        }
        row[j] = make_uint4(w[0], w[1], w[2], w[3]);
        __syncwarp();
    }
    tc_load_b(b, bc);
    // s = c + m N: each tile's 16 digits are 4 words of u
    uint64_t sc = 0;
#pragma unroll
    for (int j = 0; j < M2; ++j) {
        const int lo = 16 * j - CB + 1, hi = (16 * j + 15) / 32;
        tc_tile(consts + TL_BYTES, j, lo > 0 ? lo / 32 : 0, hi < KS ? hi : KS - 1, b, ys);
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int* y = ys + 4 * q * TC_YS + lid;
            sc += (uint64_t)(uint32_t)y[0] + ((uint64_t)(uint32_t)y[TC_YS] << 8) +
                  ((uint64_t)(uint32_t)y[2 * TC_YS] << 16) + ((uint64_t)(uint32_t)y[3 * TC_YS] << 24) + c[4 * j + q];
            if (4 * j + q >= NL) res[4 * j + q - NL] = (uint32_t)sc;
            sc >>= 32;
        }
        __syncwarp();
    }
    cond_sub_n(res, res, N);  // s / R < 2 N (the wrapper checks sum W * N < R)
}
