// Whole GLV windowed ladder, one thread per lane (= per scalar
// multiplication).
//
// Replaces the reference's fused-ladder kernel (snark_setup_tpu/ops/
// pallas_ladder.py, FusedGLVLadder / _make_ladder_kernel): that kernel tiles
// the batch over a sequential grid and keeps a tile's table and accumulator
// in on-chip vector memory; here every lane is independent, so a thread owns
// one lane for the whole ladder and the grid's sequential window loop is a
// loop inside the thread. Blocks are independent.
//
// Per lane (the same schedule as ops/cuda_ladder.py:glv_ladder_plain):
//   base      = (-1)^neg * P
//   T[j]      = j * base, j < 16        (1 doubling + 13 additions)
//   Tx2[j]    = beta * T[j].x           (endomorphism table: phi(x,y) = (beta x, y))
//   acc       = O
//   per window k, most significant first:
//       acc = 16 acc                    (4 doublings)
//       acc += T[d1[k]]
//       acc += (Tx2[d2[k]], ±T[d2[k]].y, T[d2[k]].z)   (y negated where flip)
//
// Bound on an H100: integer multiply-add throughput, not memory. A lane moves
// 6 L + 2 nwin + 2 words (~1.5 KB at L = 48) and does ~60 field products per
// window, each 2 NL^2 wide multiply-adds: millions of IMADs per lane. So the
// design keeps everything per-thread: the 16-entry table (64 NL words per
// lane: 3 KB at NL = 12, 6 KB at NL = 24) does not fit in registers and lives
// in per-thread local memory, which the hardware interleaves so a warp's
// accesses to one table word coalesce; it stays in L1/L2. The alternative, a
// global scratch tensor [entry][coord][limb][lane] allocated by the wrapper,
// has the same access pattern and more plumbing. The digits are the
// contributor's secret: a table lookup reads all 16 rows and keeps one by
// mask, so addresses do not depend on them (16 * 3 NL loads per lookup
// against ~130,000 machine ops of field arithmetic per window).
//
// Field products are out-of-line functions (field.cuh), group operations too
// (group.cuh): the kernel is a few hundred machine ops of control around
// them, which keeps nvcc's time and the code's footprint small.
#include <cuda_runtime.h>
#include "group.cuh"

#define TABLE 16
#define BLOCK 128

__global__ void __launch_bounds__(BLOCK)
glv_ladder_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                  const uint32_t* __restrict__ pz, const uint32_t* __restrict__ d1,
                  const uint32_t* __restrict__ d2, const uint32_t* __restrict__ neg,
                  const uint32_t* __restrict__ flip, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t B, int nwin,
                  uint32_t b3w, uint32_t b3neg) {
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;  // ragged edge: the last block is partly idle

    Point T[TABLE];
    fe Tx2[TABLE];
    Point acc, sel;
    fe tmp;

    // base = ±P
    load_planes(T[1].x, px, B, lane);
    load_planes(T[1].y, py, B, lane);
    load_planes(T[1].z, pz, B, lane);
    fneg(tmp, T[1].y);
    fselect(T[1].y, neg[lane] & 1u, tmp, T[1].y);

    pinfinity(&T[0]);
    gdbl(&T[2], &T[1], b3w, b3neg);
#pragma unroll 1
    for (int j = 3; j < TABLE; ++j) gadd(&T[j], &T[j - 1], &T[1], b3w, b3neg);
    fset(tmp, FC.beta);
#pragma unroll 1
    for (int j = 0; j < TABLE; ++j) fmul(Tx2[j], T[j].x, tmp);

    const uint32_t fl = flip[lane] & 1u;
    pinfinity(&acc);
#pragma unroll 1
    for (int k = 0; k < nwin; ++k) {
#pragma unroll 1
        for (int i = 0; i < 4; ++i) gdbl(&acc, &acc, b3w, b3neg);

        const uint32_t e1 = d1[(int64_t)k * B + lane];
        fzero(sel.x); fzero(sel.y); fzero(sel.z);
#pragma unroll 1
        for (uint32_t j = 0; j < TABLE; ++j) {
            const uint32_t m = 0u - (uint32_t)(j == e1);
#pragma unroll
            for (int l = 0; l < NL; ++l) {
                sel.x[l] |= T[j].x[l] & m;
                sel.y[l] |= T[j].y[l] & m;
                sel.z[l] |= T[j].z[l] & m;
            }
        }
        gadd(&acc, &acc, &sel, b3w, b3neg);

        const uint32_t e2 = d2[(int64_t)k * B + lane];
        fzero(sel.x); fzero(sel.y); fzero(sel.z);
#pragma unroll 1
        for (uint32_t j = 0; j < TABLE; ++j) {
            const uint32_t m = 0u - (uint32_t)(j == e2);
#pragma unroll
            for (int l = 0; l < NL; ++l) {
                sel.x[l] |= Tx2[j][l] & m;
                sel.y[l] |= T[j].y[l] & m;
                sel.z[l] |= T[j].z[l] & m;
            }
        }
        fneg(tmp, sel.y);
        fselect(sel.y, fl, tmp, sel.y);
        gadd(&acc, &acc, &sel, b3w, b3neg);
    }

    store_planes(ox, acc.x, B, lane);
    store_planes(oy, acc.y, B, lane);
    store_planes(oz, acc.z, B, lane);
}

// Plain C entry point (loaded with ctypes). `consts` is a DEVICE pointer to
// 3 NL + 1 words: N, R mod N, beta (Montgomery), n0 = -N^{-1} mod 2^32; it is
// copied to constant memory on `stream` ahead of the launch (device to
// device: asynchronous, stream-ordered), so launches for different moduli on
// one stream stay ordered. Returns cudaGetLastError().
extern "C" int glv_ladder_launch(const void* px, const void* py, const void* pz, const void* d1,
                                 const void* d2, const void* neg, const void* flip, void* ox,
                                 void* oy, void* oz, long long B, int nwin, unsigned b3w,
                                 unsigned b3neg, const void* consts, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemcpyToSymbolAsync(FC, consts, sizeof(FieldConsts), 0,
                                              cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((B + BLOCK - 1) / BLOCK);
    glv_ladder_kernel<<<blocks, BLOCK, 0, s>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)d1,
        (const uint32_t*)d2, (const uint32_t*)neg, (const uint32_t*)flip, (uint32_t*)ox,
        (uint32_t*)oy, (uint32_t*)oz, (int64_t)B, nwin, b3w, b3neg);
    return (int)cudaGetLastError();
}

extern "C" int glv_ladder_nl(void) { return NL; }
