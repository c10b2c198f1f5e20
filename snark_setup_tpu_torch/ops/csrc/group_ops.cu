// One complete group operation per lane: doubling (RCB Alg. 9) or addition
// (RCB Alg. 7) on y^2 = x^3 + b over the field of field.cuh, one thread per
// lane, one launch per batch operation.
//
// Replaces the reference's fused group-op kernels (snark_setup_tpu/ops/
// pallas_group.py, PallasGroupOps.double / .add): those tile the batch over a
// sequential grid and keep a tile's field glue in on-chip vector memory; here
// every lane is independent, a thread owns one lane and all field glue
// (additions, subtractions, negations, the small 3b chains) stays in its
// registers and local memory. The bodies are group.cuh's gdbl / gadd, the
// same code the whole-ladder kernel (glv_ladder.cu) runs, so the projective
// X, Y, Z equal the plain group law (ops/curve.py) limb for limb.
//
// The (L, B) 16-bit-limb int32 planes of the package are read and written in
// place: thread b reads column b of every plane (coalesced across a warp) and
// packs two 16-bit limbs into one 32-bit limb in registers, so no separate
// conversion pass runs per launch.
//
// A second operand of batch 1 (the Pippenger window combine, sum_reduce's
// odd tail) is read at lane 0 by every thread: `bp` / `bq` are the batch
// strides of the two operands' planes, each 1 or B.
//
// Bound on an H100: integer multiply-add throughput. A doubling is 8 field
// products (16 NL^2 wide multiply-adds) against 6 L words of traffic, an
// addition 12 products, 6 of them pairwise under one reduction (21 NL^2),
// against 9 L words: ~9.7k multiply-adds for 1152 bytes at NL = 24.
#include <cuda_runtime.h>
#include "group.cuh"

#define BLOCK 128

__global__ void __launch_bounds__(BLOCK)
group_dbl_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                 const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
                 uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t B,
                 uint32_t b3w, uint32_t b3neg) {
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;  // ragged edge: the last block is partly idle
    Point p, r;
    load_planes(p.x, px, B, lane);
    load_planes(p.y, py, B, lane);
    load_planes(p.z, pz, B, lane);
    gdbl(&r, &p, b3w, b3neg);
    store_planes(ox, r.x, B, lane);
    store_planes(oy, r.y, B, lane);
    store_planes(oz, r.z, B, lane);
}

__global__ void __launch_bounds__(BLOCK)
group_add_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                 const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                 const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                 uint32_t* __restrict__ oz, int64_t B, int64_t bp, int64_t bq,
                 uint32_t b3w, uint32_t b3neg) {
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    const int64_t lp = bp == 1 ? 0 : lane;
    const int64_t lq = bq == 1 ? 0 : lane;
    Point p, q, r;
    load_planes(p.x, px, bp, lp);
    load_planes(p.y, py, bp, lp);
    load_planes(p.z, pz, bp, lp);
    load_planes(q.x, qx, bq, lq);
    load_planes(q.y, qy, bq, lq);
    load_planes(q.z, qz, bq, lq);
    gadd(&r, &p, &q, b3w, b3neg);
    store_planes(ox, r.x, B, lane);
    store_planes(oy, r.y, B, lane);
    store_planes(oz, r.z, B, lane);
}

// Plain C entry points (loaded with ctypes). `consts` is a DEVICE pointer to
// the FieldConsts words (N, R mod N, beta, n0); they are copied to constant
// memory on `stream` ahead of the launch (device to device, stream-ordered),
// so launches for different moduli on one stream stay ordered. Each returns
// cudaGetLastError().
extern "C" int group_dbl_launch(const void* px, const void* py, const void* pz, void* ox,
                                void* oy, void* oz, long long B, unsigned b3w, unsigned b3neg,
                                const void* consts, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemcpyToSymbolAsync(FC, consts, sizeof(FieldConsts), 0,
                                              cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((B + BLOCK - 1) / BLOCK);
    group_dbl_kernel<<<blocks, BLOCK, 0, s>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (uint32_t*)ox,
        (uint32_t*)oy, (uint32_t*)oz, (int64_t)B, b3w, b3neg);
    return (int)cudaGetLastError();
}

extern "C" int group_add_launch(const void* px, const void* py, const void* pz, const void* qx,
                                const void* qy, const void* qz, void* ox, void* oy, void* oz,
                                long long B, long long bp, long long bq, unsigned b3w,
                                unsigned b3neg, const void* consts, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemcpyToSymbolAsync(FC, consts, sizeof(FieldConsts), 0,
                                              cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((B + BLOCK - 1) / BLOCK);
    group_add_kernel<<<blocks, BLOCK, 0, s>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
        (const uint32_t*)qy, (const uint32_t*)qz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz,
        (int64_t)B, (int64_t)bp, (int64_t)bq, b3w, b3neg);
    return (int)cudaGetLastError();
}

extern "C" int group_ops_nl(void) { return NL; }
