#!/usr/bin/env python3
"""Throughput of the integer instructions behind the stacked-product
kernels, on one card.

    python3 scripts/imad_rate.py [--out build/imad_rate.json]

Builds one small CUDA library (its source is below, written to
build/imad_rate/) with nvcc for sm_90a and times, with CUDA events, kernels
whose threads each run 16 independent dependency chains of one form, many
warps an SM (so latency is hidden and the pipe's rate shows):

- `mad_lo`: mad.lo.u32 (SASS IMAD)
- `mad_hi`: mad.hi.u32 (IMAD.HI)
- `mad_wide`: mad.wide.u32 into a 64-bit sum (IMAD.WIDE)
- `lo_hi`: one mad.lo.u32 and one mad.hi.u32 a product, K6's pair of
  multiply-adds for one 16x16 limb product (csrc/stacked_cols.cu)
- `lea`: a three-instruction alternative to `lo_hi`: the product by one
  multiply, added to one sum and, shifted down 16 bits, to another (IMAD,
  IADD3, LEA.HI)

and prints one JSON line: per form the operations (chains x steps x
threads, a product counting one for `lo_hi` and `lea`) per second and per
clock and SM at the card's current SM clock as `nvidia-smi` reads it after
the run, with the card's name and power limit; and `k6_floor_ms`, K6's own
floor at each of chip_smoke.py's ROUTE_SHAPES["k6"] shapes and its BATCH
lanes: L^2 16x16 limb products per lane and non-zero weight at the `lo_hi`
rate of this run; `k5_floor_ms`, K5's floor (both forms) at its eight
stacked shapes from its IMAD.WIDE count at the `mad_wide` rate; and
`sqrt_floor_ms`, the square-root kernel's at chip_smoke.py's SQRT_CURVES
from its IMAD / IMAD.HI counts at the `mad_lo` / `mad_hi` rates. Exits non-zero without a card. The chains feed each other (step s of chain c reads chain c + 1's
value from step s - 1), so no compiler can fold a chain into fewer
operations.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
#define CH 16

template <int KIND>
__global__ void __launch_bounds__(256) rate_kernel(uint32_t* out, uint32_t a, int steps) {
    uint32_t s[CH], h[CH];
    uint64_t w[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
        s[c] = threadIdx.x * 2654435761u + c;
        h[c] = blockIdx.x + c;
        w[c] = s[c];
    }
    const uint32_t ah = a << 16;
#pragma unroll 1
    for (int i = 0; i < steps; ++i) {
        uint32_t t[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) t[c] = s[(c + 1) % CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            if (KIND == 0) asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(s[c]) : "r"(a), "r"(t[c]));
            if (KIND == 1) asm("mad.hi.u32 %0, %1, %2, %0;" : "+r"(s[c]) : "r"(ah), "r"(t[c]));
            if (KIND == 2) {
                asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(w[c]) : "r"(a), "r"(t[c]));
                s[c] = (uint32_t)w[c];
            }
            if (KIND == 3) {
                asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(s[c]) : "r"(a), "r"(t[c]));
                asm("mad.hi.u32 %0, %1, %2, %0;" : "+r"(h[c]) : "r"(ah), "r"(t[c]));
            }
            if (KIND == 4) {
                const uint32_t p = a * t[c];
                s[c] += p;
                h[c] += p >> 16;
            }
        }
    }
    uint32_t x = 0;
#pragma unroll
    for (int c = 0; c < CH; ++c) x ^= s[c] ^ h[c] ^ (uint32_t)(w[c] >> 32);
    out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

extern "C" int rate_launch(int kind, void* out, unsigned a, int steps, int blocks, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    uint32_t* o = (uint32_t*)out;
    switch (kind) {
        case 0: rate_kernel<0><<<blocks, 256, 0, st>>>(o, a, steps); break;
        case 1: rate_kernel<1><<<blocks, 256, 0, st>>>(o, a, steps); break;
        case 2: rate_kernel<2><<<blocks, 256, 0, st>>>(o, a, steps); break;
        case 3: rate_kernel<3><<<blocks, 256, 0, st>>>(o, a, steps); break;
        default: rate_kernel<4><<<blocks, 256, 0, st>>>(o, a, steps); break;
    }
    return (int)cudaGetLastError();
}
"""

FORMS = ("mad_lo", "mad_hi", "mad_wide", "lo_hi", "lea")
CHAINS = 16


def build() -> tuple[ctypes.CDLL, str]:
    from snark_setup_tpu_torch.ops.build import NVCC_FLAGS, find_nvcc

    root = os.path.join(HERE, "build", "imad_rate")
    os.makedirs(root, exist_ok=True)
    src, lib = os.path.join(root, "imad_rate.cu"), os.path.join(root, "libimad_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    done = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib, src], capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(done.stdout + done.stderr)
    return ctypes.CDLL(lib), done.stdout + done.stderr


def k6_floors(products_per_s: float) -> dict:
    """Milliseconds K6 needs at chip_smoke.py's K6 shapes and batch for its
    16x16 limb products alone (a mad.lo and a mad.hi each), at
    `products_per_s`."""
    import chip_smoke as cs
    from snark_setup_tpu_torch.ops.curve import curve_ops

    out = {}
    for curve, group, label, weights in cs.ROUTE_SHAPES["k6"]:
        F = curve_ops(curve, group).field
        comp = weights if F.degree == 1 else F._flattened(weights, len(weights[0]))[0]
        nz = sum(1 for g in comp for w in g if w)
        out[f"{curve} {label}"] = F.fp.L * F.fp.L * nz * cs.BATCH / products_per_s * 1e3
    return out


def k5_floors(wide_per_s: float, lo_per_s: float) -> dict:
    """Milliseconds K5 needs at chip_smoke.py's eight stacked shapes and
    batch for its multiply-adds alone, each form's count of them at this
    run's rates: IMAD.WIDE (a 32x32 -> 64-bit multiply-add) at `wide_per_s`,
    the reduction's quotient words (IMAD, one a row) at `lo_per_s`. Per lane
    and output group, per non-zero weight: the first form w u (NL) and NL
    rows of NL + 1; the redesign three Karatsuba half products of (NL / 2)^2
    and, for a weight other than 1, 2 NL to apply it. Per output group both
    reduce with NL rows of NL."""
    import chip_smoke as cs
    from snark_setup_tpu_torch.ops.curve import curve_ops

    shapes = {}
    for kern in ("k6", "k7", "k8"):
        for shape in cs.ROUTE_SHAPES[kern]:
            shapes.setdefault(shape[:3], shape)
    out = {"first form": {}, "redesign": {}}
    for curve, group, label, weights in shapes.values():
        F = curve_ops(curve, group).field
        comp = weights if F.degree == 1 else F._flattened(weights, len(weights[0]))[0]
        NL, G = F.fp.L // 2, len(comp)
        nz = [w for g in comp for w in g if w]
        first = len(nz) * (NL + NL * (NL + 1)) + G * NL * NL
        redesign = sum(3 * (NL // 2) ** 2 + (2 * NL if w != 1 else 0) for w in nz) + G * NL * NL
        for form, wide in (("first form", first), ("redesign", redesign)):
            out[form][f"{curve} {label}"] = cs.BATCH * (wide / wide_per_s + G * NL / lo_per_s) * 1e3
    return out


def sqrt_floors(lo_per_s: float, hi_per_s: float) -> dict:
    """Milliseconds the square-root kernel needs at chip_smoke.py's batch
    for its multiply-adds alone: per team product (csrc/field_team.cuh:
    team_mont) 2 NL^2 mad.lo (IMAD) and 2 NL^2 mad.hi (IMAD.HI) in the
    operand and reduction chains, and NL quotient words on each of the
    TEAM threads (IMAD), at this run's rates."""
    import chip_smoke as cs
    from snark_setup_tpu_torch.ops.codec import ExtSqrt
    from snark_setup_tpu_torch.ops.cuda_sqrt import fq_sqrt_for
    from snark_setup_tpu_torch.ops.curve import curve_ops

    out = {}
    for curve in cs.SQRT_CURVES:
        F = curve_ops(curve, "g1").field
        sq = ExtSqrt(F, F.fp.modulus)
        K = fq_sqrt_for(sq.q, sq.z_coeffs[0])
        NL = K.NL
        team = 4 if NL == 12 else 8  # csrc/field_team.cuh's default TEAM
        per_product = (2 * NL * NL + NL * team) / lo_per_s + 2 * NL * NL / hi_per_s
        out[curve] = cs.BATCH * K.products() * per_product * 1e3
    return out


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build", "imad_rate.json"))
    ap.add_argument("--steps", type=int, default=4096)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("imad_rate: no CUDA device", file=sys.stderr)
        return 2
    lib, log = build()
    fn = lib.rate_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * 8  # up to 8 blocks of 8 warps an SM (64 warps), as registers allow
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {"nvidia_smi": smi("name,power.limit"), "sms": sms, "blocks": blocks, "threads": 256,
              "chains": CHAINS, "steps": args.steps, "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln],
              "forms": {}}
    for kind, name in enumerate(FORMS):
        def run():
            err = fn(kind, out.data_ptr(), 40503, args.steps, blocks, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
        secs = start.elapsed_time(end) / 5 / 1e3
        clock_mhz = float(smi("clocks.sm").split()[0])
        ops = blocks * 256 * args.steps * CHAINS
        result["forms"][name] = {"ms": secs * 1e3, "ops_per_s": ops / secs,
                                 "per_clock_per_sm": ops / secs / (clock_mhz * 1e6) / sms,
                                 "sm_clock_mhz_after": clock_mhz}
    rate = {name: form["ops_per_s"] for name, form in result["forms"].items()}
    result["k6_floor_ms"] = k6_floors(rate["lo_hi"])
    result["k5_floor_ms"] = k5_floors(rate["mad_wide"], rate["mad_lo"])
    result["sqrt_floor_ms"] = sqrt_floors(rate["mad_lo"], rate["mad_hi"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
