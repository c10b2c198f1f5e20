"""The stacked-product kernel's arithmetic (csrc/stacked_mul.cu: the
Karatsuba product, the weighted accumulation, the reduction with pending
carries, the conditional negation and subtraction) compiled as host C++ and
run on the CPU, against `stacked_mul_plain`.

The kernel's device functions are plain C++ on 32- and 64-bit integers, so
the host compiler can build them: the CUDA qualifiers are defined away,
`cuda_runtime.h` is a stub, the kernel body runs once per (lane, group) from
a host loop that sets `blockIdx` / `threadIdx`, and the file's launch entry
point (which needs nvcc) is cut off. Every shape chip_smoke.py times K5 at,
plus weights 2 and 3 and S = G = 1, for both limb counts, with 0, 1, N - 1,
N - 2 and all-ones low limbs among the lanes; exact equality. Skips where no
host C++ compiler is installed.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from snark_setup_tpu_torch.fields.limb import int_to_limbs
from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for, stacked_mul_plain
from snark_setup_tpu_torch.ops.curve import curve_ops

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "snark_setup_tpu_torch", "ops",
                    "csrc")
A_NZ = ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 1, 0), (0, 0, 0, 0, 0, 1))
PAIRS = ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1))
ID6 = tuple(tuple(int(i == j) for j in range(6)) for i in range(6))
SHAPES = [("bls12_377", "g2", ID6), ("bls12_377", "g1", ((1, 2, 0), (0, 0, 3))),
          ("mnt4_753", "g1", A_NZ), ("mnt4_753", "g1", PAIRS), ("mnt4_753", "g2", A_NZ),
          ("mnt6_753", "g2", ID6), ("mnt6_753", "g2", PAIRS), ("bw6_761", "g1", ((1,),)),
          ("bls12_381", "g2", ID6)]

STUB = """#pragma once
typedef int cudaError_t;
#define cudaSuccess 0
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
"""

HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
struct Dim3 { unsigned x, y, z; };
static Dim3 blockIdx, threadIdx;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
#define __restrict__
#include "kernel_body.cu"
// in: B S G SU SV n_table (int64), table (int32), K5Consts (NL + 1 words), U, V
int main(int argc, char** argv) {
    FILE* f = fopen(argv[1], "rb");
    long long h[6];
    if (fread(h, 8, 6, f) != 6) return 1;
    const long long B = h[0];
    const int S = (int)h[1], G = (int)h[2], SU = (int)h[3], SV = (int)h[4], nt = (int)h[5];
    std::vector<int> table(nt);
    K5Consts fc;
    std::vector<uint32_t> U(2 * NL * SU * B), V(2 * NL * SV * B), out(2 * NL * G * B);
    if (fread(table.data(), 4, nt, f) != (size_t)nt || fread(&fc, 4, NL + 1, f) != NL + 1 ||
        fread(U.data(), 4, U.size(), f) != U.size() || fread(V.data(), 4, V.size(), f) != V.size()) return 1;
    fclose(f);
    for (unsigned g = 0; g < (unsigned)G; ++g)
        for (unsigned bx = 0; bx < (B + BLOCK - 1) / BLOCK; ++bx)
            for (unsigned tx = 0; tx < BLOCK; ++tx) {
                blockIdx = {bx, g, 0};
                threadIdx = {tx, 0, 0};
                stacked_mul_kernel(U.data(), V.data(), out.data(), table.data(), B, S, G, SU, SV, fc);
            }
    f = fopen(argv[2], "wb");
    fwrite(out.data(), 4, out.size(), f);
    fclose(f);
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """NL -> the path of the host build of csrc/stacked_mul.cu."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel's arithmetic")
    root = tmp_path_factory.mktemp("k5_host")
    (root / "cuda_runtime.h").write_text(STUB)
    with open(os.path.join(CSRC, "stacked_mul.cu")) as f:
        text = f.read()
    (root / "kernel_body.cu").write_text(text[: text.index("// Plain C entry point")])
    (root / "harness.cpp").write_text(HARNESS)
    exes = {}
    for nl in (12, 24):
        exe = root / f"k5_nl{nl}"
        subprocess.run([cxx, "-O1", "-std=c++17", f"-DNL={nl}", "-I", str(root), "-I", CSRC, "-o", str(exe),
                        str(root / "harness.cpp")], check=True, capture_output=True, timeout=600)
        exes[nl] = exe
    return root, exes


@pytest.mark.parametrize("curve,group,weights", SHAPES)
def test_host_build_of_the_kernel_equals_plain_version(host_kernel, curve, group, weights):
    root, exes = host_kernel
    F = curve_ops(curve, group).field
    fq = F.fp
    S = len(weights[0])
    comp, rows = (weights, (tuple(range(S)),) * 2 + ((0,) * S,)) if F.degree == 1 else F._flattened(weights, S)
    K = stacked_mul_for(fq.modulus)
    SU, B = F.degree * S, 37
    rng = np.random.default_rng(sum(map(ord, curve + group)) + S)

    def planes():
        a = rng.integers(0, 1 << 16, size=(fq.L, SU, B), dtype=np.int64)
        a[-1] = rng.integers(0, int(fq.N[-1, 0]), size=a.shape[1:])
        for lane, v in enumerate((0, 1, fq.modulus - 1, fq.modulus - 2)):
            a[:, :, lane] = int_to_limbs(v, fq.L).astype(np.int64)[:, None]
        a[: fq.L // 2, :, 4] = 0xFFFF  # all-ones low half: carries through every word
        return a.astype(np.int32)

    U, V = planes(), planes()
    table = [w for g in comp for w in g] + [i for r in rows for i in r]
    inp, outp = root / f"in_{os.getpid()}.bin", root / f"out_{os.getpid()}.bin"
    with open(inp, "wb") as f:
        np.array([B, len(comp[0]), len(comp), SU, SU, len(table)], np.int64).tofile(f)
        np.array(table, np.int32).tofile(f)
        K._consts_np.tofile(f)  # the by-value block the launch hands the kernel
        U.tofile(f)
        V.tofile(f)
    subprocess.run([str(exes[fq.L // 2]), str(inp), str(outp)], check=True, timeout=600)
    got = np.fromfile(outp, np.int32).reshape(fq.L, len(comp), B)
    want = stacked_mul_plain(fq, *K.gather(torch.from_numpy(U), torch.from_numpy(V), rows), comp).numpy()
    assert (got == want).all()
