#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (snark_setup_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py [--power 16] [--sweep]

It builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card (exact equality —
this is modular arithmetic, tolerance 0), drives the port's main paths
through the port's CLI entry point — `phase1 new` + `phase1 contribute` on
BW6-761 (plus the batch scalar-mul on BLS12-377 G1 and BW6-761 G1), on
BLS12-377 (the CLI's default curve), on MNT4-753 and on MNT6-753, then the
coordinator's side: `verify-and-transform-pok-and-correctness` and
`verify-and-transform-ratios` on the BW6-761 contribution (plus three bad
responses that must be rejected by the named check) and on a BLS12-377 one;
then BLS12-381 at BLS_VERIFY_POWER and full batch width: the `bls12_381`
path contributes (K3 on both groups — the curve's own digits library,
`glv_digits_bls12_381` —, K4 on G1, K5 rounds for G2 over Fp2) and the
`bls12_381 verify` path verifies that response (K2 on G1; K5 for G2 and
its subgroup checks; the square-root kernel for G1's decompression) and
rejects a `swap` and an `out_of_subgroup` response (the G1 cofactor gives
the point) —
and checks the results against the host oracle (Python-int curve arithmetic
and the host codec). Then the stacked product's three opt-in routes: the
BLS12-377 verify path's power-13 contribution again under
SNARK_SETUP_KERNEL_V3 (kernel K7) and under SNARK_SETUP_MXU_STACKED (K6 +
the matrix-product reduction), the
MNT4-753 one under SNARK_SETUP_KERNEL_V2 (K8 where its bounds hold, K5
elsewhere), each response byte-identical to the default route's from the
same challenge and seed, and the batch scalar-mul under the routes at the
other limb count (ROUTE_SCALAR_MUL_BATCH lanes, 4096; host-oracle spot
checks; the seconds inside each kernel
summed from its launch events, as on the contribute and route paths; under
SNARK_SETUP_MXU_STACKED also the seconds of the float64 reduction after
K6, from events around each reduction). Each path runs with every kernel's launch count set to 0
just before it and read just after; every kernel must have launched on its
path, and no plain version may have run there. The decompression square
root over Fq is one launch of its own kernel (csrc/fq_sqrt.cu, one team of
threads a lane for the whole chain), held against `fq_sqrt_plain` at 1, 33,
4097 and 16384 lanes with 0, 1, q - 1 and non-squares in every run; its
rows (BW6-761, BLS12-377, BLS12-381) belong to the verify paths, where it
must launch. K5 launches on the BW6-761 verify path are reported (none is
expected: that path's only K5 products were the square root's). The same
library's second entry point raises to a public exponent: at q - 2 it is
the inversion at the root of every batch inversion (`FpOps.inv` on the
card, one launch a write-back), held against `fq_pow_plain` at 1, 2, 33
and 4097 lanes with 0, 1 and q - 1 among them on all five base fields and
timed at the one lane the main path gives it; its rows belong to the
contribute paths. The contribute, verify and streaming phase-2 paths run
their write-backs and checks through bounded pipelines
(`snark_setup_tpu_torch/utils/pipeline.py`); one `{"phase": "pipeline"}`
line each gives the depth in use, the most finishes pending at once, the
wall and the kernel seconds. After the paths, a response with two faults
in one batch (a point outside the subgroup in tau_g1, then a point at
infinity in tau_g2) must be rejected by the read's PointAtInfinityError on
the card and on the CPU.

Each phase prints one JSON line. Near the end it prints one
`{"kernels": [...]}` line with, per kernel and configuration: the launches
counted on the main path, the largest absolute difference to the plain
version, the kernel's and the plain version's time at the main path's shape,
and the least time the card could take for the same work (`bound_ms`), the
larger of
  * bytes moved (inputs read once, outputs written once) at 3.35e12 B/s, and
  * integer multiply-adds at 16.75e12 /s: the data sheet's 67 TFLOP/s fp32
    rate is 33.5e12 FMA/s, and the CUDA C++ Programming Guide's table of
    arithmetic-instruction throughput gives compute capability 9.0 64 32-bit
    integer multiply-adds per clock per SM against 128 fp32 ones, so half of
    it. A 32x32->64-bit multiply-add is counted as one such instruction: if
    the card runs it at a lower rate the true bound is higher, never lower.
    K6, K7 and K8 are charged the work of the function they compute, as
    K5 counts it, whatever their own algorithm; the Toeplitz products of K7
    and K8 (u8 x u8 -> s32 on the tensor cores) add 989.5e12 multiply-adds
    /s (the data sheet's 1979 dense int8 TOP/s) on their own unit, the
    units overlapping. Beside the bound, K8's rows carry its own floor,
    its f32 FMAs (`fma_floor_ms`). K6's own floor (a mad.lo and a mad.hi
    per 16x16 limb product) depends on the rate of IMAD.HI, which no data
    sheet gives: scripts/imad_rate.py measures that rate and prints the
    floor at K6's shapes.
The group-op kernel's rows (K2, one team of threads per lane on
csrc/field_team.cuh) time each launch by its own CUDA events (`ms`; the
wrapper's host time per call exceeds the kernel's, so a loop of calls,
`call_ms`, measures the host) and also carry the team size (`team`) and
`lanes_ms`: the kernel's time at the widths the verify path launches (1
lane, nwin, 1024 and the full batch) beside its bound. The digits and
ladder kernels' rows (K3, K4; the ladder one team of threads per lane on
the same layer, each thread's slice of the tables in local memory) time
each launch the same way (`call_ms` for the digits) and carry
`launches_by_width`; the digits rows also the library's compile-time
`geometry`, the ladder's rows `team` and `lanes_ms`: its time at every
width the main path launched and at 1 lane.
The stacked product's rows (K5) carry `launches_of_shape` and
`launches_by_shape`: the launches of each weight shape (`shape_key`) on the
row's path, which scripts/compare_kernels.py --launch-weights reads; the
square root's rows `team`, `products` (Montgomery products a lane) and
`two_adicity`.
After the default paths it runs BLS12-377 contributions in the modes they
do not take, at MODES_POWER (10): `beacon`, chunked `contribute` (every
chunk) and Marlin `contribute`, each checked against the host oracle and
the hash chain, with K3 and K4 launched on each; then their coordinator's
side: chunked verification (two chunks), `combine` (Phase1.aggregation),
`verify-and-transform-ratios` on the combined accumulator
(Phase1.aggregate_verification), `split` of the beacon's full response and
its decompression (Phase1.decompress) and Marlin verification, each
file checked against the host codec's decoding of its source and the hash
chain.
Then the ceremony driver (scripts/torch_ceremony.py) runs its `chunked`
plan, the steps and flags of scripts/phase1_chunked.sh, at the upstream
CI's size (BW6-761, power 10, batch = chunk = 512: two participants a
chunk, combine, beacon, full verification, ratios, split and the second
round), each step through its CLI's `main(argv)` in this process, with the
driver's checks (every `.hash` file, four lanes of every response against
the host oracle) and every new challenge's hash chain (`bw6_761
ceremony`; K3 + K4 on both groups, K2, the square root and the inversion
must launch).
Then phase 2 through the port's phase-2 CLIs (`circuit_main`,
`prepare_phase2_main`, `phase2_main`; `phase2_phase(dev, curve, ...)`, one
function for any curve, from the verified new challenge of that curve's
verify path): on BW6-761, from the `bw6_761 verify` path's power-16
challenge, the SHA-256 preimage circuit at domain 2^16 (prepare, `new` in
two chunks, one participant contributing to and verifying each (a second
one took ~30 s more on the H100), a bad response rejected by the L
ratio check, `combine`; Lagrange-sum, h-query and hash-chain checks), then
the prover gate on the x^2 circuit (a proof from the combined parameters
verifies, one for a wrong input does not); on BLS12-377, the phase-2 CLI's
default curve, the `bls12_377 phase2` path: the prover gate from the
`bls12_377 verify` path's power-13 challenge, with the L ratio rejection
(the SHA-256 chain on BLS12-377, two participants a chunk, with the
power-16 verification it starts from took 317.5 s on the H100, over the
120 s this script can give it:
`tests/test_torch_phase2_gpu.py::test_bls12_377_sha256_chain_on_the_card`
runs it). K2, K3 and K4 of both
BW6-761 groups must launch on the BW6-761 phase-2 paths, K3 + K4 and K2 on
G1, K3 on G2 and K5 on the BLS12-377 one (the rows' `phase2_launches`); one
JSON line per CLI step (wall and kernel seconds) and a breakdown line each
for prepare and `new`. Then the streaming phase 2 (`phase2/chunked.py`: contribute in place
and verify over raw buffers, on the SHA-256 path's chunk 0 and combined
file; K3 + K4 and K2 on BW6-761 G1, one line a step with a host breakdown),
the device mesh (`shard/mesh.py`) over two entries of the one card (the
sharded step and inverse FFT equal to the single-device results; no time is
claimed) and the portable contributor (`portable/`, host Python) on the
prover gate's challenge, its response verified on the card.
There is no single PyTorch call that computes any of these functions (a
batched multi-word Montgomery product has none), so `library_ms` is null. The last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

With `--sweep` it also times the ladder kernel at batch 2^12 .. 2^17 (how far
a launch fills the card at the batch sizes a ceremony uses).
`--power` sets the size of the BW6-761 and BLS12-377 contribute phases, the
BW6-761 verify path and the phase-1 transcript of the phase-2 paths
(default 16; below 16 the SHA-256 circuit's path is skipped); the MNT
phases run at MNT_POWER (13), half a batch per G2 section, the BLS12-377
and BLS12-381 verify paths (and so the BLS12-377 phase-2 path) and the
BLS12-377 route paths at BLS_VERIFY_POWER (13).

Any failed build, launch, comparison or oracle check raises: the script then
exits non-zero without printing the result lines. Without a CUDA device it
exits with code 2.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
INT8_MAC_PER_S = 989.5e12  # the data sheet's 1979 dense int8 TOP/s on the tensor cores
FMA_PER_S = 33.5e12  # the data sheet's 67 TFLOP/s fp32: K8's own floor (its f32 FMAs)
SEED = 20240607
BATCH = 16384  # lanes per batch on the main path (the size bench.py uses)
# MNT_POWER and BLS_VERIFY_POWER were 14 before the streaming phase 2, the
# mesh, the portable contributor and the modes' coordinator's side joined the
# script: cut to 13 to keep it near 80 % of its time limit
MNT_POWER = 13  # MNT4-753 / MNT6-753 contributions: half a batch per G2 section
BLS_VERIFY_POWER = 13  # the BLS12-377 verify path (G1 on K2, G2 on K5 rounds) and route paths
MODES_POWER = 10  # the BLS12-377 beacon, chunked and Marlin contributions (12 before the ceremony path)
CEREMONY = ("bw6", 10, 512, 512)  # the upstream CI's end-to-end run: curve, power, batch, chunk size
CEREMONY_PATH = "bw6_761 ceremony"
RAGGED = 4097  # a batch that is no multiple of the kernels' block size
PHASE2_CHUNK = 1 << 15  # `phase2 new --chunk-size` on the SHA-256 circuit: 2 chunks of its 2^16 h query
PHASE2_PATHS = ("bw6_761 phase2", "bw6_761 prover", "bls12_377 phase2")
CHUNKED_PATH = "bw6_761 phase2 chunked"  # the streaming phase 2 on the SHA-256 path's files
MESH_IFFT_POINTS = 1 << 14  # the sharded inverse FFT of the mesh path (BW6-761 G1)
PHASE2_KERNELS = tuple(f"{k}[bw6_761/{g}]" for g in ("g1", "g2")
                       for k in ("glv_digits", "glv_ladder", "group_add"))  # must launch on the phase-2 paths
# BLS12-377's phase 2: K3 + K4 and K2 on G1, K3 on G2 (its ladder over the
# group law on K5 rounds over Fp2)
BLS_PHASE2_KERNELS = ("glv_digits[bls12_377/g1]", "glv_ladder[bls12_377/g1]", "group_add[bls12_377/g1]",
                      "glv_digits[bls12_377/g2]", "stacked_mul[bls12_377]")
CONFIGS = (("bw6_761", "g1"), ("bw6_761", "g2"), ("bls12_377", "g1"), ("bls12_381", "g1"))  # K2, K3, K4
# the path whose launches a configuration's K3 / K4 rows count (K2's: "<curve> verify")
KERNEL_PATHS = {"bls12_381": "bls12_381"}
DIGITS_ONLY = (("bls12_377", "g2"), ("bls12_381", "g2"))  # K3 feeds the ladder over the group law there
# the stacked-product kernel K5 at the main paths' shapes: (curve, group whose
# coordinate field it multiplies in, round, curve-level weights)
A_NONZERO_ROUND1 = ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 1, 0), (0, 0, 0, 0, 0, 1))
PAIRS = ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1))
ID6 = tuple(tuple(int(i == j) for j in range(6)) for i in range(6))
STACKED = (
    ("bls12_377", "g2", "Fp2 add round 0", ID6),
    ("bls12_377", "g1", "Fq planes x beta (G2 endomorphism table, S=G=32)",
     tuple(tuple(int(i == j) for j in range(32)) for i in range(32))),
    ("mnt4_753", "g1", "Fq add round 1, a != 0", A_NONZERO_ROUND1),
    ("mnt4_753", "g2", "Fp2 add round 1, a != 0 (largest weights: 3 x 14)", A_NONZERO_ROUND1),
    ("mnt6_753", "g2", "Fp3 add round 0", ID6),
    ("mnt6_753", "g2", "Fp3 add round 2 (pairwise merge)", PAIRS),
)
# K5 on the BLS12-381 modulus: its G2 ladder's Fp2 rounds (contribution)
BLS12_381_STACKED = (
    ("bls12_381", "g2", "Fp2 add round 0", ID6, "bls12_381"),
)
# the decompression square root over Fq (ops/cuda_sqrt.py), one launch a
# batch, on the verify path that decompresses that field's points
SQRT_CURVES = ("bw6_761", "bls12_377", "bls12_381")
INV_CURVES = ("bw6_761", "bls12_377", "bls12_381", "mnt4_753", "mnt6_753")  # each row on that curve's contribute path
INV_WIDTHS = (1, 2, 33, RAGGED)
SQRT_WIDTHS = (1, 33, RAGGED, BATCH)
# the opt-in routes' kernels: K6 and K7 at every K5 shape above; K8 only
# where v2_supported holds (degree-1 rounds with small weight sums)
ROUTE_SHAPES = {
    "k6": STACKED,
    "k7": STACKED,
    "k8": (
        STACKED[1],
        ("mnt4_753", "g1", "Fq add round 0", ID6),
        ("mnt4_753", "g1", "Fq add round 2 (pairwise merge)", PAIRS),
    ),
}
ROUTES = {  # wrapper attribute -> (switch, kernel name, source, reference pallas_call site)
    "k6": ("SNARK_SETUP_MXU_STACKED", "stacked_cols", "snark_setup_tpu_torch/ops/csrc/stacked_cols.cu",
           "snark_setup_tpu/ops/pallas_field.py:636"),
    "k7": ("SNARK_SETUP_KERNEL_V3", "stacked_mul_v3", "snark_setup_tpu_torch/ops/csrc/stacked_mul_v3.cu",
           "snark_setup_tpu/ops/pallas_field.py:536"),
    "k8": ("SNARK_SETUP_KERNEL_V2", "stacked_mul_v2", "snark_setup_tpu_torch/ops/csrc/stacked_mul_v2.cu",
           "snark_setup_tpu/ops/pallas_field.py:596"),
}
SECTIONS = (
    ("tau_g1", "g1", None),
    ("tau_g2", "g2", None),
    ("alpha_g1", "g1", "alpha"),
    ("beta_g1", "g1", "beta"),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, repeats: int) -> float:
    """Mean device time of `fn` in ms over `repeats` launches, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def launch_ms(counter, fn, repeats: int) -> float:
    """Mean device time of one launch in ms: `fn` launches the kernel whose
    wrapper counter is `counter` once; the mean over `repeats` calls (after
    one warm-up call) of the wrapper's per-launch (start, end) CUDA events.
    Host time between launches is not counted, so a narrow launch the host
    cannot keep up with is timed as the card runs it."""
    import torch

    fn()
    torch.cuda.synchronize()
    counter.events = []
    try:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in counter.events) / len(counter.events)
    finally:
        counter.events = None


def max_abs_diff(a, b) -> int:
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max()) if a.numel() else 0


def make_inputs(ops, B: int, rng, dev, edge: bool, projective: bool):
    """Seeded inputs for one (curve, group): (points, raw scalars, scalar
    ints, affine host points per lane). With `edge`, lanes 0..4 carry the
    scalars 0, 1, r-1, lambda and r-lambda (where the group has GLV) and
    lanes 5, 21, ... the point at infinity."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.curves.host import INFINITY
    from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
    from snark_setup_tpu_torch.ops.curve import PointVec

    r = ops.spec.r
    nbytes = (r.bit_length() + 7) // 8 + 8
    raw_bytes = rng.bytes(nbytes * B)
    ks = [int.from_bytes(raw_bytes[i * nbytes : (i + 1) * nbytes], "little") % r for i in range(B)]
    hc = ops.host_curve
    affine16 = [hc.mul(hc.generator, 3 + 5 * i) for i in range(16)]
    if edge:
        ks[0], ks[1], ks[2] = 0, 1, r - 1
        if ops.glv is not None:  # the eigenvalue: k1 = 0, k2 = +-1
            ks[3], ks[4] = ops.glv.p.lam, r - ops.glv.p.lam
        affine16[5] = INFINITY
    scalars = ops.fr.tensor(ints_to_limbs_batch(ks, ops.fr.L).T, dev)
    p16 = ops.from_affine_host(affine16, dev)
    if projective:
        # hand the kernel Z != 1 inputs: 2P on the device, 2P on the host
        p16 = ops.double(p16)
        affine16 = [p if p.is_infinity else hc.double(p) for p in affine16]
    idx = torch.arange(B, device=dev) % 16
    pts = PointVec({k: v[..., idx].contiguous() for k, v in p16.items()})
    return pts, scalars, ks, [affine16[i % 16] for i in range(B)]


def kernel_work(ops, dig, lad, B: int) -> dict:
    """Bytes and integer multiply-adds of one launch of each kernel at
    batch B, from the shapes alone. The ladder's bytes are its inputs and
    outputs only: its 16-entry tables (64 NL words a lane, written once and
    scanned whole twice a window, in local memory) are no traffic of the
    function it computes."""
    g = ops.glv
    Ls, nwin = dig.Ls, dig.nwin
    # digits: k x mu products and c x coeff products on 16-bit limbs
    terms = [t for t in (*g.k1_terms, *g.k2_terms) if t is not None]
    dig_ops = B * (sum(Ls * len(m) for m in g.mu) + sum(g.Lc * len(t[1]) for t in terms))
    dig_bytes = 4 * B * (Ls + 2 * nwin + 2)
    if lad is None:
        return {"glv_digits": (dig_bytes, dig_ops)}
    L, NL = lad.L, lad.NL
    # ladder: 32x32->64 multiply-adds, one operation each:
    #   product = 2 NL^2 (product + reduction), shared-reduction pair = 3 NL^2
    #   gdbl = 8 products, gadd = 6 products + 3 pairs
    gdbl, gadd = 16 * NL * NL, 21 * NL * NL
    per_lane = nwin * (4 * gdbl + 2 * gadd) + (gdbl + 13 * gadd + 16 * 2 * NL * NL)
    lad_ops = B * per_lane
    lad_bytes = 4 * B * (6 * L + 2 * nwin + 2)
    return {"glv_digits": (dig_bytes, dig_ops), "glv_ladder": (lad_bytes, lad_ops)}


def bound(nbytes: int, nops: int, int8_macs: int = 0) -> tuple[float, str]:
    """The larger of the bytes' time and the operations' time, each kind of
    operation on its own unit (32-bit integer multiply-adds, int8
    tensor-core multiply-adds) and the units overlapping."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(nops / IMAD_PER_S, int8_macs / INT8_MAC_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def compare_kernels(dev, batch: int) -> list[dict]:
    """Phase 3: both kernels against their plain versions, per configuration:
    a ragged batch with edge cases, then the main path's shape with timings."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for, glv_digits_plain
    from snark_setup_tpu_torch.ops.cuda_ladder import fused_ladder_for, glv_ladder_plain
    from snark_setup_tpu_torch.ops.curve import curve_ops

    rows = []
    for ci, (curve, group) in enumerate(CONFIGS):
        ops = curve_ops(curve, group)
        dig, lad = glv_digits_for(curve, group), fused_ladder_for(curve, group)
        rng = np.random.default_rng(SEED + ci)
        errs = {"glv_digits": 0, "glv_ladder": 0}
        times = {}
        for B, edge in ((RAGGED, True), (batch, False)):
            pts, scalars, _, _ = make_inputs(ops, B, rng, dev, edge=edge, projective=edge)
            got_d = dig(scalars)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want_d = glv_digits_plain(ops, scalars)
            torch.cuda.synchronize()
            times["digits_plain"] = (time.perf_counter() - t0) * 1e3
            errs["glv_digits"] = max(
                errs["glv_digits"], *(max_abs_diff(a, b) for a, b in zip(got_d, want_d))
            )
            got_p = lad(pts, *got_d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want_p = glv_ladder_plain(ops, pts, *want_d)
            torch.cuda.synchronize()
            times["ladder_plain"] = (time.perf_counter() - t0) * 1e3
            errs["glv_ladder"] = max(
                errs["glv_ladder"], *(max_abs_diff(got_p[k], want_p[k]) for k in "xyz")
            )
            if any(errs.values()):
                raise AssertionError(f"{curve} {group} B={B}: kernel differs from plain version: {errs}")
        # timings at the main path's shape (the last inputs made)
        # each kernel by its own launch events (a digits call's host time
        # can exceed its kernel's: `call_ms` times a loop of whole calls)
        times["digits"] = launch_ms(dig, lambda: dig(scalars), 20)
        times["digits_call"] = event_ms(lambda: dig(scalars), 20)
        times["ladder"] = launch_ms(lad, lambda: lad(pts, *got_d), 3)
        work = kernel_work(ops, dig, lad, batch)
        for name, wrapper, source, replaces, key in (
            ("glv_digits", dig, "snark_setup_tpu_torch/ops/csrc/glv_digits.cu",
             "snark_setup_tpu/ops/pallas_glv.py:215", "digits"),
            ("glv_ladder", lad, "snark_setup_tpu_torch/ops/csrc/glv_ladder.cu",
             "snark_setup_tpu/ops/pallas_ladder.py:385", "ladder"),
        ):
            b_ms, b_by = bound(*work[name])
            rows.append({
                "name": f"{name}[{curve}/{group}]", "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0, "max_abs_err": errs[name],
                "ms": times[key], "plain_ms": times[key + "_plain"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "batch": batch,
                **({"geometry": wrapper.geometry, "call_ms": times["digits_call"]} if key == "digits"
                   else {"team": wrapper.team}),
                "_wrapper": wrapper, "_path": KERNEL_PATHS.get(curve, "bw6_761"),
                "_label": f"{name}[{curve}/{group}]",
            })
        emit({"phase": "kernels", "config": f"{curve}/{group}", "batch": batch,
              "ragged_batch": RAGGED, "equal": True,
              "ms": {k: times[k] for k in ("digits", "digits_call", "digits_plain", "ladder", "ladder_plain")}})
    for ci, (curve, group) in enumerate(DIGITS_ONLY):
        ops = curve_ops(curve, group)
        dig = glv_digits_for(curve, group)
        rng = np.random.default_rng(SEED + 50 + ci)
        err = 0
        for B, edge in ((RAGGED, True), (batch, False)):
            _, scalars, _, _ = make_inputs(ops, B, rng, dev, edge=edge, projective=False)
            got_d = dig(scalars)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want_d = glv_digits_plain(ops, scalars)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(err, *(max_abs_diff(a, b) for a, b in zip(got_d, want_d)))
            if err:
                raise AssertionError(f"{curve} {group} B={B}: digits kernel differs from plain version")
        ms, call_ms = launch_ms(dig, lambda: dig(scalars), 20), event_ms(lambda: dig(scalars), 20)
        b_ms, b_by = bound(*kernel_work(ops, dig, None, batch)["glv_digits"])
        rows.append({
            "name": f"glv_digits[{curve}/{group}]", "route": "cuda",
            "source": "snark_setup_tpu_torch/ops/csrc/glv_digits.cu",
            "replaces": "snark_setup_tpu/ops/pallas_glv.py:215", "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "batch": batch, "geometry": dig.geometry, "call_ms": call_ms, "_wrapper": dig, "_path": curve,
            "_label": f"glv_digits[{curve}/{group}]",
        })
        emit({"phase": "kernels", "config": f"{curve}/{group}", "batch": batch, "ragged_batch": RAGGED,
              "equal": True, "ms": {"digits": ms, "digits_call": call_ms, "digits_plain": plain_ms}})
    return rows


def stacked_inputs(fq, S: int, B: int, rng, dev):
    """(L, S, B) int32 planes of values < N; lanes 0, 1, 2 hold 0, 1, N-1
    (the edge values) in every row."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.fields.limb import int_to_limbs

    L = fq.L
    a = rng.integers(0, 1 << 16, size=(L, S, B), dtype=np.int64)
    top = int(fq.N[L - 1, 0])
    a[L - 1] = rng.integers(0, top, size=(S, B))  # top limb below N's: value < N
    for lane, v in enumerate((0, 1, fq.modulus - 1)):
        if lane < B:
            a[:, :, lane] = int_to_limbs(v, L).astype(np.int64)[:, None]
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def stacked_work(fq, weights, SU: int, SV: int, B: int) -> tuple[int, int]:
    """Bytes (inputs read once, output written once) and 32x32->64-bit
    multiply-adds of one K5 launch: per lane and non-zero weight a weighted
    operand (NL) and a product (NL (NL + 1)), per output one reduction (NL^2)."""
    NL = fq.L // 2
    nz = sum(1 for g in weights for w in g if w)
    nbytes = 4 * fq.L * B * (SU + SV + len(weights))
    return nbytes, B * (nz * (NL * (NL + 1) + NL) + len(weights) * NL * NL)


def compare_stacked_mul(dev, batch: int) -> list[dict]:
    """K5 against its plain version at the main paths' shapes: a ragged
    batch with edge values, then the main path's batch with timings."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.cuda_mul import shape_key, stacked_mul_for, stacked_mul_plain
    from snark_setup_tpu_torch.ops.curve import curve_ops

    rows = []
    for ci, (curve, group, label, weights, *path) in enumerate(STACKED + BLS12_381_STACKED):
        F = curve_ops(curve, group).field
        fq = F.fp
        K = stacked_mul_for(fq.modulus)
        S = len(weights[0])
        if F.degree == 1:
            comp, maps = weights, (tuple(range(S)), tuple(range(S)), (0,) * S)
        else:
            comp, maps = F._flattened(weights, S)
        SU = F.degree * S
        rng = np.random.default_rng(SEED + 500 + ci)
        # lanes per chunk of the plain version: its product table is
        # (L+1) 2L int64 words per stacked row and lane
        chunk = max(256, int(4e9 // ((fq.L + 1) * 2 * fq.L * len(comp[0]) * 8)))
        err = 0
        for B in (RAGGED, batch):
            U, V = stacked_inputs(fq, SU, B, rng, dev), stacked_inputs(fq, SU, B, rng, dev)
            got = K(U, V, comp, maps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = torch.cat([
                stacked_mul_plain(fq, *K.gather(U[..., lo:lo + chunk], V[..., lo:lo + chunk], maps), comp)
                for lo in range(0, B, chunk)
            ], dim=-1)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(err, max_abs_diff(got, want))
            if err:
                raise AssertionError(f"stacked_mul {curve} {label} B={B}: kernel differs from plain version")
        ms = event_ms(lambda: K(U, V, comp, maps), 20)
        b_ms, b_by = bound(*stacked_work(fq, comp, SU, SU, batch))
        rows.append({
            "name": f"stacked_mul[{curve} {label}]", "route": "cuda",
            "source": "snark_setup_tpu_torch/ops/csrc/stacked_mul.cu",
            "replaces": "snark_setup_tpu/ops/pallas_field.py:498", "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "batch": batch, "shape": {"S": len(comp[0]), "G": len(comp), "SU": SU,
                                      "max_weight_sum": max(sum(g) for g in comp)},
            "_wrapper": K, "_path": path[0] if path else curve, "_label": f"stacked_mul[{curve}]",
            "_shape": shape_key(comp),
        })
        emit({"phase": "kernels", "config": f"stacked_mul {curve} {label}", "batch": batch,
              "ragged_batch": RAGGED, "edge_values": [0, 1, "N-1"], "equal": True,
              "ms": {"kernel": ms, "plain": plain_ms},
              "plain_chunk_lanes": chunk})
    return rows


def sqrt_inputs(fq, z: int, B: int, rng, dev):
    """(L, B) Montgomery planes: 0, 1, q - 1, the non-residue z and 4 z (a
    non-square) in lanes 0-4 (as far as B goes), then alternately random
    squares and random values."""
    q = fq.modulus
    rand = [int.from_bytes(rng.bytes(q.bit_length() // 8 + 8), "little") % q for _ in range(B)]
    vals = [v * v % q if i % 2 else v for i, v in enumerate(rand)]
    vals[: min(B, 5)] = [0, 1, q - 1, z, 4 * z % q][: min(B, 5)]
    return fq.tensor(fq.from_int(vals), dev)


def sqrt_work(K, B: int) -> tuple[int, int]:
    """Bytes (the operand read once, root and mask written once) and 32-bit
    multiply-adds (2 NL^2 a Montgomery product) of one square-root launch
    at B lanes."""
    return 4 * B * (2 * K.L + 1), B * K.products() * 2 * K.NL * K.NL


def compare_sqrt(dev, batch: int) -> list[dict]:
    """The square-root kernel against its plain version on the card at
    SQRT_WIDTHS, root and mask, with the edge values and non-squares in
    every run, then its time at the main path's batch."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.codec import batch_codec
    from snark_setup_tpu_torch.ops.cuda_sqrt import fq_sqrt_for, fq_sqrt_plain

    rows = []
    for ci, curve in enumerate(SQRT_CURVES):
        sq = batch_codec(curve, "g1", dev).sqrter
        K = fq_sqrt_for(sq.q, sq.z_coeffs[0])
        fq = K.fq
        rng = np.random.default_rng(SEED + 600 + ci)
        err = 0
        for B in SQRT_WIDTHS:
            a = sqrt_inputs(fq, K.z, B, rng, dev)
            root, ok = K(a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want_root, want_ok = fq_sqrt_plain(fq, K.z, a)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(err, max_abs_diff(root, want_root), max_abs_diff(ok.int(), want_ok.int()))
            if err:
                raise AssertionError(f"fq_sqrt {curve} B={B}: kernel differs from plain version")
            if bool(ok[3:5].any()) or not bool(ok[:2].all()):  # z and 4 z are no squares; 0 and 1 are
                raise AssertionError(f"fq_sqrt {curve} B={B}: wrong mask on the edge values")
        ms = launch_ms(K, lambda: K(a), 5)
        b_ms, b_by = bound(*sqrt_work(K, batch))
        rows.append({
            "name": f"fq_sqrt[{curve}]", "route": "cuda",
            "source": "snark_setup_tpu_torch/ops/csrc/fq_sqrt.cu",
            "replaces": "snark_setup_tpu/ops/pallas_field.py:498", "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "batch": batch, "widths": list(SQRT_WIDTHS), "team": K.team, "products": K.products(),
            "two_adicity": K.e, "_wrapper": K, "_path": f"{curve} verify", "_label": f"fq_sqrt[{curve}]",
        })
        emit({"phase": "kernels", "config": f"fq_sqrt {curve}", "batch": batch, "widths": list(SQRT_WIDTHS),
              "edge_values": [0, 1, "q-1", "z", "4z"], "equal": True, "ms": {"kernel": ms, "plain": plain_ms},
              "products_a_lane": K.products()})
    return rows


def inv_inputs(fq, B: int, rng, dev):
    """(L, B) Montgomery planes: 0, 1 and q - 1 in lanes 0-2 (as far as B
    goes), random values elsewhere."""
    q = fq.modulus
    vals = [int.from_bytes(rng.bytes(q.bit_length() // 8 + 8), "little") % q for _ in range(B)]
    vals[: min(B, 3)] = [0, 1, q - 1][: min(B, 3)]
    return fq.tensor(fq.from_int(vals), dev)


def inv_work(K, B: int) -> tuple[int, int]:
    """Bytes (the operand read once, the inverse written once) and 32-bit
    multiply-adds (2 NL^2 a Montgomery product) of one inversion launch at
    B lanes."""
    return 4 * B * 2 * K.L, B * K.products() * 2 * K.NL * K.NL


def compare_inv(dev) -> list[dict]:
    """The power kernel at q - 2 (the batch inversion's root) against its
    plain version on the card at INV_WIDTHS, with 0, 1 and q - 1 in every
    run; `FpOps.inv` must be one launch of it. Timed by its launch events
    at one lane, the width every write-back gives it."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.codec import batch_codec
    from snark_setup_tpu_torch.ops.cuda_sqrt import fq_inv_for, fq_pow_plain

    rows = []
    for ci, curve in enumerate(INV_CURVES):
        fq = batch_codec(curve, "g1", dev).fp
        q = fq.modulus
        K = fq_inv_for(q)
        rng = np.random.default_rng(SEED + 650 + ci)
        err = 0
        plain_ms = {}
        for B in INV_WIDTHS:
            a = inv_inputs(fq, B, rng, dev)
            n = K.launches
            got = fq.inv(a)
            torch.cuda.synchronize()
            if K.launches != n + 1:
                raise AssertionError(f"fq_inv {curve}: FpOps.inv is not one launch of the kernel")
            t0 = time.perf_counter()
            want = fq_pow_plain(fq, q - 2, a)
            torch.cuda.synchronize()
            plain_ms[B] = (time.perf_counter() - t0) * 1e3
            err = max(err, max_abs_diff(got, want))
            if err:
                raise AssertionError(f"fq_inv {curve} B={B}: kernel differs from plain version")
            vals, inv = fq.to_int(a[:, : min(B, 4)]), fq.to_int(got[:, : min(B, 4)])
            if any((v * w - 1) % q if v else w for v, w in zip(vals, inv)):
                raise AssertionError(f"fq_inv {curve} B={B}: not the inverse")
        one = inv_inputs(fq, 1, rng, dev)
        ms = launch_ms(K, lambda: K(one), 10)
        wide = inv_inputs(fq, RAGGED, rng, dev)
        wide_ms = launch_ms(K, lambda: K(wide), 3)
        b_ms, b_by = bound(*inv_work(K, 1))
        rows.append({
            "name": f"fq_inv[{curve}]", "route": "cuda",
            "source": "snark_setup_tpu_torch/ops/csrc/fq_sqrt.cu",
            "replaces": "snark_setup_tpu/ops/pallas_field.py:498", "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms[1], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "batch": 1, "widths": list(INV_WIDTHS), "lanes_ms": {"1": ms, str(RAGGED): wide_ms},
            "team": K.team, "products": K.products(), "_wrapper": K, "_path": curve, "_label": f"fq_inv[{curve}]",
        })
        emit({"phase": "kernels", "config": f"fq_inv {curve}", "widths": list(INV_WIDTHS),
              "edge_values": [0, 1, "q-1"], "equal": True, "ms": {"kernel": ms, "plain": plain_ms[1]},
              "plain_ms_by_width": plain_ms, "products_a_lane": K.products()})
    return rows


def route_work(route: str, fq, weights, SU: int, SV: int, B: int) -> tuple[int, int, int]:
    """(bytes, 32-bit multiply-adds, int8 tensor-core multiply-adds) of the
    function one launch of a route's kernel computes, counted as
    `stacked_work` counts K5, not by the route's own algorithm. K7 and K8
    return K5's product: K5's bytes and multiply-adds, plus their Toeplitz
    reduction's (2L x 2L) + (4L x 2L) = 12 L^2 byte multiply-adds per lane
    and output group on the tensor cores (csrc/toeplitz_tc.cuh). K6 returns the unreduced columns:
    K5's operand reads and products without the reduction, and 2L columns
    per output group at 4 bytes each (every column is below 2^32)."""
    L, NL, G = fq.L, fq.L // 2, len(weights)
    nbytes, nops = stacked_work(fq, weights, SU, SV, B)
    if route == "k6":
        return 4 * L * B * (SU + SV) + 4 * 2 * L * G * B, nops - B * G * NL * NL, 0
    return nbytes, nops, B * G * 12 * L * L


def compare_routes(dev, batch: int) -> list[dict]:
    """K6, K7 and K8 against their plain versions (and K7, K8 against K5) at
    the main paths' shapes: a ragged batch with edge values, then the main
    path's batch with timings beside K5's at the same shape."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.cuda_routes import stacked_product_for
    from snark_setup_tpu_torch.ops.curve import curve_ops

    rows = []
    for route, shapes in ROUTE_SHAPES.items():
        _, kname, source, replaces = ROUTES[route]
        for ci, (curve, group, label, weights) in enumerate(shapes):
            F = curve_ops(curve, group).field
            fq = F.fp
            P = stacked_product_for(fq.modulus)
            K = getattr(P, route)
            S = len(weights[0])
            if F.degree == 1:
                comp, maps = weights, (tuple(range(S)), tuple(range(S)), (0,) * S)
            else:
                comp, maps = F._flattened(weights, S)
            SU = F.degree * S
            rng = np.random.default_rng(SEED + 800 + ci)
            # lanes per chunk of the plain version: ~4 (L, L) int64 tables
            # per stacked row and lane
            chunk = max(256, int(4e9 // (4 * fq.L * fq.L * 8 * len(comp[0]))))
            err = 0
            for B in (RAGGED, batch):
                U, V = stacked_inputs(fq, SU, B, rng, dev), stacked_inputs(fq, SU, B, rng, dev)
                got = K(U, V, comp, maps)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                Ug, Vg = K.gather(U, V, maps)
                want = torch.cat([K.plain_fn(Ug[..., lo:lo + chunk], Vg[..., lo:lo + chunk], comp)
                                  for lo in range(0, B, chunk)], dim=-1)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                err = max(err, max_abs_diff(got, want))
                if route != "k6":
                    err = max(err, max_abs_diff(got, P.k5(U, V, comp, maps)))
                if err or got.dtype != want.dtype:
                    raise AssertionError(f"{route} {curve} {label} B={B}: kernel differs from plain version")
            ms = event_ms(lambda: K(U, V, comp, maps), 20)
            k5_ms = event_ms(lambda: P.k5(U, V, comp, maps), 20)
            b_ms, b_by = bound(*route_work(route, fq, comp, SU, SU, batch))
            if fq.L == 24 and route != "k8":
                path = "bls12_377 v3" if route == "k7" else "bls12_377 mxu"
            else:
                path = "mnt4_753 v2" if route == "k8" and fq.L == 48 else "route scalar-muls"
            name = f"{kname}[{curve} {label}]"
            own = {}
            if route == "k8":  # 4 L^2 f32 FMAs per lane and non-zero weight
                nz = sum(1 for g in comp for w in g if w)
                own["fma_floor_ms"] = 4 * fq.L * fq.L * nz * batch / FMA_PER_S * 1e3
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "batch": batch, "k5_ms": k5_ms, **own,
                "shape": {"S": len(comp[0]), "G": len(comp), "SU": SU,
                          "max_weight_sum": max(sum(g) for g in comp)},
                "_wrapper": K, "_path": path, "_label": f"{kname}[{curve}]", "_route": True,
            })
            emit({"phase": "kernels", "config": name, "batch": batch, "ragged_batch": RAGGED,
                  "edge_values": [0, 1, "N-1"], "equal": True, "equal_to_k5": route != "k6",
                  "ms": {"kernel": ms, "plain": plain_ms, "k5": k5_ms}, "plain_chunk_lanes": chunk})
    return rows


def group_inputs(ops, B: int, rng, dev):
    """Seeded operands of K2 for one group: affine (Z = 1) batches P, Q and
    their doubles 2P, 2Q (Z != 1, made by the plain group law). Lane 0 of P
    and lane 1 of Q are infinity, lane 2 of Q equals P and lane 3 of Q is
    -P: O + Q, P + O, P + P and P + (-P)."""
    import torch

    from snark_setup_tpu_torch.curves.host import INFINITY
    from snark_setup_tpu_torch.ops.curve import PointVec, plain_group_law

    hc = ops.host_curve
    base = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, 16)]
    base[0] = INFINITY
    table = ops.from_affine_host(base, dev)
    ip = torch.from_numpy(rng.integers(1, 16, B)).to(dev)
    iq = torch.from_numpy(rng.integers(1, 16, B)).to(dev)
    ip[0], iq[1], iq[2] = 0, 0, ip[2]
    P = PointVec({k: v[:, ip].contiguous() for k, v in table.items()})
    Q = PointVec({k: v[:, iq].contiguous() for k, v in table.items()})
    Q["y"][:, 3] = ops.fq.neg(P["y"][:, 3:4])[:, 0]
    Q["x"][:, 3], Q["z"][:, 3] = P["x"][:, 3], P["z"][:, 3]
    plain = plain_group_law(ops)
    return P, Q, plain.double(P), plain.double(Q)


def group_work(ops, kind: str, B: int) -> tuple[int, int]:
    """Bytes (coordinate planes in once, three out once; int32 words of
    16-bit limbs) and 32x32->64-bit multiply-adds of one K2 launch: a
    product is 2 NL^2 (product + reduction), a shared-reduction pair 3 NL^2;
    a doubling is 8 products, an addition 6 products + 3 pairs."""
    L = ops.fq.L
    NL = L // 2
    planes = 6 if kind == "dbl" else 9
    return 4 * L * B * planes, B * (16 if kind == "dbl" else 21) * NL * NL


def verify_shape_diffs(ops, k2, plain, P, Q, rng, dev, batch: int) -> dict:
    """K2 (through CurveOps, as the verify path calls it) against the plain
    group law at the verify path's own operand shapes; max |difference| per
    shape:

    - `subset_views`: the first level of the batched subgroup check's tree
      reduction, lanes 2i + 2i+1 of a (64, batch + 1) masked batch as the
      strided even / odd views `sum_reduce` passes;
    - `subset_sums`: the whole `sum_reduce` of that batch (every level, the
      odd tail carried up), held on 2 of its 64 rounds;
    - `pippenger_step`: a gathered (nwin, G) bucket row plus a point row
      expanded over the windows, y negated by the digit signs;
    - `pippenger_merge`: the first lane-merge level, two strided halves of
      the (nwin, nb, G) buckets;
    - `pippenger_finalize`: a bucket column of every window (nwin strided
      lanes) added to a running sum.

    The plain version runs in row slices: its product table takes ~0.23 MB
    a lane on BW6-761."""
    import torch

    from snark_setup_tpu_torch.ops.curve import PointVec
    from snark_setup_tpu_torch.ops.msm import RLC_BITS
    from snark_setup_tpu_torch.ops.pippenger import PippengerMSM

    def diff(a, b):
        return max(max_abs_diff(a[k], b[k]) for k in "xyz")

    def rows(p, lo, hi):
        return PointVec({k: v[:, lo:hi] for k, v in p.items()})

    def gather(nwin, nb, G):  # random points of P as a (nwin, nb, G) batch
        return PointVec({k: v[:, torch.from_numpy(rng.integers(0, batch, (nwin, nb, G))).to(dev)]
                         for k, v in P.items()})

    out = {}
    n = batch + 1
    pts = PointVec({k: torch.cat([P[k], Q[k][:, :1]], dim=-1) for k in "xyz"})
    bits = torch.from_numpy(rng.integers(0, 2, (64, n)).astype(bool)).to(dev)
    inf = ops.infinity((1, 1), dev)
    masked = PointVec({k: ops.field.select(bits, pts[k].unsqueeze(-2), inf[k]) for k in "xyz"})
    half = n // 2
    even = PointVec({k: v[..., 0 : 2 * half : 2] for k, v in masked.items()})
    odd = PointVec({k: v[..., 1 : 2 * half : 2] for k, v in masked.items()})
    got = ops.add(even, odd)
    out["subset_views"] = max(diff(rows(got, r, r + 1), plain.add(rows(even, r, r + 1), rows(odd, r, r + 1)))
                              for r in range(64))
    got = ops.sum_reduce(masked)
    out["subset_sums"] = diff(rows(got, 0, 2), plain.sum_reduce(rows(masked, 0, 2)))

    msm = PippengerMSM(ops, batch, RLC_BITS)
    nwin, nb, G = msm.nwin, msm.nb, msm.G
    buckets = gather(nwin, nb, G)
    ix = torch.from_numpy(rng.integers(0, nb, (nwin, 1, G))).to(dev)
    row = PointVec({k: torch.gather(v, 2, ix.unsqueeze(0).expand(ops.fq.L, -1, -1, -1)).squeeze(2)
                    for k, v in buckets.items()})
    pt = PointVec({k: v[:, :G].unsqueeze(-2).expand(ops.fq.L, nwin, G) for k, v in Q.items()})
    neg = torch.from_numpy(rng.integers(0, 2, (nwin, G)).astype(bool)).to(dev)
    pt["y"] = ops.field.select(neg, ops.field.neg(pt["y"]), pt["y"])
    out["pippenger_step"] = diff(ops.add(row, pt), plain.add(row, pt))
    h = G // 2
    lo = PointVec({k: v[..., :h] for k, v in buckets.items()})
    hi = PointVec({k: v[..., h:G] for k, v in buckets.items()})
    got = ops.add(lo, hi)
    out["pippenger_merge"] = max(diff(rows(got, w, w + 1), plain.add(rows(lo, w, w + 1), rows(hi, w, w + 1)))
                                 for w in range(nwin))
    col = PointVec({k: v[..., nb - 1, 0] for k, v in buckets.items()})
    acc = PointVec({k: v[:, :nwin] for k, v in Q.items()})
    out["pippenger_finalize"] = diff(ops.add(acc, col), plain.add(acc, col))
    torch.cuda.synchronize()
    return out


def compare_group_ops(dev, batch: int) -> list[dict]:
    """K2 against its plain version (the stacked group law over K5's plain
    product) per group: a ragged batch with the edge cases, affine and
    projective operands and a batch-1 second operand, then the main path's
    batch with timings."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.cuda_group import group_ops_for
    from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops, plain_group_law
    from snark_setup_tpu_torch.ops.msm import RLC_BITS
    from snark_setup_tpu_torch.ops.pippenger import PippengerMSM

    rows = []
    for ci, (curve, group) in enumerate(CONFIGS):
        ops = curve_ops(curve, group)
        k2, plain = group_ops_for(curve, group), plain_group_law(ops)
        rng = np.random.default_rng(SEED + 600 + ci)
        errs = {"dbl": 0, "add": 0}

        def diff(a, b):
            return max(max_abs_diff(a[k], b[k]) for k in "xyz")

        for B in (RAGGED, batch):
            P, Q, P2, Q2 = group_inputs(ops, B, rng, dev)
            for p in (P, P2):
                errs["dbl"] = max(errs["dbl"], diff(k2.double(p), plain.double(p)))
            q1 = PointVec({k: v[:, 5:6] for k, v in Q2.items()})
            for p, q in ((P, Q), (P2, Q2), (P, Q2), (P2, q1)):
                errs["add"] = max(errs["add"], diff(k2.add(p, q), plain.add(p, q)))
            torch.cuda.synchronize()
            if any(errs.values()):
                raise AssertionError(f"group ops {curve} {group} B={B}: kernel differs from plain version: {errs}")
        path_errs = verify_shape_diffs(ops, k2, plain, P2, Q2, rng, dev, batch)
        errs["add"] = max(errs["add"], *path_errs.values())
        if errs["add"]:
            raise AssertionError(f"group ops {curve} {group}: kernel differs from plain version "
                                 f"at the verify path's shapes: {path_errs}")
        times = {}
        for kind, counter, kern, pl in (
            ("dbl", k2.dbl, lambda: k2.double(P2), lambda: plain.double(P2)),
            ("add", k2.add_k, lambda: k2.add(P2, Q2), lambda: plain.add(P2, Q2)),
        ):
            # the kernel's own time (its launch events), and a loop of whole
            # calls: the wrapper's host time per call exceeds the kernel's
            times[kind] = launch_ms(counter, kern, 20)
            times[kind + "_call"] = event_ms(kern, 20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pl()
            torch.cuda.synchronize()
            times[kind + "_plain"] = (time.perf_counter() - t0) * 1e3
        # the widths the verify path launches: one lane (the window combine),
        # nwin (the bucket finalize), a lane-merge level, a full batch; each
        # launch timed by its own events (narrow launches outrun the host)
        nwin = PippengerMSM(ops, batch, RLC_BITS).nwin
        lanes_ms = {}
        for w in (1, nwin, 1024, batch):
            pw = PointVec({k: v[:, :w] for k, v in P2.items()})
            qw = PointVec({k: v[:, :w] for k, v in Q2.items()})
            lanes_ms[w] = {"dbl": launch_ms(k2.dbl, lambda: k2.double(pw), 50),
                           "add": launch_ms(k2.add_k, lambda: k2.add(pw, qw), 50)}
        for kind, counter in (("dbl", k2.dbl), ("add", k2.add_k)):
            b_ms, b_by = bound(*group_work(ops, kind, batch))
            name = f"group_{kind}[{curve}/{group}]"
            rows.append({
                "name": name, "route": "cuda", "source": "snark_setup_tpu_torch/ops/csrc/group_ops.cu",
                "replaces": "snark_setup_tpu/ops/pallas_group.py:149", "launches": 0,
                "max_abs_err": errs[kind], "ms": times[kind], "plain_ms": times[kind + "_plain"],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "batch": batch, "team": k2.team,
                "call_ms": times[kind + "_call"],
                "lanes_ms": {w: {"ms": t[kind], "bound_ms": bound(*group_work(ops, kind, w))[0]}
                             for w, t in lanes_ms.items()},
                "_wrapper": counter, "_path": f"{curve} verify", "_label": name,
            })
        emit({"phase": "kernels", "config": f"group_ops {curve}/{group}", "batch": batch,
              "ragged_batch": RAGGED, "edge_cases": ["O+Q", "P+O", "P+P", "P+(-P)", "Z!=1", "batch-1 q"],
              "verify_shapes": sorted(path_errs), "equal": True, "team": k2.team, "ms": times,
              "lanes_ms": lanes_ms})
    return rows


def scalar_mul_phase(dev, batch: int) -> None:
    """Phase 4: the batch scalar-mul entry point with host-oracle spot checks."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops
    from snark_setup_tpu_torch.shard import runtime

    for ci, (curve, group) in enumerate((("bls12_377", "g1"), ("bw6_761", "g1"))):
        ops = curve_ops(curve, group)
        rng = np.random.default_rng(SEED + 100 + ci)
        pts, scalars, ks, affine = make_inputs(ops, batch, rng, dev, edge=False, projective=False)
        out = runtime.scalar_mul(ops, pts, scalars, dev)
        torch.cuda.synchronize()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            out = runtime.scalar_mul(ops, pts, scalars, dev)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / reps
        lanes = [0, batch // 3, batch // 2, batch - 1]
        got = ops.to_affine_host(PointVec({k: v[:, lanes].contiguous() for k, v in out.items()}))
        for lane, pt in zip(lanes, got):
            if pt != ops.host_curve.mul(affine[lane], ks[lane]):
                raise AssertionError(f"scalar_mul {curve} {group}: lane {lane} differs from the host oracle")
        emit({"phase": "scalar_mul", "config": f"{curve}/{group}", "batch": batch,
              "seconds": secs, "exp_per_s": batch / secs, "oracle_lanes": lanes, "oracle_ok": True})


def check_response(params, key, challenge: bytes, response: bytes, rng, label: str,
                   picks: int = 6) -> int:
    """Host-oracle check of a Groth16 response: the hash chain, and for the
    first, the last and `picks` random indices per section
    response[i] == input[i] * (tau^(first + i) * coeff), `first` the
    absolute index of a chunk's first element (0 in full mode)."""
    from snark_setup_tpu_torch.curves.host import g1_curve, g2_curve
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, ContributionMode, UseCompression

    if response[:64] != hashlib.blake2b(challenge, digest_size=64).digest():
        raise AssertionError(f"{label}: response does not start with the challenge's hash")
    spec = params.spec
    sec_in, sec_out = split(params, UseCompression.NO), split(params, UseCompression.YES)
    codecs = {"g1": (g1_codec(spec), g1_curve(spec)), "g2": (g2_codec(spec), g2_curve(spec))}
    first = params.chunk_index * params.chunk_size if params.contribution_mode is ContributionMode.CHUNKED else 0
    checked = 0
    for name, group, coeff_name in SECTIONS:
        codec, curve = codecs[group]
        n = sec_in[name].num_elements
        if n == 0:
            continue  # a chunk past the powers_length sections
        idx = sorted({0, n - 1, *(int(i) for i in rng.integers(0, n, picks))})
        coeff = getattr(key, coeff_name) if coeff_name else 1
        for i in idx:
            p_in = codec.deserialize(bytes(sec_in[name].slice_of(challenge, i, i + 1)),
                                     UseCompression.NO, CheckForCorrectness.NO)
            p_out = codec.deserialize(bytes(sec_out[name].slice_of(response, i, i + 1)),
                                      UseCompression.YES, CheckForCorrectness.NO)
            if p_out != curve.mul(p_in, pow(key.tau, first + i, spec.r) * coeff % spec.r):
                raise AssertionError(f"{label}: {name}[{i}] differs from the host oracle")
            checked += 1
    codec, curve = codecs["g2"]
    b_in = codec.deserialize(bytes(sec_in["beta_g2"].slice_of(challenge, 0, 1)),
                             UseCompression.NO, CheckForCorrectness.NO)
    b_out = codec.deserialize(bytes(sec_out["beta_g2"].slice_of(response, 0, 1)),
                              UseCompression.YES, CheckForCorrectness.NO)
    if b_out != curve.mul(b_in, key.beta):
        raise AssertionError(f"{label}: beta_g2 differs from the host oracle")
    return checked + 1


def contribute_phase(dev, curve: str, power: int, batch: int, wrappers: dict,
                     contributions: int = 1, picks: int = 6, workdir: str | None = None) -> None:
    """`new` + `contribute` through the port's CLI on `curve`, checked
    against the host oracle; with `contributions=2` a second `contribute` on a
    non-trivial accumulator. `wrappers` maps a label to each kernel wrapper
    whose time inside the contribution is summed from CUDA events. The files
    (challenge1, response1, seed1, ...) stay in `workdir` where one is given."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.cli import phase1_main
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.phase1.protocol import Phase1
    from snark_setup_tpu_torch.transcript.hashing import calculate_hash, derive_rng_from_seed
    from snark_setup_tpu_torch.utils import pipeline
    from snark_setup_tpu_torch.utils.enums import (
        BatchExpMode, CheckForCorrectness, ProvingSystem, UseCompression,
    )

    common = ["--curve-kind", curve, "--proving-system", "groth16", "--contribution-mode",
              "full", "--power", str(power), "--batch-size", str(batch), "--device", dev.type]
    params = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, power, batch)
    rng = np.random.default_rng(SEED + 200)
    n_points = sum(s.num_elements for s in split(params, UseCompression.NO).values())
    for w in wrappers.values():
        w.events = []

    keep = contextlib.nullcontext(workdir) if workdir else tempfile.TemporaryDirectory(prefix="chip_smoke_")
    with keep as tmp:
        path = lambda name: os.path.join(tmp, name)
        seeds = {}
        for tag in ("1", "2"):
            seeds[tag] = hashlib.sha256(f"chip_smoke seed {tag}".encode()).digest()
            with open(path(f"seed{tag}"), "w") as f:
                f.write(seeds[tag].hex())

        def cli(*args) -> float:
            t0 = time.perf_counter()
            # the parser and dispatcher of `python -m ...cli.phase1_main`,
            # minus main()'s catch-all: a failure keeps its traceback
            phase1_main.execute(phase1_main.build_parser().parse_args(list(args)))
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        def read(name) -> bytes:
            with open(path(name), "rb") as f:
                return f.read()

        t_new = cli(*common, "new", "--challenge-fname", path("challenge1"),
                    "--challenge-hash-fname", path("challenge1.hash"))
        runs = []
        for tag, chal in (("1", "challenge1"), ("2", "challenge2"))[:contributions]:
            if tag == "2":
                # a non-trivial accumulator: apply another key to challenge1,
                # uncompressed, through the protocol layer
                _, key_mid = Phase1.key_generation(
                    params.spec, derive_rng_from_seed(b"\x07" * 32), b"\x00" * 64)
                acc = bytearray(params.get_length(UseCompression.NO))
                t0 = time.perf_counter()
                Phase1.computation(read("challenge1"), acc, UseCompression.NO, UseCompression.NO,
                                   CheckForCorrectness.NO, BatchExpMode.AUTO, key_mid, params,
                                   device=dev)
                torch.cuda.synchronize()
                t_mid = time.perf_counter() - t0
                acc[:64] = calculate_hash(read("response1"))
                with open(path("challenge2"), "wb") as f:
                    f.write(acc)
                emit({"phase": "contribute", "curve": curve,
                      "step": "uncompressed accumulator via Phase1.computation", "seconds": t_mid})
            n_events = {k: len(w.events) for k, w in wrappers.items()}
            with pipeline.recording() as pipes:
                secs = cli(*common, "--seed", path(f"seed{tag}"), "contribute",
                           "--challenge-fname", path(chal), "--challenge-hash-fname", path(chal + ".hash"),
                           "--response-fname", path(f"response{tag}"),
                           "--response-hash-fname", path(f"response{tag}.hash"))
            kernel_ms = {
                k: sum(s.elapsed_time(e) for s, e in w.events[n_events[k]:]) for k, w in wrappers.items()
            }
            pipeline_line(f"{curve} contribute {tag}", pipes, secs, sum(kernel_ms.values()) / 1e3)
            challenge, response = read(chal), read(f"response{tag}")
            _, key = Phase1.key_generation(
                params.spec, derive_rng_from_seed(seeds[tag]), calculate_hash(challenge))
            t0 = time.perf_counter()
            checked = check_response(params, key, challenge, response, rng,
                                     f"{curve} contribute {tag}", picks)
            t_oracle = time.perf_counter() - t0
            runs.append(secs)
            emit({"phase": "contribute", "step": f"contribute {tag}", "curve": curve,
                  "proving_system": "groth16", "mode": "full", "power": power, "batch_size": batch,
                  "points": n_points, "challenge_bytes": len(challenge), "wall_seconds": secs,
                  "points_per_s": n_points / secs, "kernel_ms": kernel_ms,
                  "kernel_seconds_total": sum(kernel_ms.values()) / 1e3,
                  "oracle_points_checked": checked, "oracle_seconds": t_oracle, "hash_chain_ok": True})
        emit({"phase": "contribute", "curve": curve, "step": "new", "seconds": t_new})
    for w in wrappers.values():
        w.events = None


@contextlib.contextmanager
def switched(name: str):
    """One route switch set for the block, restored after it (also when
    the block raises: the exception goes on)."""
    old = os.environ.get(name)
    os.environ[name] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def mxu_reducers(curves) -> dict:
    """The MXU route object (K6, then the float64 reduction) of each
    curve's base field, by label: its `events` time the reductions."""
    from snark_setup_tpu_torch.ops.cuda_routes import stacked_product_for
    from snark_setup_tpu_torch.ops.curve import curve_ops

    return {f"redc_cols_matmul[{c}]": stacked_product_for(curve_ops(c, "g1").field.fp.modulus).mxu
            for c in curves}


def reduction_ms(reducers: dict) -> dict:
    """Milliseconds between each reducer's (start, end) events, summed;
    the events are cleared."""
    out = {k: sum(a.elapsed_time(b) for a, b in m.events) for k, m in reducers.items() if m.events}
    for m in reducers.values():
        m.events = None
    return out


def route_phase(dev, curve: str, power: int, batch: int, switch: str, default_dir: str,
                wrappers: dict, reducers: dict | None = None) -> None:
    """`contribute` through the port's CLI under one route switch, on the
    challenge and seed that the default route's path left in `default_dir`:
    the response must equal that path's, byte for byte. `reducers`
    (`mxu_reducers`) also time the MXU route's reduction after K6."""
    import torch

    from snark_setup_tpu_torch.cli import phase1_main

    reducers = reducers or {}

    common = ["--curve-kind", curve, "--proving-system", "groth16", "--contribution-mode",
              "full", "--power", str(power), "--batch-size", str(batch), "--device", dev.type]
    src = lambda name: os.path.join(default_dir, name)
    for w in (*wrappers.values(), *reducers.values()):
        w.events = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_route_") as tmp, switched(switch):
        out = os.path.join(tmp, "response")
        t0 = time.perf_counter()
        phase1_main.execute(phase1_main.build_parser().parse_args([
            *common, "--seed", src("seed1"), "contribute", "--challenge-fname", src("challenge1"),
            "--challenge-hash-fname", os.path.join(tmp, "challenge.hash"), "--response-fname", out,
            "--response-hash-fname", os.path.join(tmp, "response.hash")]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with open(out, "rb") as f, open(src("response1"), "rb") as g:
            got, want = f.read(), g.read()
    if got != want:
        raise AssertionError(f"{curve} under {switch}: the response differs from the default route's")
    kernel_ms = {k: sum(a.elapsed_time(b) for a, b in w.events) for k, w in wrappers.items()}
    for w in wrappers.values():
        w.events = None
    red_ms = reduction_ms(reducers)
    emit({"phase": "route", "curve": curve, "switch": switch, "power": power, "batch_size": batch,
          "wall_seconds": secs, "response_bytes": len(got), "equal_to_default_route": True,
          "kernel_ms": kernel_ms, "kernel_seconds_total": sum(kernel_ms.values()) / 1e3,
          "reduction_ms": red_ms, "reduction_seconds_total": sum(red_ms.values()) / 1e3})


# lanes of the route scalar-muls: 16384 before the BLS12-381 and BLS12-377
# phase-2 paths joined the script; the MXU route's float64 reduction after
# K6 takes ~29 s of that path at 16384 lanes (the kernels' own rows are
# timed at BATCH in compare_routes)
ROUTE_SCALAR_MUL_BATCH = 4096
ROUTE_SCALAR_MULS = (  # (curve, group, route): the routes at the other limb count
    ("bls12_377", "g2", "k8"), ("mnt4_753", "g1", "k7"), ("mnt4_753", "g1", "k6"),
    ("mnt6_753", "g2", "k7"), ("mnt6_753", "g2", "k6"),
)


def route_scalar_mul_phase(dev, batch: int, wrappers: dict, reducers: dict | None = None) -> list[dict]:
    """The batch scalar-mul entry point under a route switch where the
    routes meet the other limb count: BLS12-377 G2 under KERNEL_V2 (K8 at
    NL 12: the endomorphism's beta planes), MNT4-753 G1 and MNT6-753 G2
    under KERNEL_V3 (K7 at NL 24) and MXU_STACKED (K6 at NL 24); host-oracle
    spot checks on four lanes each. `wrappers` maps a label to each kernel
    wrapper whose time inside each call is summed from its launch events
    (the labels with none are left out), `reducers` (`mxu_reducers`) the
    MXU route's reductions. Returns the phase's records."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops
    from snark_setup_tpu_torch.shard import runtime

    reducers = reducers or {}
    records = []
    for ci, (curve, group, route) in enumerate(ROUTE_SCALAR_MULS):
        ops = curve_ops(curve, group)
        rng = np.random.default_rng(SEED + 900 + ci)
        pts, scalars, ks, affine = make_inputs(ops, batch, rng, dev, edge=False, projective=False)
        for w in (*wrappers.values(), *reducers.values()):
            w.events = []
        try:
            with switched(ROUTES[route][0]):
                t0 = time.perf_counter()
                out = runtime.scalar_mul(ops, pts, scalars, dev)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            kernel_ms = {k: sum(a.elapsed_time(b) for a, b in w.events) for k, w in wrappers.items() if w.events}
            red_ms = reduction_ms(reducers)
        finally:
            for w in (*wrappers.values(), *reducers.values()):
                w.events = None
        lanes = [0, batch // 3, batch // 2, batch - 1]
        got = ops.to_affine_host(PointVec({k: v[..., lanes].contiguous() for k, v in out.items()}))
        for lane, pt in zip(lanes, got):
            if pt != ops.host_curve.mul(affine[lane], ks[lane]):
                raise AssertionError(f"scalar_mul {curve} {group} under {ROUTES[route][0]}: "
                                     f"lane {lane} differs from the host oracle")
        record = {"phase": "route", "config": f"scalar_mul {curve}/{group}", "switch": ROUTES[route][0],
                  "batch": batch, "seconds": secs, "oracle_lanes": lanes, "oracle_ok": True,
                  "kernel_ms": kernel_ms, "kernel_seconds_total": sum(kernel_ms.values()) / 1e3,
                  "reduction_ms": red_ms}
        emit(record)
        records.append(record)
    return records


def check_marlin_response(params, key, challenge: bytes, response: bytes, rng, label: str,
                          picks: int = 6) -> int:
    """Host-oracle check of a Marlin response: the hash chain;
    tau_g1[i] == input[i] * tau^i at the first, the last and `picks` random
    indices; every point of tau_g2 (1, tau, then the inverse degree-bound
    powers) and of alpha_g1 (alpha * (1, tau, tau^2, then f, f tau, f tau^2
    per degree bound f)), as the protocol defines them."""
    from snark_setup_tpu_torch.curves.host import g1_curve, g2_curve
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, UseCompression

    if response[:64] != hashlib.blake2b(challenge, digest_size=64).digest():
        raise AssertionError(f"{label}: response does not start with the challenge's hash")
    spec, r = params.spec, params.spec.r
    sec_in, sec_out = split(params, UseCompression.NO), split(params, UseCompression.YES)
    codecs = {"g1": (g1_codec(spec), g1_curve(spec)), "g2": (g2_codec(spec), g2_curve(spec))}
    tau = key.tau
    bounds = [pow(tau, params.powers_length - 1 - (1 << i) + 2, r) for i in range(params.total_size_in_log2)]
    alpha = [pow(tau, i, r) for i in range(3)]
    for f in bounds:
        alpha += [f, f * tau % r, f * tau * tau % r]
    n1 = sec_in["tau_g1"].num_elements
    wants = (
        ("tau_g1", "g1", {i: pow(tau, i, r) for i in {0, n1 - 1, *(int(i) for i in rng.integers(0, n1, picks))}}),
        ("tau_g2", "g2", dict(enumerate([1, tau % r] + [pow(b, -1, r) for b in bounds]))),
        ("alpha_g1", "g1", {i: k * key.alpha % r for i, k in enumerate(alpha)}),
    )
    checked = 0
    for name, group, exps in wants:
        codec, curve = codecs[group]
        if len(exps) > sec_out[name].num_elements:
            raise AssertionError(f"{label}: {name} holds {sec_out[name].num_elements} points, not {len(exps)}")
        for i, k in sorted(exps.items()):
            p_in = codec.deserialize(bytes(sec_in[name].slice_of(challenge, i, i + 1)),
                                     UseCompression.NO, CheckForCorrectness.NO)
            p_out = codec.deserialize(bytes(sec_out[name].slice_of(response, i, i + 1)),
                                      UseCompression.YES, CheckForCorrectness.NO)
            if p_out != curve.mul(p_in, k):
                raise AssertionError(f"{label}: {name}[{i}] differs from the host oracle")
            checked += 1
    return checked


def reencoded_checks(label: str, pairs, rng, picks: int = 6) -> int:
    """Host-oracle check that points were carried over unchanged: for each
    (name, group, source buffer, source sections, source compression,
    target buffer, target sections, target compression, offset), at the
    first, the last and `picks` random indices i of the target section, the
    target's point i is the source's point offset + i decoded and re-encoded
    by the host codec."""
    from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness

    checked = 0
    for name, spec, group, src, s_src, c_src, dst, s_dst, c_dst, off in pairs:
        codec = g1_codec(spec) if group == "g1" else g2_codec(spec)
        n = s_dst[name].num_elements
        if n == 0:
            continue
        for i in sorted({0, n - 1, *(int(i) for i in rng.integers(0, n, picks))}):
            p = codec.deserialize(bytes(s_src[name].slice_of(src, off + i, off + i + 1)), c_src,
                                  CheckForCorrectness.NO)
            if bytes(s_dst[name].slice_of(dst, i, i + 1)) != codec.serialize(p, c_dst):
                raise AssertionError(f"{label}: {name}[{i}] is not the source's point {off + i}")
            checked += 1
    return checked


MODE_SECTIONS = (("tau_g1", "g1"), ("tau_g2", "g2"), ("alpha_g1", "g1"), ("beta_g1", "g1"), ("beta_g2", "g2"))


def modes_phase(dev, mode: str, power: int, batch: int, workdir: str) -> None:
    """`new` + contributions through the port's CLI on BLS12-377 (G1 on
    K3 + K4, G2 on K3 + the group law over K5) in a mode the main paths do
    not take, then the coordinator's side of that mode:

    - `beacon` (the key from the beacon hash); its full compressed response
      stays in `workdir` for the chunked mode's `split`;
    - chunked: `contribute` to every chunk of 2^(power - 1) G1 powers (chunk
      0 and 1 with every section, the last tau_g1 only and ragged), chunked
      `verify-and-transform-pok-and-correctness` of chunks 1 and the last,
      `combine` (Phase1.aggregation) of all responses, `verify-and-
      transform-ratios` (Phase1.aggregate_verification) on the combined
      accumulator, `split` of the beacon's full response into chunks, and
      Phase1.decompress of that response: each split chunk equals its slice
      of the decompressed accumulator;
    - Marlin: `contribute` and `verify-and-transform-pok-and-correctness`
      (not `verify-and-transform-ratios`: its Marlin branch is 4 host ratio
      checks a degree bound, 48 at power 12, ~74 s on the host; the chunked
      mode's ratios run the device part of the same function).

    Every response is checked against the host oracle and the hash chain;
    every new challenge, combined, split and decompressed file against the
    host codec's decoding of its source at the first, the last and random
    indices, and every .hash file against the Blake2b of its file."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.cli import phase1_main
    from snark_setup_tpu_torch.phase1.buffers import Section, split
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.phase1.protocol import Phase1
    from snark_setup_tpu_torch.transcript.hashing import calculate_hash, derive_rng_from_seed
    from snark_setup_tpu_torch.utils.enums import (
        CheckForCorrectness, ContributionMode, ProvingSystem, UseCompression,
    )

    curve = "bls12_377"
    NO, YES = UseCompression.NO, UseCompression.YES
    system = ProvingSystem.MARLIN if mode == "marlin" else ProvingSystem.GROTH16
    chunk_size = 1 << (power - 1)
    full = Phase1Parameters.new_full(curve, system, power, batch)
    spec = full.spec
    n_chunks = -(-full.powers_g1_length // chunk_size) if mode == "chunked" else 1
    rng = np.random.default_rng(SEED + 250)
    seed = hashlib.sha256(f"chip_smoke {mode} seed".encode()).digest()
    mdir = os.path.join(workdir, mode)
    os.makedirs(mdir)
    path = lambda name: os.path.join(mdir, name)
    blake = lambda data: hashlib.blake2b(data, digest_size=64).digest()
    with open(path("seed"), "w") as f:
        f.write(seed.hex())

    def read(name) -> bytes:
        with open(path(name), "rb") as f:
            return f.read()

    def flags(index):
        common = ["--curve-kind", curve, "--proving-system", system.value, "--power", str(power),
                  "--batch-size", str(batch), "--device", dev.type]
        if index is None:
            return common + ["--contribution-mode", "full"]
        return common + ["--contribution-mode", "chunked", "--chunk-size", str(chunk_size)] + (
            ["--chunk-index", str(index)] if index >= 0 else [])

    def cli(index, *args) -> float:
        t0 = time.perf_counter()
        phase1_main.execute(phase1_main.build_parser().parse_args([*flags(index), *args]))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def params_of(index):
        if index is None:
            return full
        return Phase1Parameters.new_chunk(curve, ContributionMode.CHUNKED, index, chunk_size, system, power, batch)

    indices = list(range(n_chunks)) if mode == "chunked" else [None]
    for index in indices:
        params, tag = params_of(index), "" if index is None else f"_{index}"
        cli(index, "new", "--challenge-fname", path(f"challenge{tag}"), "--challenge-hash-fname",
            path(f"challenge{tag}.hash"))
        files = ["--challenge-fname", path(f"challenge{tag}"), "--challenge-hash-fname", path(f"challenge{tag}.hash"),
                 "--response-fname", path(f"response{tag}"), "--response-hash-fname", path(f"response{tag}.hash")]
        if mode == "beacon":
            secs = cli(index, "beacon", *files, "--beacon-hash", seed.hex())
        else:
            secs = cli(index, "--seed", path("seed"), "contribute", *files)
        challenge, response = read(f"challenge{tag}"), read(f"response{tag}")
        if read(f"response{tag}.hash") != calculate_hash(response):
            raise AssertionError(f"{curve} {mode}: response{tag}.hash is not the response's hash")
        _, key = Phase1.key_generation(spec, derive_rng_from_seed(seed), calculate_hash(challenge))
        label = f"{curve} {mode}" + ("" if index is None else f" chunk {index}")
        check = check_marlin_response if system is ProvingSystem.MARLIN else check_response
        checked = check(params, key, challenge, response, rng, label)
        emit({"phase": "mode", "curve": curve, "mode": mode, "proving_system": system.value, "power": power,
              "batch_size": batch, "chunk_index": index, "chunk_size": chunk_size if index is not None else None,
              "wall_seconds": secs, "response_bytes": len(response), "oracle_points_checked": checked,
              "hash_chain_ok": True})
    if mode == "beacon":
        return

    # the coordinator's side: verification of single contributions
    for index in ([1, n_chunks - 1] if mode == "chunked" else [None]):
        params, tag = params_of(index), "" if index is None else f"_{index}"
        secs = cli(index, "verify-and-transform-pok-and-correctness", "--challenge-fname", path(f"challenge{tag}"),
                   "--challenge-hash-fname", path(f"challenge{tag}.verified.hash"),
                   "--response-fname", path(f"response{tag}"),
                   "--response-hash-fname", path(f"response{tag}.verified.hash"),
                   "--new-challenge-fname", path(f"new_challenge{tag}"),
                   "--new-challenge-hash-fname", path(f"new_challenge{tag}.verified.hash"))
        challenge, response, new = read(f"challenge{tag}"), read(f"response{tag}"), read(f"new_challenge{tag}")
        if not (new[:64] == blake(response) and read(f"challenge{tag}.verified.hash") == blake(challenge)
                and read(f"response{tag}.verified.hash") == blake(response)
                and read(f"new_challenge{tag}.verified.hash") == blake(new)):
            raise AssertionError(f"{curve} {mode} verify{tag}: hash chain or .hash files wrong")
        s_resp, s_new = split(params, YES), split(params, NO)
        checked = reencoded_checks(f"{curve} {mode} verify{tag}",
                                   [(n, spec, g, response, s_resp, YES, new, s_new, NO, 0) for n, g in MODE_SECTIONS
                                    # beta_g2 is carried over by chunk 0 only
                                    if n in s_resp and (n != "beta_g2" or not index)], rng)
        emit({"phase": "mode verify", "curve": curve, "mode": mode, "chunk_index": index, "wall_seconds": secs,
              "hash_chain_ok": True, "host_points_checked": checked})
    if mode == "marlin":
        return

    # chunked: combine (aggregation), ratios on the combined accumulator
    with open(path("response_list"), "w") as f:
        f.write("".join(path(f"response_{i}") + "\n" for i in range(n_chunks)))
    secs = cli(-1, "combine", "--response-list-fname", path("response_list"), "--combined-fname", path("combined"))
    combined, s_comb = read("combined"), split(full, NO)
    pairs = []
    for i in range(n_chunks):
        s_chunk = split(params_of(i), YES)
        for n, g in MODE_SECTIONS:
            if n == "beta_g2":
                continue
            lo = i * chunk_size
            hi = min(lo + s_chunk[n].num_elements, s_comb[n].num_elements)
            if hi <= lo:
                continue
            # the combined accumulator's slice of this chunk
            size = s_comb[n].element_size
            pairs.append((n, spec, g, read(f"response_{i}"), s_chunk, YES, combined,
                          {n: Section(s_comb[n].offset + lo * size, hi - lo, size)}, NO, 0))
    checked = reencoded_checks(f"{curve} combine", pairs, rng)
    t_ratios = cli(None, "verify-and-transform-ratios", "--response-fname", path("combined"))
    emit({"phase": "mode combine", "curve": curve, "chunks": n_chunks, "wall_seconds": secs,
          "combined_bytes": len(combined), "host_points_checked": checked, "ratios_wall_seconds": t_ratios,
          "ratios_accepted": True})

    # split the beacon's full response into chunks, and decompress it
    beacon = os.path.join(workdir, "beacon", "response")
    secs = cli(-1, "split", "--chunk-fname-prefix", path("chunk_split"), "--full-fname", beacon)
    with open(beacon, "rb") as f:
        response = f.read()
    decompressed = bytearray(full.get_length(NO))
    t0 = time.perf_counter()
    Phase1.decompress(response, decompressed, CheckForCorrectness.FULL, full, device=dev)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    s_resp, s_dec = split(full, YES), split(full, NO)
    checked = reencoded_checks(f"{curve} decompress", [(n, spec, g, response, s_resp, YES, decompressed, s_dec, NO, 0)
                                                       for n, g in MODE_SECTIONS], rng)
    for i in range(n_chunks):
        part, s_part = read(f"chunk_split_{i}"), split(params_of(i), NO)
        for n, _g in MODE_SECTIONS:
            m = s_part[n].num_elements
            lo = 0 if n == "beta_g2" else i * chunk_size
            if m and bytes(s_part[n].slice_of(part)) != bytes(s_dec[n].slice_of(decompressed, lo, lo + m)):
                raise AssertionError(f"{curve} split: chunk {i} {n} is not its slice of the decompressed response")
    emit({"phase": "mode split", "curve": curve, "chunks": n_chunks, "split_wall_seconds": secs,
          "decompress_wall_seconds": t_dec, "host_points_checked": checked, "chunks_equal_decompressed": True})


def ceremony_phase(dev, workdir: str) -> None:
    """The ceremony driver's `chunked` plan (scripts/torch_ceremony.py: the
    steps and flags of scripts/phase1_chunked.sh) at the upstream CI's size,
    BW6-761 at power 10, batch = chunk = 512: per chunk two participants
    alternating contribute / verify-and-transform, combine, beacon, full
    verification, ratios, split and the second round over the split chunks,
    each step through its CLI's `main(argv)` in this process. The driver
    checks every `.hash` file and four lanes of every response against the
    host oracle; here every verification's new challenge also starts with
    the Blake2b-512 of its response."""
    import importlib.util
    import io

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("torch_ceremony", os.path.join(here, "scripts", "torch_ceremony.py"))
    driver = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = driver
    spec.loader.exec_module(driver)
    curve, power, batch, chunk = CEREMONY
    cfg = driver.Config("chunked", curve, power, batch, chunk, device=dev.type)
    os.makedirs(workdir)
    driver.write_seeds(workdir, SEED, resume=False)
    steps = driver.plan(cfg)
    t0 = time.perf_counter()
    records = driver.run(cfg, steps, workdir, inprocess=True, out=io.StringIO())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chained = 0
    for step in steps:
        if "verify-and-transform-pok-and-correctness" in step.argv:
            (_, _), (resp, _), (new, _) = step.hashes
            with open(os.path.join(workdir, new), "rb") as f:
                if f.read(64) != driver.blake2b_file(os.path.join(workdir, resp)):
                    raise AssertionError(f"ceremony {step.label}: {new} does not start with the hash of {resp}")
            chained += 1
    kinds = {}
    for r in records:  # labels such as "split chunk 1 verify 2": the first kind named
        kind = next(k for k in ("new", "contribute", "verify", "beacon", "combine", "ratios", "split")
                    if k in r["step"].split())
        kinds[kind] = kinds.get(kind, 0.0) + r["wall_seconds"]
    emit({"phase": "ceremony", "profile": "chunked", "curve": "bw6_761", "power": power, "batch_size": batch,
          "chunk_size": chunk, "steps": len(records), "wall_seconds": wall,
          "seconds_by_kind": kinds, "slowest": max(records, key=lambda r: r["wall_seconds"])["step"],
          "hash_files_checked": sum(r["hash_checks"] for r in records),
          "oracle_points_checked": sum(r.get("oracle_points", 0) for r in records),
          "new_challenges_chained": chained,
          "ratios_accepted": sum(r["step"].startswith("ratios") for r in records)})


def ladder_widths_phase(dev, rows: list) -> None:
    """The ladder kernel K4 at every width its main path launched (from the
    wrapper's `widths` count of that path) and at 1 lane, by its launch
    events, beside the bound at that width: the rows gain `lanes_ms`."""
    import numpy as np

    from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for
    from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops

    for ci, r in enumerate(x for x in rows if x["name"].startswith("glv_ladder[")):
        curve, group = r["name"][len("glv_ladder["):-1].split("/")
        ops, lad, dig = curve_ops(curve, group), r["_wrapper"], glv_digits_for(curve, group)
        widths = sorted({1, *r["launches_by_width"]})
        rng = np.random.default_rng(SEED + 600 + ci)
        pts, scalars, _, _ = make_inputs(ops, max(widths), rng, dev, edge=False, projective=False)
        digits = dig(scalars)
        lanes = {}
        for w in widths:
            pw = PointVec({k: v[:, :w].contiguous() for k, v in pts.items()})
            dw = [d[..., :w].contiguous() for d in digits]
            b_ms, b_by = bound(*kernel_work(ops, dig, lad, w)["glv_ladder"])
            lanes[w] = {"ms": launch_ms(lad, lambda: lad(pw, *dw), 5), "bound_ms": b_ms, "bound_by": b_by}
        r["lanes_ms"] = lanes
        emit({"phase": "ladder widths", "config": f"{curve}/{group}", "path": r["_path"],
              "launches_by_width": r["launches_by_width"], "lanes_ms": lanes})


def out_of_subgroup_g1(spec):
    """The smallest-x point of G1's curve outside the order-r subgroup
    (found as tests/test_subgroup.py finds it)."""
    from snark_setup_tpu_torch.curves.host import g1_curve

    hc = g1_curve(spec)
    for x in range(1, 2000):
        p = hc.get_point_from_x(spec.fp(x), greatest=False)
        if p is not None and not hc.in_subgroup(p):
            return p
    raise AssertionError("no out-of-subgroup point found")


def verify_phase(dev, curve: str, power: int, batch: int, workdir: str, rejections: tuple,
                 wrappers: dict, picks: int = 16) -> None:
    """The coordinator's side through the port's CLI, on the challenge1 /
    response1 that `contribute_phase` left in `workdir`:
    `verify-and-transform-pok-and-correctness` with the default checks
    (FULL output check, AUTO subgroup mode) must accept, the new challenge
    must carry the hash chain and hold, at the first, the last and `picks`
    random indices of every section, the response's points decoded and
    re-encoded uncompressed by the host codec; `verify-and-transform-ratios`
    on the new challenge must accept. Then each of `rejections` — a bad
    response, built from response1 — must be rejected with a
    VerificationFailedError whose cause is the named check's exception."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.cli import phase1_main
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu_torch.utils import pipeline
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, ProvingSystem, UseCompression
    from snark_setup_tpu_torch.utils.errors import (
        IncorrectSubgroupError, InvalidRatioError, VerificationFailedError,
    )

    common = ["--curve-kind", curve, "--proving-system", "groth16", "--contribution-mode",
              "full", "--power", str(power), "--batch-size", str(batch), "--device", dev.type]
    params = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, power, batch)
    spec = params.spec
    path = lambda name: os.path.join(workdir, name)
    blake = lambda data: hashlib.blake2b(data, digest_size=64).digest()

    def read(name) -> bytes:
        with open(path(name), "rb") as f:
            return f.read()

    def cli(*args) -> float:
        t0 = time.perf_counter()
        phase1_main.execute(phase1_main.build_parser().parse_args([*common, *args]))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def verify(response: str, new: str, *extra) -> float:
        return cli(*extra, "verify-and-transform-pok-and-correctness",
                   "--challenge-fname", path("challenge1"),
                   "--challenge-hash-fname", path(f"{new}.challenge.verified.hash"),
                   "--response-fname", path(response),
                   "--response-hash-fname", path(f"{new}.response.verified.hash"),
                   "--new-challenge-fname", path(new),
                   "--new-challenge-hash-fname", path(f"{new}.verified.hash"))

    for w in wrappers.values():
        w.events = []
    with pipeline.recording() as pipes:
        secs = verify("response1", "new_challenge1")
    kernel_ms = {k: sum(a.elapsed_time(b) for a, b in w.events) for k, w in wrappers.items()}
    pipeline_line(f"{curve} verify", pipes, secs, sum(kernel_ms.values()) / 1e3)
    challenge, response, new = read("challenge1"), read("response1"), read("new_challenge1")
    hashes_ok = (
        new[:64] == blake(response)
        and read("new_challenge1.challenge.verified.hash") == blake(challenge)
        and read("new_challenge1.response.verified.hash") == blake(response)
        and read("new_challenge1.verified.hash") == blake(new)
    )
    if not hashes_ok:
        raise AssertionError(f"{curve} verify: hash chain or .hash files wrong")
    # host spot checks: new challenge point == response point re-encoded
    rng = np.random.default_rng(SEED + 700)
    s_resp, s_new = split(params, UseCompression.YES), split(params, UseCompression.NO)
    checked = 0
    for name, codec in (("tau_g1", g1_codec(spec)), ("tau_g2", g2_codec(spec)), ("alpha_g1", g1_codec(spec)),
                        ("beta_g1", g1_codec(spec)), ("beta_g2", g2_codec(spec))):
        n = s_resp[name].num_elements
        for i in sorted({0, n - 1, *(int(i) for i in rng.integers(0, n, picks))}):
            p = codec.deserialize(bytes(s_resp[name].slice_of(response, i, i + 1)),
                                  UseCompression.YES, CheckForCorrectness.NO)
            if bytes(s_new[name].slice_of(new, i, i + 1)) != codec.serialize(p, UseCompression.NO):
                raise AssertionError(f"{curve} verify: new challenge {name}[{i}] differs from the host codec")
            checked += 1
    n_points = sum(s.num_elements for s in s_resp.values())
    for w in wrappers.values():
        w.events = None
    t_ratios = cli("verify-and-transform-ratios", "--response-fname", path("new_challenge1"))
    emit({"phase": "verify", "curve": curve, "power": power, "batch_size": batch, "points": n_points,
          "response_bytes": len(response), "wall_seconds": secs, "points_per_s": n_points / secs,
          "kernel_ms": kernel_ms, "kernel_seconds_total": sum(kernel_ms.values()) / 1e3,
          "hash_chain_ok": True, "host_points_checked": checked, "ratios_wall_seconds": t_ratios,
          "ratios_points_per_s": n_points / t_ratios})

    # the bad responses, each rejected by the check it targets
    comp1 = g1_codec(spec)
    size = s_resp["tau_g1"].element_size
    expected = {
        "swap": (InvalidRatioError, "Power pairs tau_g1"),
        "out_of_subgroup": (IncorrectSubgroupError, "batched subgroup check failed"),
        "out_of_subgroup_direct": (IncorrectSubgroupError, "element not in prime-order subgroup"),
    }
    for kind in rejections:
        bad = bytearray(response)
        sec = s_resp["tau_g1"]
        if kind == "swap":
            i = min(100, sec.num_elements - 2)
            a = bytes(sec.slice_of(bad, i, i + 1))
            sec.slice_of(bad, i, i + 1)[:] = bytes(sec.slice_of(bad, i + 1, i + 2))
            sec.slice_of(bad, i + 1, i + 2)[:] = a
        else:
            j = min(200, sec.num_elements - 1)
            pt = comp1.serialize(out_of_subgroup_g1(spec), UseCompression.YES)
            assert len(pt) == size
            sec.slice_of(bad, j, j + 1)[:] = pt
        with open(path(f"bad_{kind}"), "wb") as f:
            f.write(bad)
        extra = ("--subgroup-check-mode", "direct") if kind == "out_of_subgroup_direct" else ()
        cls, words = expected[kind]
        t0 = time.perf_counter()
        try:
            verify(f"bad_{kind}", f"bad_new_{kind}", *extra)
        except VerificationFailedError as e:
            cause = e.__cause__
            if not isinstance(cause, cls) or words not in str(cause):
                raise AssertionError(f"{curve} {kind}: rejected by {type(cause).__name__}: {cause}") from e
        else:
            raise AssertionError(f"{curve} {kind}: the bad response was accepted")
        emit({"phase": "verify", "curve": curve, "rejection": kind, "rejected": True,
              "cause": f"{type(cause).__name__}: {cause}", "seconds": time.perf_counter() - t0})


def two_fault_phase(dev) -> None:
    """A BLS12-377 response (power 2, batch 4, built on the host) with a
    point outside the subgroup at tau_g1[2] and a point at infinity at
    tau_g2[2]: `verification` must raise the read's PointAtInfinityError on
    the card, as on the CPU and in the reference, whose subgroup check of
    the first section runs after the next two sections' reads. Run after
    the paths: its CPU leg runs plain versions."""
    import random

    from snark_setup_tpu_torch.phase1.keys import PublicKey
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.phase1.protocol import Phase1
    from snark_setup_tpu_torch.phase1.testing import generate_output, two_fault_response
    from snark_setup_tpu_torch.utils.enums import (
        CheckForCorrectness, ProvingSystem, SubgroupCheckMode, UseCompression,
    )

    t = two_fault_response("verification")
    params = Phase1Parameters.new_full("bls12_377", ProvingSystem.GROTH16, 2, 4)
    raised, seconds = {}, {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        try:
            Phase1.verification(t["input"], t["output"], generate_output(params, UseCompression.NO),
                                PublicKey.deserialize(params.spec, t["key"]), t["digest"],
                                UseCompression.NO, UseCompression.YES, UseCompression.NO,
                                CheckForCorrectness.NO, CheckForCorrectness.FULL, SubgroupCheckMode.AUTO, True,
                                params, rlc_rng=random.Random(7), device=where)
        except Exception as e:  # the class is what is checked
            raised[str(where)] = type(e).__name__
        else:
            raise AssertionError(f"two faults: accepted on {where}")
        seconds[str(where)] = time.perf_counter() - t0
    if set(raised.values()) != {"PointAtInfinityError"}:
        raise AssertionError(f"two faults: rejected by {raised}")
    emit({"phase": "two faults", "curve": "bls12_377", "power": 2, "batch_size": 4,
          "faults": ["tau_g1[2] outside the subgroup", "tau_g2[2] at infinity"], "raised": raised,
          "seconds": seconds})


def pipeline_line(path: str, runs: list, wall: float, kernel_seconds: float) -> None:
    """One line per path: each pipeline's depth, the most finishes pending
    at once, its pushes and the host seconds inside its finishes, beside
    the step's wall and kernel seconds."""
    emit({"phase": "pipeline", "path": path, "wall_seconds": wall, "kernel_seconds": kernel_seconds,
          "device_busy_share": kernel_seconds / wall if wall else None,
          "pipelines": [{k: r[k] for k in ("name", "depth", "high_water", "pushes", "finish_seconds")}
                        for r in runs]})


def contribution_hashes(spec, data: bytes, count: int) -> list[bytes]:
    """Blake2b of each of the last `count` public keys of an MPC parameter
    file (they end it, after a u32 big-endian count)."""
    from snark_setup_tpu_torch.phase2.keypair import Phase2PublicKey

    size = Phase2PublicKey.size(spec)
    start = len(data) - count * size
    if int.from_bytes(data[start - 4 : start], "big") != count:
        raise AssertionError(f"expected {count} contributions")
    return [hashlib.blake2b(data[start + i * size : start + (i + 1) * size], digest_size=64).digest()
            for i in range(count)]


@contextlib.contextmanager
def stage_timer(stages: dict, targets: dict):
    """Time every call of each (object, attribute) in `targets` (name ->
    (object, attribute)), a synchronize on both sides, summing seconds into
    stages[name]; nested calls count in both."""
    import torch

    saved = []
    for name, (obj, attr) in targets.items():
        fn = getattr(obj, attr)
        saved.append((obj, attr, obj.__dict__.get(attr, None), attr in obj.__dict__))

        def timed(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                stages[_name] = stages.get(_name, 0.0) + time.perf_counter() - t0

        setattr(obj, attr, timed)
    try:
        yield stages
    finally:
        for obj, attr, old, had in reversed(saved):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)


def phase2_breakdown_targets() -> dict:
    from snark_setup_tpu_torch.ntt.group_fft import GroupFFT
    from snark_setup_tpu_torch.ops.codec import BatchPointCodec
    from snark_setup_tpu_torch.ops.curve import CurveOps

    return {
        "table build (host twiddles, copy to the card; first use)": (GroupFFT, "tables"),
        "reads: read_batch (host parse + to Montgomery [+ sqrt, checks])": (BatchPointCodec, "read_batch"),
        "write-back: write_batch_start (normalize + from_mont + flags + copy)": (BatchPointCodec,
                                                                                 "write_batch_start"),
        "of write-back: normalize (inversion tree + the inversion kernel at its root)": (CurveOps, "normalize"),
        "host conversion: write_batch_finish (byte packing)": (BatchPointCodec, "write_batch_finish"),
        "host conversion: from_affine_host": (CurveOps, "from_affine_host"),
        "host conversion: to_affine_host (host Z inversion)": (CurveOps, "to_affine_host"),
    }


def phase2_phase(dev, curve: str, power: int, batch: int, src_dir: str, wrappers: dict, part: str,
                 reject_l: bool = True, participants: int = 1) -> None:
    """The Groth16 phase-2 ceremony on `curve` through the port's CLIs, from
    the verified power-`power` phase-1 challenge that the curve's verify
    path left in `src_dir` (new_challenge1), in the flow of
    scripts/phase1_chunked_prepare_phase2.sh and scripts/phase2_chunked.sh.

    part "sha256": the SHA-256 preimage circuit (`circuit_main create
    --complex`: 43163 constraints, domain 2^16); prepare_phase2 at
    --phase2-size 2^16, `new` in 2 chunks, per chunk `participants` (1, or
    2 in turns: the second verified against the first's new challenge)
    contribute and verify, `combine`. With `reject_l`, a response to chunk 0
    with one L point replaced by another subgroup point must be rejected by
    the L ratio check (in either part). Checks: each
    .hash file is the Blake2b of its file; in the prepared transcript the
    Lagrange sums (one device sum_reduce each, compared on the host):
    sum coeffs_g1 = G1, sum coeffs_g2 = G2, sum alpha_coeffs_g1 = alpha G1,
    sum beta_coeffs_g1 = beta G1, sum omega^j coeffs_g1[j] = tau G1; h_g1[i]
    = tau^(i+m) G1 - tau^i G1 at a few i on the host; the combined file's
    contributions are the participants'.

    part "prover": the x^2 circuit, prepared from the same transcript at its
    domain, new -> contribute -> verify -> combine -> `circuit_main test` on
    combined.params; then a proof from those params verifies for the true
    public input and not for a wrong one (host pairings).

    One JSON line per CLI step (wall seconds, kernel seconds from each
    launch's events), a breakdown line for prepare and for new."""
    import torch

    from snark_setup_tpu_torch.cli import circuit_main, phase2_main, prepare_phase2_main
    from snark_setup_tpu_torch.curves.constants import get_curve
    from snark_setup_tpu_torch.curves.host import g1_curve, g2_curve
    from snark_setup_tpu_torch.ntt.domain import Radix2Domain
    from snark_setup_tpu_torch.ops.codec import batch_codec
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.phase2 import groth16
    from snark_setup_tpu_torch.phase2.parameters import ProvingKey
    from snark_setup_tpu_torch.phase2.r1cs import TestCircuit
    from snark_setup_tpu_torch.phase2.vecio import Cursor, skip_vec
    from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu_torch.transcript.hashing import derive_rng_from_seed
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, ProvingSystem, UseCompression
    from snark_setup_tpu_torch.utils.errors import InvalidRatioError

    spec = get_curve(curve)
    kind = "bw6" if curve == "bw6_761" else curve  # the CLIs' --curve-kind
    h1, h2 = g1_codec(spec), g2_codec(spec)
    blake = lambda data: hashlib.blake2b(data, digest_size=64).digest()
    phase1 = os.path.join(src_dir, "new_challenge1")
    work = os.path.join(src_dir, f"phase2_{part}")
    os.makedirs(work)
    path = lambda name: os.path.join(work, name)

    def read(name) -> bytes:
        with open(path(name), "rb") as f:
            return f.read()

    def step(name, fn, *args, stages=None):
        """One CLI step in `work`: wall seconds and kernel seconds."""
        for w in wrappers.values():
            w.events = []
        cwd = os.getcwd()
        os.chdir(work)
        try:
            with stage_timer(stages if stages is not None else {},
                             phase2_breakdown_targets() if stages is not None else {}):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = fn(list(args))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        kernel_ms = {k: sum(s.elapsed_time(e) for s, e in w.events) for k, w in wrappers.items()}
        for w in wrappers.values():
            w.events = None
        if rc not in (0, None):
            raise AssertionError(f"phase2 {curve} {part}: {name} exited {rc}")
        emit({"phase": "phase2", "curve": curve, "part": part, "step": name, "wall_seconds": secs,
              "kernel_ms": {k: v for k, v in kernel_ms.items() if v},
              "kernel_seconds_total": sum(kernel_ms.values()) / 1e3})
        return kernel_ms, secs

    p2 = lambda argv: phase2_main.execute(phase2_main.build_parser().parse_args(argv))
    for tag in ("1", "2"):
        with open(path(f"seed{tag}"), "w") as f:
            f.write(hashlib.sha256(f"chip_smoke phase2 seed {tag}".encode()).hexdigest())

    # -- circuit, prepare ---------------------------------------------------
    complex_ = part == "sha256"
    step("circuit create", circuit_main.main, "create", "--curve-kind", kind, *(["--complex"] if complex_ else []))
    from snark_setup_tpu_torch.phase2.load_circuit import Matrices

    matrices = Matrices.read(spec, read(f"testcircuit_{kind}"))
    size = max(matrices.num_constraints, matrices.num_witness_variables + matrices.num_instance_variables)
    m = Radix2Domain(curve, size).size
    if m > 1 << power:
        raise AssertionError(f"phase2 {curve} {part}: domain {m} needs a phase-1 power of at least {m.bit_length()}")
    prep_stages = {}
    prep_kernels, prep_secs = step(
        "prepare_phase2", prepare_phase2_main.main, "--curve-kind", kind, "--power", str(power),
        "--batch-size", str(batch), "--phase2-size", str(m), "--phase2-fname", "phase2_transcript",
        "--response-fname", phase1, "--device", dev.type, stages=prep_stages)
    emit({"phase": "breakdown", "config": f"{curve} prepare_phase2, domain {m}", "wall_seconds": prep_secs,
          "seconds": prep_stages | {f"kernel {k}": v / 1e3 for k, v in prep_kernels.items() if v}})

    # -- the prepared transcript against the phase-1 one --------------------
    p1 = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, power, batch)
    s1 = split(p1, UseCompression.NO)
    with open(phase1, "rb") as f:
        ch = f.read()
    pt = read("phase2_transcript")
    g1size, g2size = h1.size(UseCompression.NO), h2.size(UseCompression.NO)
    off = {"coeffs_g1": 2 * g1size + g2size}
    off["coeffs_g2"] = off["coeffs_g1"] + m * g1size
    off["alpha_coeffs_g1"] = off["coeffs_g2"] + m * g2size
    off["beta_coeffs_g1"] = off["alpha_coeffs_g1"] + m * g1size
    off["h_g1"] = off["beta_coeffs_g1"] + m * g1size
    if len(pt) != off["h_g1"] + (m - 1) * g1size:
        raise AssertionError(f"phase2 {curve} {part}: transcript length {len(pt)}")
    one = lambda sec, i, codec: codec.deserialize(bytes(s1[sec].slice_of(ch, i, i + 1)), UseCompression.NO,
                                                   CheckForCorrectness.NO)
    G1, G2 = g1_curve(spec).generator, g2_curve(spec).generator
    expect = {"coeffs_g1": G1, "coeffs_g2": G2, "alpha_coeffs_g1": one("alpha_g1", 0, h1),
              "beta_coeffs_g1": one("beta_g1", 0, h1)}
    sums = {}
    for name, want in expect.items():
        codec = batch_codec(curve, "g2" if name == "coeffs_g2" else "g1", dev)
        esize = g2size if name == "coeffs_g2" else g1size
        pts = codec.read_batch(pt[off[name] : off[name] + m * esize], UseCompression.NO)
        got = codec.ops.to_affine_host(codec.ops.sum_reduce(pts))[0]
        if got != want:
            raise AssertionError(f"phase2 {curve} {part}: the Lagrange sum of {name} is wrong")
        sums[name] = True
        if name == "coeffs_g1":
            dom = Radix2Domain(curve, m)
            from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch

            powers = dom.elements()
            sc = codec.ops.fr.tensor(ints_to_limbs_batch(powers, codec.ops.fr.L).T, dev)
            got = codec.ops.to_affine_host(codec.ops.sum_reduce(codec.ops.scalar_mul(pts, sc)))[0]
            if got != one("tau_g1", 1, h1):
                raise AssertionError(f"phase2 {curve} {part}: sum omega^j coeffs_g1[j] != tau G1")
            sums["omega_weighted_coeffs_g1"] = True
    hc = g1_curve(spec)
    h_checked = []
    for i in sorted({0, 1, m // 2, m - 2}):
        h = h1.deserialize(pt[off["h_g1"] + i * g1size : off["h_g1"] + (i + 1) * g1size], UseCompression.NO,
                           CheckForCorrectness.NO)
        if h != hc.add(one("tau_g1", i + m, h1), hc.neg(one("tau_g1", i, h1))):
            raise AssertionError(f"phase2 {curve} {part}: h_g1[{i}] != tau^(i+m) G1 - tau^i G1")
        h_checked.append(i)

    # -- new, contributions, verification, combine --------------------------
    chunk = PHASE2_CHUNK if complex_ else m
    common = ["--curve-kind", kind, "--batch-size", str(batch), "--contribution-mode", "chunked",
              "--chunk-size", str(chunk), "--device", dev.type]
    new_stages = {}
    new_kernels, new_secs = step(
        "new", p2, *common, "new", "--challenge-fname", "challenge", "--challenge-hash-fname",
        "challenge.verified.hash", "--challenge-list-fname", "new_challenge_list", "--phase1-fname",
        "phase2_transcript", "--circuit-fname", f"testcircuit_{kind}", stages=new_stages)
    emit({"phase": "breakdown", "config": f"{curve} phase2 new, domain {m}, chunk {chunk}",
          "wall_seconds": new_secs,
          "seconds": new_stages | {f"kernel {k}": v / 1e3 for k, v in new_kernels.items() if v}})
    hash_files = {"challenge.verified.hash": "challenge.full"}
    chunks = read("new_challenge_list").decode().split()
    responses = []
    for i, name in enumerate(chunks):
        # every chunk takes the same contributions: one participant takes
        # all chunks, two take them in either order
        first, second = ("1", "2") if i % 2 == 0 or participants == 1 else ("2", "1")
        for who, chal, resp, ver in ((first, name, f"response_{i}", f"verified_{i}"),
                                     (second, f"verified_{i}", f"new_response_{i}",
                                      f"verified2_{i}"))[:participants]:
            step(f"contribute chunk {i} participant {who}", p2, *common, "--chunk-index", str(i), "--seed",
                 f"seed{who}", "contribute", "--challenge-fname", os.path.basename(chal),
                 "--challenge-hash-fname", f"{chal}.hash", "--response-fname", resp,
                 "--response-hash-fname", f"{resp}.hash")
            step(f"verify chunk {i} participant {who}", p2, *common, "--chunk-index", str(i), "verify",
                 "--challenge-fname", chal, "--challenge-hash-fname", f"{chal}.verified.hash",
                 "--response-fname", resp, "--response-hash-fname", f"{resp}.verified.hash",
                 "--new-challenge-fname", ver, "--new-challenge-hash-fname", f"{ver}.verified.hash")
            hash_files |= {f"{chal}.hash": chal, f"{resp}.hash": resp, f"{chal}.verified.hash": chal,
                           f"{resp}.verified.hash": resp, f"{ver}.verified.hash": ver}
        responses.append(resp)
        if i == 0 and reject_l:
            # one L point replaced by another subgroup point: the L ratio
            # check must reject the response
            bad = bytearray(read("response_0"))
            cur = Cursor(bad)
            # the layout: vk (alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc_g1),
            # beta_g1, delta_g1, a, b_g1, b_g2, h, l
            cur.skip(h1.size(UseCompression.YES) + 3 * h2.size(UseCompression.YES))
            skip_vec(spec, "g1", cur, UseCompression.YES)
            cur.skip(2 * h1.size(UseCompression.YES))
            for g in ("g1", "g1", "g2", "g1"):
                skip_vec(spec, g, cur, UseCompression.YES)
            n_l = cur.u64()
            j = min(100, n_l - 1)
            at = cur.pos + j * h1.size(UseCompression.YES)
            bad[at : at + h1.size(UseCompression.YES)] = h1.serialize(hc.mul(G1, 12345), UseCompression.YES)
            with open(path("bad_response_0"), "wb") as f:
                f.write(bad)
            t0 = time.perf_counter()
            try:
                step("verify bad response (one L point replaced)", p2, *common, "--chunk-index", "0", "verify",
                     "--challenge-fname", "challenge.0", "--response-fname", "bad_response_0",
                     "--new-challenge-fname", "bad_verified_0", "--challenge-hash-fname", "bad.c.hash",
                     "--response-hash-fname", "bad.r.hash", "--new-challenge-hash-fname", "bad.n.hash")
            except InvalidRatioError as e:
                if "L_query ratio check failed" not in str(e):
                    raise AssertionError(f"phase2 {curve}: bad response rejected by another check: {e}") from e
                emit({"phase": "phase2", "curve": curve, "part": part, "rejection": "L point replaced",
                      "rejected": True,
                      "cause": f"{type(e).__name__}: {e}", "seconds": time.perf_counter() - t0})
            else:
                raise AssertionError(f"phase2 {curve}: the bad response was accepted")
    with open(path("response_list"), "w") as f:
        f.write("\n".join(responses) + "\n")
    step("combine", p2, *common, "combine", "--response-list-fname", "response_list", "--initial-query-fname",
         "challenge.query", "--initial-full-fname", "challenge.full", "--combined-fname", "combined")
    for hfile, target in hash_files.items():
        if read(hfile) != blake(read(target)):
            raise AssertionError(f"phase2 {curve} {part}: {hfile} is not the Blake2b of {target}")
    combined = read("combined")
    if contribution_hashes(spec, combined, participants) != contribution_hashes(spec, read(responses[0]),
                                                                              participants):
        raise AssertionError(f"phase2 {curve} {part}: the combined contributions are not the participants'")

    result = {"phase": "phase2", "curve": curve, "part": part, "domain": m, "constraints": matrices.num_constraints,
              "variables": matrices.num_instance_variables + matrices.num_witness_variables,
              "nnz": [matrices.a_num_non_zero, matrices.b_num_non_zero, matrices.c_num_non_zero],
              "chunks": len(chunks), "lagrange_sums_ok": sums, "h_checked": h_checked,
              "hash_files_ok": len(hash_files), "combined_contributions_ok": True}
    if not complex_:
        step("circuit test (prove + verify)", circuit_main.main, "test", "--curve-kind", kind,
             "--proving-key-path", "combined.params", "--device", dev.type)
        pk = ProvingKey.read(spec, Cursor(read("combined.params")), UseCompression.NO, CheckForCorrectness.NO,
                             device=dev)
        proof = groth16.prove(spec, pk, TestCircuit(5), derive_rng_from_seed(b"\x09" * 32), dev)
        if not groth16.verify(spec, pk.vk, proof, [25]) or groth16.verify(spec, pk.vk, proof, [26]):
            raise AssertionError(f"phase2 {curve} prover: the proof is not accepted for 25 and rejected for 26")
        result |= {"proof_verifies": True, "wrong_input_rejected": True}
    emit(result)


def phase2_chunked_phase(dev, batch: int, bw6_dir: str, wrappers: dict) -> None:
    """The streaming phase 2 (`phase2/chunked.py`) on the files the `bw6_761
    phase2` path left (the SHA-256 circuit, domain 2^16): chunk 0's
    uncompressed challenge (its 2^15 h points and all 29860 L points; chunk
    1 holds no L point), the combined file and challenge.full.

    - chunked `contribute` in place with participant 1's seed: its hash is
      the one of participant 1's CLI response to chunk 0, and its bytes are
      the object API's (MPCParameters.read, contribute with the same rng,
      write uncompressed);
    - chunked `verify(challenge.0, that buffer)` accepts and returns that
      hash; with one L point replaced by another subgroup point it raises
      "L_query ratio check failed";
    - chunked `verify(challenge.full, combined)` accepts and returns
      combine's list (the Blake2b of each public key of the combined file).

    K3 and K4 must launch in `contribute`, K2 in each verify. One JSON line
    a step: wall seconds, kernel seconds from each launch's events, and a
    breakdown of the host's share (reads, write-back, host points)."""
    import torch

    from snark_setup_tpu_torch.curves.constants import get_curve
    from snark_setup_tpu_torch.curves.host import g1_curve
    from snark_setup_tpu_torch.phase2 import chunked
    from snark_setup_tpu_torch.phase2.keypair import Phase2PublicKey
    from snark_setup_tpu_torch.phase2.parameters import MPCParameters
    from snark_setup_tpu_torch.serialize.arkworks import g1_codec
    from snark_setup_tpu_torch.transcript.hashing import derive_rng_from_seed
    from snark_setup_tpu_torch.utils import pipeline
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, UseCompression
    from snark_setup_tpu_torch.utils.errors import InvalidRatioError

    spec = get_curve("bw6_761")
    NO, FULL = UseCompression.NO, CheckForCorrectness.FULL
    work = os.path.join(bw6_dir, "phase2_sha256")

    def read(name) -> bytes:
        with open(os.path.join(work, name), "rb") as f:
            return f.read()

    with open(os.path.join(work, "seed1")) as f:
        seed = bytes.fromhex(f.read().strip())
    challenge = read("challenge.0")
    steps = {}

    def step(name, fn, must_launch=(), breakdown=True):
        """`breakdown`: time the stages, a synchronize around each (which
        stops the write-back pipeline from overlapping anything)."""
        for w in wrappers.values():
            w.events = []
        stages = {}
        timer = stage_timer(stages, phase2_breakdown_targets()) if breakdown else contextlib.nullcontext()
        with timer, pipeline.recording() as pipes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        kernel_ms = {k: sum(a.elapsed_time(b) for a, b in w.events) for k, w in wrappers.items()}
        launches = {k: len(w.events) for k, w in wrappers.items() if w.events}
        for w in wrappers.values():
            w.events = None
        for label in must_launch:  # the path's launch counts are checked in main() as well
            if label in wrappers and not launches.get(label):
                raise AssertionError(f"phase2 chunked: {label} was not launched in {name}")
        kernel_s = sum(kernel_ms.values()) / 1e3
        if not breakdown:
            pipeline_line(f"phase2 chunked {name}", pipes, secs, kernel_s)
        steps[name] = {"wall_seconds": secs, "kernel_seconds": kernel_s}
        emit({"phase": "phase2 chunked", "step": name, "wall_seconds": secs,
              "kernel_ms": {k: v for k, v in kernel_ms.items() if v}, "launches": launches,
              "kernel_seconds_total": kernel_s, "seconds": stages,
              "host_seconds": secs - kernel_s})
        return out

    g1 = ("glv_digits[bw6_761/g1]", "glv_ladder[bw6_761/g1]")
    k2 = ("group_add[bw6_761/g1]", "group_dbl[bw6_761/g1]")
    buf = bytearray(challenge) + bytes(Phase2PublicKey.size(spec))
    h = step("contribute (chunk 0, in place)", lambda: chunked.contribute(
        spec, buf, derive_rng_from_seed(seed), batch, NO, FULL, device=dev), g1, breakdown=False)
    if h != contribution_hashes(spec, read("response_0"), 1)[0]:
        raise AssertionError("phase2 chunked: the hash is not participant 1's from the CLI")
    want = step("object API: read + contribute + write (chunk 0)", lambda: (
        lambda m: (m.contribute(derive_rng_from_seed(seed), dev), m.write(NO, dev))[1])(
        MPCParameters.read(spec, challenge, NO, CheckForCorrectness.NO, device=dev)))
    if bytes(buf) != want:
        raise AssertionError("phase2 chunked: contribute's bytes differ from the object API's")
    hashes = step("verify (chunk 0)", lambda: chunked.verify(spec, challenge, buf, batch, NO, FULL, device=dev), k2)
    if hashes != [h]:
        raise AssertionError("phase2 chunked: verify returned another hash list")
    _, _, spans, _ = chunked._layout(spec, buf, NO)
    bad = bytearray(buf)
    at = spans["l"].offset + min(100, spans["l"].count - 1) * spans["l"].el_size
    bad[at : at + spans["l"].el_size] = g1_codec(spec).serialize(g1_curve(spec).mul(g1_curve(spec).generator, 12345),
                                                                 NO)
    t0 = time.perf_counter()
    try:
        step("verify of the bad buffer (one L point replaced)",
             lambda: chunked.verify(spec, challenge, bad, batch, NO, FULL, device=dev))
    except InvalidRatioError as e:
        if "L_query ratio check failed" not in str(e):
            raise AssertionError(f"phase2 chunked: bad buffer rejected by another check: {e}") from e
        emit({"phase": "phase2 chunked", "rejection": "L point replaced", "rejected": True,
              "cause": f"{type(e).__name__}: {e}", "seconds": time.perf_counter() - t0})
    else:
        raise AssertionError("phase2 chunked: the bad buffer was accepted")
    combined = read("combined")
    hashes = step("verify (challenge.full -> combined)", lambda: chunked.verify(
        spec, read("challenge.full"), combined, batch, NO, FULL, device=dev), k2)
    if hashes != contribution_hashes(spec, combined, 1):  # the SHA-256 path's one participant
        raise AssertionError("phase2 chunked: the combined file's hash list is not combine's")
    emit({"phase": "phase2 chunked", "h_points": spans["h"].count, "l_points": spans["l"].count,
          "bytes_equal_object_api": True, "hash_equals_cli": True, "combined_hashes_equal": True, "steps": steps})


def mesh_phase(dev) -> None:
    """The device mesh (shard/mesh.py) on a mesh of two entries of the one
    card: `sharded_step_fn` on BLS12-377 G1 at BATCH lanes and at a ragged
    BATCH + 1 (padded to a multiple of the mesh), and
    `sharded_group_ifft_fn` on BW6-761 G1 at MESH_IFFT_POINTS (2^14), each equal to the
    single-device result: the products and the IFFT limb for limb, the MSM
    total as a point. Inputs are seeded multiples of the generator made on
    the card. No time is claimed: both shards share one card."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
    from snark_setup_tpu_torch.ntt.group_fft import group_fft
    from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops
    from snark_setup_tpu_torch.shard.mesh import make_mesh, sharded_group_ifft_fn, sharded_step_fn

    mesh = make_mesh(devices=[dev, dev])
    rng = np.random.default_rng(SEED + 900)

    def points(ops, n):
        r = ops.spec.r
        ks = [int.from_bytes(rng.bytes(64), "little") % r for _ in range(n)]
        g = ops.from_affine_host([ops.host_curve.generator], dev)
        gs = PointVec({k: v.expand(*v.shape[:-1], n).contiguous() for k, v in g.items()})
        return ops.scalar_mul(gs, ops.fr.tensor(ints_to_limbs_batch(ks, ops.fr.L).T, dev))

    same = lambda a, b: all(torch.equal(a[k], b[k]) for k in ("x", "y", "z"))
    result = {"phase": "mesh", "mesh": [str(d) for d in mesh.devices]}
    ops = curve_ops("bls12_377", "g1")
    for n in (BATCH, BATCH + 1):
        pts = points(ops, n)
        sc = ops.fr.tensor(ints_to_limbs_batch([int.from_bytes(rng.bytes(48), "little") % ops.spec.r
                                                for _ in range(n)], ops.fr.L).T, dev)
        prods, total = sharded_step_fn(ops, mesh)(pts, sc)
        single = ops.scalar_mul(pts, sc)
        if not same(prods, single):
            raise AssertionError(f"mesh: sharded_step_fn's products at {n} lanes differ from one device's")
        if ops.to_affine_host(total) != ops.to_affine_host(ops.sum_reduce(single)):
            raise AssertionError(f"mesh: sharded_step_fn's total at {n} lanes differs from one device's")
        result[f"step_bls12_377_g1_{n}"] = "equal"
    ops = curve_ops("bw6_761", "g1")
    n = MESH_IFFT_POINTS
    pts = points(ops, n)
    want = group_fft("bw6_761", "g1", n).ifft(pts)
    if not same(sharded_group_ifft_fn("bw6_761", "g1", n, mesh)(pts), want):
        raise AssertionError("mesh: the sharded IFFT differs from one device's")
    result[f"ifft_bw6_761_g1_{n}"] = "equal"
    torch.cuda.synchronize()
    emit(result)


def portable_phase(dev, bw6_dir: str) -> None:
    """The portable contributor (`portable/contributor.py`, pure host Python)
    on the prover gate's x^2 challenge (BW6-761, domain 8) that the `bw6_761
    prover` path left: `contribute_challenge` with a fixed seed on the host,
    then the port's `MPCParameters.verify` on the card accepts the response,
    and its last hash is the one returned."""
    import random

    import torch

    from snark_setup_tpu_torch.curves.constants import get_curve
    from snark_setup_tpu_torch.phase2.parameters import MPCParameters
    from snark_setup_tpu_torch.portable import contribute_challenge
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, UseCompression

    spec = get_curve("bw6_761")
    with open(os.path.join(bw6_dir, "phase2_prover", "challenge.0"), "rb") as f:
        challenge = f.read()
    t0 = time.perf_counter()
    response, h = contribute_challenge(challenge, "outer", seed=hashlib.sha256(b"chip_smoke portable").digest())
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    before = MPCParameters.read(spec, challenge, UseCompression.NO, CheckForCorrectness.NO, device=dev)
    after = MPCParameters.read(spec, response, UseCompression.YES, CheckForCorrectness.FULL, device=dev)
    hashes = before.verify(after, rlc_rng=random.Random(SEED), device=dev)
    torch.cuda.synchronize()
    if hashes[-1] != h:
        raise AssertionError("portable: the verified hash is not the contributor's")
    emit({"phase": "portable", "curve": "bw6_761", "challenge_bytes": len(challenge), "response_bytes": len(response),
          "host_contribute_seconds": t_host, "verify_seconds": time.perf_counter() - t0, "verified": True,
          "hash_equal": True})


def verify_breakdown_phase(dev, power: int, batch: int, workdir: str) -> None:
    """One batch of the BW6-761 verify loop (tau_g1[0 : batch + 1] of the
    path's response), stage by stage, each ended with a synchronize."""
    import random

    import numpy as np
    import torch

    from snark_setup_tpu_torch.curves.pairing import pairing_engine
    from snark_setup_tpu_torch.ops.codec import batch_codec
    from snark_setup_tpu_torch.ops.msm import rlc_scalars_padded
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.phase1.protocol import (
        SUBGROUP_BATCH_ROUNDS, _batched_subgroup_sums, _power_pairs_finish, _power_pairs_start,
    )
    from snark_setup_tpu_torch.serialize.arkworks import g2_codec
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, ProvingSystem, UseCompression

    params = Phase1Parameters.new_full("bw6_761", ProvingSystem.GROTH16, power, batch)
    spec = params.spec
    with open(os.path.join(workdir, "response1"), "rb") as f:
        response = f.read()
    sec = split(params, UseCompression.YES)
    n = batch + 1
    data = bytes(sec["tau_g1"].slice_of(response, 0, n))
    h2 = g2_codec(spec)
    g2_check = tuple(h2.deserialize(bytes(sec["tau_g2"].slice_of(response, i, i + 1)), UseCompression.YES,
                                    CheckForCorrectness.NO) for i in (0, 1))
    codec = batch_codec("bw6_761", "g1", dev)
    ops = codec.ops
    eng = pairing_engine("bw6_761")
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    pts = timed("read_batch: host parse + decompression (the square-root kernel)",
                lambda: codec.read_batch(data, UseCompression.YES, CheckForCorrectness.ONLY_NON_ZERO))
    bits = (np.frombuffer(np.random.default_rng(SEED + 710).bytes(SUBGROUP_BATCH_ROUNDS * n), np.uint8)
            .reshape(SUBGROUP_BATCH_ROUNDS, n) & 1).astype(bool)
    sums = timed("subgroup: 64 random-subset sums (K2 tree)", lambda: _batched_subgroup_sums(ops, pts, bits))
    ok = timed("subgroup: Direct check [r]Q == O of the 64 sums (K2 ladder)",
               lambda: bool((codec.subgroup_mask(sums) | ops.is_infinity(sums)).all()))
    if not ok:
        raise AssertionError("verify breakdown: the batch failed its subgroup check")
    scalars = rlc_scalars_padded(n - 1, n - 1, rng=random.Random(SEED))
    pp = timed("power pairs: two Pippenger MSMs (K2)", lambda: _power_pairs_start(ops, pts, scalars))
    s_pt, sx_pt = timed("power pairs: to host affine", lambda: _power_pairs_finish(ops, pp))
    timed("host pairing check (check_same_ratio)",
          lambda: eng.check_same_ratio((s_pt, sx_pt), g2_check, "Power pairs tau_g1"))
    timed("write-back: from_mont + flags + copy + byte packing",
          lambda: codec.write_batch(pts, UseCompression.NO, normalized=True))
    emit({"phase": "breakdown", "config": "bw6_761 verify batch (tau_g1)", "batch": n, "seconds": stages,
          "total_seconds": sum(stages.values())})


def breakdown_phase(dev, batch: int) -> None:
    """One batch of the contribute loop on BW6-761 G1, stage by stage, each
    ended with a synchronize: where a batch's wall time goes by layer."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.codec import batch_codec
    from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for
    from snark_setup_tpu_torch.ops.cuda_ladder import fused_ladder_for
    from snark_setup_tpu_torch.phase1.protocol import _tau_powers_raw
    from snark_setup_tpu_torch.utils.enums import UseCompression

    codec = batch_codec("bw6_761", "g1", dev)
    ops = codec.ops
    rng = np.random.default_rng(SEED + 300)
    pts, _, _, _ = make_inputs(ops, batch, rng, dev, edge=False, projective=False)
    data = codec.write_batch(pts, UseCompression.NO, normalized=True)
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    p = timed("read_batch (host parse + to Montgomery, plain torch)",
              lambda: codec.read_batch(data, UseCompression.NO))
    raw = timed("tau powers (plain torch)",
                lambda: _tau_powers_raw(ops.fr, 0x1234567 << 200, batch, 2 * batch, None, dev))
    dg = timed("K3 glv_digits", lambda: glv_digits_for("bw6_761", "g1")(raw))
    prod = timed("K4 glv_ladder", lambda: fused_ladder_for("bw6_761", "g1")(p, *dg))
    h = timed("write_batch_start: normalize + from_mont + sign flags + device->host copy (plain torch)",
              lambda: codec.write_batch_start(prod))
    timed("write_batch_finish: host byte packing", lambda: codec.write_batch_finish(h, UseCompression.YES))
    timed("of write_batch_start: normalize = inversion tree + the inversion kernel at its root",
          lambda: ops.normalize(prod))
    timed("of normalize: the root's inversion alone (inversion kernel), width 1", lambda: ops.fq.inv(prod["z"][:, :1]))

    # how many PyTorch operators one width-1 field product dispatches: the
    # unit the inversion's chain of products pays per step
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            CountOps.n += 1
            return func(*args, **(kwargs or {}))

    one = prod["z"][:, :1].contiguous()
    with CountOps():
        ops.fq.mont_mul(one, one)
    emit({"phase": "breakdown", "config": "bw6_761/g1", "batch": batch, "seconds": stages,
          "torch_ops_per_width1_mont_mul": CountOps.n,
          "mont_muls_per_inversion": bin(ops.spec.q - 2).count("1") + (ops.spec.q - 2).bit_length() - 2})


def g2_breakdown_phase(dev, batch: int) -> None:
    """One batch of the contribute loop on BLS12-377 G2 (Fp2 coordinates),
    stage by stage, each ended with a synchronize; the window loop's time is
    split into the stacked-product kernel's (CUDA events) and the eager
    PyTorch glue around it."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops.codec import batch_codec
    from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for
    from snark_setup_tpu_torch.phase1.protocol import _tau_powers_raw
    from snark_setup_tpu_torch.utils.enums import UseCompression

    codec = batch_codec("bls12_377", "g2", dev)
    ops, F = codec.ops, codec.F
    K = stacked_mul_for(ops.spec.q)
    rng = np.random.default_rng(SEED + 310)
    pts, _, _, _ = make_inputs(ops, batch, rng, dev, edge=False, projective=False)
    data = codec.write_batch(pts, UseCompression.NO, normalized=True)
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    p = timed("read_batch (host parse + to Montgomery)", lambda: codec.read_batch(data, UseCompression.NO))
    raw = timed("tau powers (plain torch)",
                lambda: _tau_powers_raw(ops.fr, 0x1234567 << 200, batch, 2 * batch, None, dev))
    d1, d2, neg1, flip = timed("K3 glv_digits", lambda: glv_digits_for("bls12_377", "g2")(raw))
    neg1, flip = neg1.bool(), flip.bool()

    def tables():
        t1 = ops._window_table(ops.select(neg1, ops.neg(p), p))
        t2 = {"x": ops._fq_mul_planes(t1["x"], ops.beta_np, ("beta_np", "bls12_377", "g2")),
              "y": F.select(flip, F.neg(t1["y"]), t1["y"]), "z": t1["z"]}
        return t1, t2

    n0 = K.launches
    t1, t2 = timed("table build: 1 doubling + 13 additions + beta planes (K5 + glue)", tables)
    table_launches = K.launches - n0

    def loop():
        acc = ops.infinity((batch,), dev)
        for k in range(d1.shape[0]):
            acc = ops._window_doubles(acc, ops.WINDOW)
            acc = ops.add(acc, ops._select_entry(t1, d1[k]))
            acc = ops.add(acc, ops._select_entry(t2, d2[k]))
        return acc

    K.events, n0 = [], K.launches
    prod = timed("window loop: 4 doublings + 2 additions per window (K5 + glue)", loop)
    loop_k5 = sum(s_.elapsed_time(e) for s_, e in K.events) / 1e3
    loop_launches = K.launches - n0
    K.events = []
    timed("normalize: inversion tree (K5 products) + the inversion kernel at its root", lambda: ops.normalize(prod))
    norm_k5 = sum(s_.elapsed_time(e) for s_, e in K.events) / 1e3
    K.events = None
    h = timed("write_batch_start: normalize + from_mont + sign flags + device->host copy",
              lambda: codec.write_batch_start(prod))
    timed("write_batch_finish: host byte packing", lambda: codec.write_batch_finish(h, UseCompression.YES))
    loop_s = stages["window loop: 4 doublings + 2 additions per window (K5 + glue)"]
    emit({"phase": "breakdown", "config": "bls12_377/g2", "batch": batch, "seconds": stages,
          "windows": int(d1.shape[0]), "k5_launches": {"table": table_launches, "window_loop": loop_launches},
          "window_loop_split": {"k5_seconds": loop_k5, "glue_seconds": loop_s - loop_k5},
          "normalize_k5_seconds": norm_k5})


def sweep_phase(dev) -> None:
    """Optional: the ladder kernel at batch 2^12 .. 2^17, lanes per second."""
    import numpy as np

    from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for
    from snark_setup_tpu_torch.ops.cuda_ladder import fused_ladder_for
    from snark_setup_tpu_torch.ops.curve import curve_ops

    for ci, (curve, group) in enumerate((("bw6_761", "g1"), ("bls12_377", "g1"))):
        ops = curve_ops(curve, group)
        dig, lad = glv_digits_for(curve, group), fused_ladder_for(curve, group)
        rng = np.random.default_rng(SEED + 400 + ci)
        for log_b in range(12, 18):
            B = 1 << log_b
            pts, scalars, _, _ = make_inputs(ops, B, rng, dev, edge=False, projective=False)
            digits = dig(scalars)
            ms = event_ms(lambda: lad(pts, *digits), 3)
            emit({"phase": "sweep", "config": f"{curve}/{group}", "batch": B, "ladder_ms": ms,
                  "lanes_per_s": B / ms * 1e3})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--power", type=int, default=16,
                    help="log2 size of the BW6-761 and BLS12-377 contribute phases, the BW6-761 "
                         "verify path and the phase-2 paths' phase-1 transcript (>= 14)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the ladder kernel at batch 2^12 .. 2^17")
    args = ap.parse_args()
    if args.power < 14:
        ap.error("--power must be at least 14")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script needs the card",
              file=sys.stderr)
        return 2
    # import the port before anything is printed: run without the package
    # beside it, the script fails here and prints no result
    from snark_setup_tpu_torch.ops import build
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for
    from snark_setup_tpu_torch.ops.curve import curve_ops

    # the default paths run on K5: no route switch from the caller's
    # environment reaches them (the route paths set their own)
    for switch, *_ in ROUTES.values():
        os.environ.pop(switch, None)
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    libs = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": sorted(libs),
          "ptxas": {t: [l.strip() for l in log.splitlines() if "registers" in l or "stack frame" in l][:4]
                    for t, log in build.build_logs.items()}})

    with torch.no_grad(), tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        rows = (compare_kernels(dev, BATCH) + compare_stacked_mul(dev, BATCH) + compare_sqrt(dev, BATCH)
                + compare_inv(dev) + compare_routes(dev, BATCH) + compare_group_ops(dev, BATCH))
        emit({"phase": "kernel comparisons done", "seconds": time.perf_counter() - t_start})
        # K5 of BW6-761's Fq: no row of its own since the square root left it
        watched = {"stacked_mul[bw6_761]": stacked_mul_for(curve_ops("bw6_761", "g1").fq.modulus)}
        wrappers = {id(w): w for w in (*(r["_wrapper"] for r in rows), *watched.values())}.values()
        # the kernels of the phase-2 paths (both groups of BW6-761 on Fq;
        # BLS12-377's G1 kernels and K3 + K5 for its G2): their kernel
        # seconds are summed per CLI step
        phase2_wrappers = {r["_label"]: r["_wrapper"] for r in rows
                           if r["_label"].startswith(("glv_", "group_")) and "bw6_761" in r["_label"]}
        bls_phase2_wrappers = {r["_label"]: r["_wrapper"] for r in rows if r["_label"] in BLS_PHASE2_KERNELS}

        def labelled(curve):
            """The wrappers whose kernels a contribution on `curve` launches."""
            return {r["_label"]: r["_wrapper"] for r in rows
                    if curve in r["_label"] and not r["_path"].endswith("verify") and not r.get("_route")}

        def on_path(path, *also):
            """The wrappers of a verify path's rows (and of the `also` rows)."""
            return {r["_label"]: r["_wrapper"] for r in rows if r["_path"] in (path, *also)}

        dirs = {name: os.path.join(work, name) for name in ("bw6_761", "bls12_377", "bls12_381", "mnt4_753",
                                                            "modes")}
        for d in dirs.values():
            os.makedirs(d)
        bw6_dir, bls_dir = dirs["bw6_761"], dirs["bls12_377"]
        # the main paths: every count to 0 just before each, read just after
        paths = (
            ("bw6_761", lambda: (scalar_mul_phase(dev, BATCH),
                                 contribute_phase(dev, "bw6_761", args.power, BATCH, labelled("bw6_761"),
                                                  contributions=2, workdir=bw6_dir))),
            ("bls12_377", lambda: contribute_phase(dev, "bls12_377", args.power, BATCH, labelled("bls12_377"))),
            ("mnt4_753", lambda: contribute_phase(dev, "mnt4_753", MNT_POWER, BATCH,
                                                  labelled("mnt4_753"), picks=2, workdir=dirs["mnt4_753"])),
            ("mnt6_753", lambda: contribute_phase(dev, "mnt6_753", MNT_POWER, BATCH,
                                                  labelled("mnt6_753"), picks=2)),
            ("bw6_761 verify", lambda: verify_phase(
                dev, "bw6_761", args.power, BATCH, bw6_dir,
                ("swap", "out_of_subgroup", "out_of_subgroup_direct"), on_path("bw6_761 verify"))),
            ("bls12_377 verify", lambda: (
                contribute_phase(dev, "bls12_377", BLS_VERIFY_POWER, BATCH, {}, picks=2, workdir=bls_dir),
                verify_phase(dev, "bls12_377", BLS_VERIFY_POWER, BATCH, bls_dir, ("swap",),
                             on_path("bls12_377 verify", "bls12_377")))),
            # BLS12-381 (K3 on both groups, K4 and K2 on G1, K5 for G2 over
            # Fp2 and the square root): a contribution, then its verification
            ("bls12_381", lambda: contribute_phase(dev, "bls12_381", BLS_VERIFY_POWER, BATCH, labelled("bls12_381"),
                                                   picks=2, workdir=dirs["bls12_381"])),
            ("bls12_381 verify", lambda: verify_phase(dev, "bls12_381", BLS_VERIFY_POWER, BATCH, dirs["bls12_381"],
                                                      ("swap", "out_of_subgroup"), on_path("bls12_381 verify"))),
            # the opt-in routes: the default paths' challenges and seeds under
            # each switch, the response byte-identical to the default route's
            # (BLS12-377 at BLS_VERIFY_POWER, on the verify path's
            # contribution: the phase-2 paths need the time)
            ("bls12_377 v3", lambda: route_phase(dev, "bls12_377", BLS_VERIFY_POWER, BATCH, ROUTES["k7"][0],
                                                 bls_dir, on_path("bls12_377 v3"))),
            ("bls12_377 mxu", lambda: route_phase(dev, "bls12_377", BLS_VERIFY_POWER, BATCH, ROUTES["k6"][0],
                                                  bls_dir, on_path("bls12_377 mxu"),
                                                  mxu_reducers(("bls12_377",)))),
            ("mnt4_753 v2", lambda: route_phase(dev, "mnt4_753", MNT_POWER, BATCH, ROUTES["k8"][0],
                                                dirs["mnt4_753"], on_path("mnt4_753 v2", "mnt4_753"))),
            ("route scalar-muls", lambda: route_scalar_mul_phase(
                dev, ROUTE_SCALAR_MUL_BATCH, {r["_label"]: r["_wrapper"] for r in rows},
                mxu_reducers(("mnt4_753", "mnt6_753")))),
            # the ladder's other modes on BLS12-377 (K3 + K4 on G1, K3 on G2)
            # and their coordinator's side (the beacon's response is split)
            ("bls12_377 beacon", lambda: modes_phase(dev, "beacon", MODES_POWER, BATCH, dirs["modes"])),
            ("bls12_377 chunked", lambda: modes_phase(dev, "chunked", MODES_POWER, BATCH, dirs["modes"])),
            ("bls12_377 marlin", lambda: modes_phase(dev, "marlin", MODES_POWER, BATCH, dirs["modes"])),
            # the ceremony driver's chunked plan at the upstream CI's size
            (CEREMONY_PATH, lambda: ceremony_phase(dev, os.path.join(work, "ceremony"))),
            # phase 2 on BW6-761 from the verify path's new challenge: the
            # SHA-256 circuit's ceremony, then the prover gate
            ("bw6_761 phase2", lambda: phase2_phase(dev, "bw6_761", args.power, BATCH, bw6_dir, phase2_wrappers,
                                                    "sha256")),
            ("bw6_761 prover", lambda: phase2_phase(dev, "bw6_761", args.power, BATCH, bw6_dir, phase2_wrappers,
                                                    "prover", reject_l=False)),
            # phase 2 on BLS12-377, the phase-2 CLI's default curve: the
            # prover gate from the `bls12_377 verify` path's new challenge
            ("bls12_377 phase2", lambda: phase2_phase(dev, "bls12_377", BLS_VERIFY_POWER, BATCH, bls_dir,
                                                      bls_phase2_wrappers, "prover")),
            # the streaming phase 2 on the SHA-256 path's files, the device
            # mesh over two entries of the card, the portable contributor on
            # the prover gate's challenge
            (CHUNKED_PATH, lambda: phase2_chunked_phase(dev, BATCH, bw6_dir, phase2_wrappers)),
            ("mesh", lambda: mesh_phase(dev)),
            ("portable", lambda: portable_phase(dev, bw6_dir)),
        )
        if args.power < 16:  # the SHA-256 circuit's domain is 2^16
            paths = tuple(p for p in paths if p[0] not in ("bw6_761 phase2", CHUNKED_PATH))
            emit({"phase": "phase2", "part": "sha256", "skipped": "its domain 2^16 needs --power 16"})
        # kernels that must launch on a path besides the rows it owns
        also = {p: ("glv_digits[bls12_377/g1]", "glv_ladder[bls12_377/g1]", "glv_digits[bls12_377/g2]")
                for p in ("bls12_377 beacon", "bls12_377 chunked", "bls12_377 marlin")}
        also |= {p: PHASE2_KERNELS + ("group_dbl[bw6_761/g1]",) for p in PHASE2_PATHS if p.startswith("bw6_761")}
        also["bls12_377 phase2"] = BLS_PHASE2_KERNELS
        also[CHUNKED_PATH] = ("glv_digits[bw6_761/g1]", "glv_ladder[bw6_761/g1]", "group_add[bw6_761/g1]",
                              "group_dbl[bw6_761/g1]")
        also["mesh"] = ("glv_digits[bls12_377/g1]", "glv_ladder[bls12_377/g1]", "group_add[bls12_377/g1]",
                        "glv_digits[bw6_761/g1]", "glv_ladder[bw6_761/g1]", "group_add[bw6_761/g1]")
        also["portable"] = ("group_add[bw6_761/g1]", "group_dbl[bw6_761/g1]")
        also[CEREMONY_PATH] = (*PHASE2_KERNELS, "group_dbl[bw6_761/g1]", "group_dbl[bw6_761/g2]",
                               "fq_sqrt[bw6_761]", "fq_inv[bw6_761]")
        # K5 on the verify paths that still launch it: G2 over Fp2 (group law
        # and subgroup checks), the square root over Fq being its own kernel
        also["bls12_377 verify"] = ("stacked_mul[bls12_377]",)
        also["bls12_381 verify"] = ("stacked_mul[bls12_381]",)
        for curve, run in paths:
            for w in wrappers:
                w.launches = 0
                w.plain_calls = 0
                for counter in ("widths", "shapes"):
                    if hasattr(w, counter):
                        getattr(w, counter).clear()
            t0 = time.perf_counter()
            run()
            for w in wrappers:
                if w.plain_calls != 0:
                    raise AssertionError(f"a plain version ran on the {curve} path")
            for r in rows:
                if r["_path"] == curve:
                    r["launches"] = r["_wrapper"].launches
                    r["plain_calls"] = r["_wrapper"].plain_calls
                    if hasattr(r["_wrapper"], "widths"):
                        r["launches_by_width"] = dict(sorted(r["_wrapper"].widths.items()))
                    if "_shape" in r:  # this row's shape, and every shape of its wrapper on the path
                        r["launches_of_shape"] = r["_wrapper"].shapes[r["_shape"]]
                        r["launches_by_shape"] = dict(sorted(r["_wrapper"].shapes.items()))
                    if r["launches"] <= 0:
                        raise AssertionError(f"{r['name']} was never launched on the {curve} path")
            launched = {r["_label"]: r["_wrapper"].launches for r in rows if r["_label"] in also.get(curve, ())}
            for label, n in launched.items():
                if n <= 0:
                    raise AssertionError(f"{label} was never launched on the {curve} path")
            if curve in (*PHASE2_PATHS, CHUNKED_PATH):
                counted = bls_phase2_wrappers if curve.startswith("bls12_377") else phase2_wrappers
                for r in rows:
                    if r["_wrapper"] in counted.values():
                        r.setdefault("phase2_launches", {})[curve] = r["_wrapper"].launches
            emit({"phase": "path", "curve": curve, "seconds": time.perf_counter() - t0,
                  "launches": {r["name"]: r["launches"] for r in rows if r["_path"] == curve} | launched,
                  "watched_launches": {k: w.launches for k, w in watched.items()}})
        ladder_widths_phase(dev, rows)
        two_fault_phase(dev)
        for r in rows:
            del r["_wrapper"], r["_label"]
            r.pop("_route", None)
            r.pop("_shape", None)
            r["path"] = r.pop("_path")
            r["max_abs_diff"] = r["max_abs_err"]  # the name the repo's records use
        breakdown_phase(dev, BATCH)
        g2_breakdown_phase(dev, BATCH)
        verify_breakdown_phase(dev, args.power, BATCH, bw6_dir)
        if args.sweep:
            sweep_phase(dev)

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
