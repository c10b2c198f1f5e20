#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (snark_setup_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py [--power 16] [--sweep]

It builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card (exact equality —
this is modular arithmetic, tolerance 0), drives the port's main path
(`phase1 new` + `phase1 contribute` on BW6-761 through the port's CLI entry
point, plus the batch scalar-mul on BLS12-377 G1 and BW6-761 G1) and checks
the results against the host oracle (Python-int curve arithmetic).

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
There is no single PyTorch call that computes either function, so
`library_ms` is null. The last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

With `--sweep` it also times the ladder kernel at batch 2^12 .. 2^17 (how far
one thread per lane fills the card at the batch sizes a ceremony uses).

Any failed build, launch, comparison or oracle check raises: the script then
exits non-zero without printing the result lines. Without a CUDA device it
exits with code 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
SEED = 20240607
BATCH = 16384  # lanes per batch on the main path (the size bench.py uses)
CONFIGS = (("bw6_761", "g1"), ("bw6_761", "g2"), ("bls12_377", "g1"))
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


def max_abs_diff(a, b) -> int:
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max()) if a.numel() else 0


def make_inputs(ops, B: int, rng, dev, edge: bool, projective: bool):
    """Seeded inputs for one (curve, group): (points, raw scalars, scalar
    ints, affine host points per lane). With `edge`, lanes 0..2 carry the
    scalars 0, 1, r-1 and lanes 5, 21, ... the point at infinity."""
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
        affine16[5] = INFINITY
    scalars = ops.fr.tensor(ints_to_limbs_batch(ks, ops.fr.L).T, dev)
    p16 = ops.from_affine_host(affine16, dev)
    if projective:
        # hand the kernel Z != 1 inputs: 2P on the device, 2P on the host
        p16 = ops.double(p16)
        affine16 = [p if p.is_infinity else hc.double(p) for p in affine16]
    idx = torch.arange(B, device=dev) % 16
    pts = PointVec({k: v[:, idx].contiguous() for k, v in p16.items()})
    return pts, scalars, ks, [affine16[i % 16] for i in range(B)]


def kernel_work(ops, dig, lad, B: int) -> dict:
    """Bytes and integer multiply-adds of one launch of each kernel at
    batch B, from the shapes alone."""
    g = ops.glv
    L, NL, Ls, nwin = lad.L, lad.NL, dig.Ls, dig.nwin
    # digits: k x mu products and c x coeff products on 16-bit limbs
    terms = [t for t in (*g.k1_terms, *g.k2_terms) if t is not None]
    dig_ops = B * (sum(Ls * len(m) for m in g.mu) + sum(g.Lc * len(t[1]) for t in terms))
    dig_bytes = 4 * B * (Ls + 2 * nwin + 2)
    # ladder: 32x32->64 multiply-adds, one operation each:
    #   product = 2 NL^2 (product + reduction), shared-reduction pair = 3 NL^2
    #   gdbl = 8 products, gadd = 6 products + 3 pairs
    gdbl, gadd = 16 * NL * NL, 21 * NL * NL
    per_lane = nwin * (4 * gdbl + 2 * gadd) + (gdbl + 13 * gadd + 16 * 2 * NL * NL)
    lad_ops = B * per_lane
    lad_bytes = 4 * B * (6 * L + 2 * nwin + 2)
    return {"glv_digits": (dig_bytes, dig_ops), "glv_ladder": (lad_bytes, lad_ops)}


def bound(nbytes: int, nops: int) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / IMAD_PER_S * 1e3
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
        for B, edge in ((4097, True), (batch, False)):
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
        times["digits"] = event_ms(lambda: dig(scalars), 20)
        times["ladder"] = event_ms(lambda: lad(pts, *got_d), 3)
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
                "bound_by": b_by, "library_ms": None, "batch": batch, "_wrapper": wrapper,
            })
        emit({"phase": "kernels", "config": f"{curve}/{group}", "batch": batch,
              "ragged_batch": 4097, "equal": True,
              "ms": {k: times[k] for k in ("digits", "digits_plain", "ladder", "ladder_plain")}})
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


def check_response(params, key, challenge: bytes, response: bytes, rng, label: str) -> int:
    """Host-oracle check of a response: the hash chain, and for 8 sampled
    indices per section response[i] == input[i] * (tau^i * coeff)."""
    from snark_setup_tpu_torch.curves.host import g1_curve, g2_curve
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, UseCompression

    if response[:64] != hashlib.blake2b(challenge, digest_size=64).digest():
        raise AssertionError(f"{label}: response does not start with the challenge's hash")
    spec = params.spec
    sec_in, sec_out = split(params, UseCompression.NO), split(params, UseCompression.YES)
    codecs = {"g1": (g1_codec(spec), g1_curve(spec)), "g2": (g2_codec(spec), g2_curve(spec))}
    checked = 0
    for name, group, coeff_name in SECTIONS:
        codec, curve = codecs[group]
        n = sec_in[name].num_elements
        picks = sorted({0, n - 1, *(int(i) for i in rng.integers(0, n, 6))})
        coeff = getattr(key, coeff_name) if coeff_name else 1
        for i in picks:
            p_in = codec.deserialize(bytes(sec_in[name].slice_of(challenge, i, i + 1)),
                                     UseCompression.NO, CheckForCorrectness.NO)
            p_out = codec.deserialize(bytes(sec_out[name].slice_of(response, i, i + 1)),
                                      UseCompression.YES, CheckForCorrectness.NO)
            if p_out != curve.mul(p_in, pow(key.tau, i, spec.r) * coeff % spec.r):
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


def contribute_phase(dev, power: int, batch: int, wrappers) -> None:
    """Phase 5: `new` + `contribute` through the port's CLI on BW6-761, then
    a second `contribute` on a non-trivial accumulator."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.cli import phase1_main
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.phase1.protocol import Phase1
    from snark_setup_tpu_torch.transcript.hashing import calculate_hash, derive_rng_from_seed
    from snark_setup_tpu_torch.utils.enums import (
        BatchExpMode, CheckForCorrectness, ProvingSystem, UseCompression,
    )

    common = ["--curve-kind", "bw6_761", "--proving-system", "groth16", "--contribution-mode",
              "full", "--power", str(power), "--batch-size", str(batch), "--device", dev.type]
    params = Phase1Parameters.new_full("bw6_761", ProvingSystem.GROTH16, power, batch)
    rng = np.random.default_rng(SEED + 200)
    n_points = sum(s.num_elements for s in split(params, UseCompression.NO).values())
    for w in wrappers:
        w.events = []

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
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
        for tag, chal in (("1", "challenge1"), ("2", "challenge2")):
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
                emit({"phase": "contribute", "step": "uncompressed accumulator via Phase1.computation",
                      "seconds": t_mid})
            n_events = [len(w.events) for w in wrappers]
            secs = cli(*common, "--seed", path(f"seed{tag}"), "contribute",
                       "--challenge-fname", path(chal), "--challenge-hash-fname", path(chal + ".hash"),
                       "--response-fname", path(f"response{tag}"),
                       "--response-hash-fname", path(f"response{tag}.hash"))
            kernel_ms = {
                type(w).__name__ + "[" + w.ops.group_name + "]":
                    sum(s.elapsed_time(e) for s, e in w.events[n0:])
                for w, n0 in zip(wrappers, n_events)
            }
            challenge, response = read(chal), read(f"response{tag}")
            _, key = Phase1.key_generation(
                params.spec, derive_rng_from_seed(seeds[tag]), calculate_hash(challenge))
            checked = check_response(params, key, challenge, response, rng, f"contribute {tag}")
            runs.append(secs)
            emit({"phase": "contribute", "step": f"contribute {tag}", "curve": "bw6_761",
                  "proving_system": "groth16", "mode": "full", "power": power, "batch_size": batch,
                  "points": n_points, "challenge_bytes": len(challenge), "wall_seconds": secs,
                  "points_per_s": n_points / secs, "kernel_ms": kernel_ms,
                  "kernel_seconds_total": sum(kernel_ms.values()) / 1e3,
                  "oracle_points_checked": checked, "hash_chain_ok": True})
        emit({"phase": "contribute", "step": "new", "seconds": t_new})
    for w in wrappers:
        w.events = None


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
    timed("of write_batch_start: normalize = inversion tree + Fermat inversion", lambda: ops.normalize(prod))
    timed("of normalize: Fermat inversion alone, width 1", lambda: ops.fq.inv(prod["z"][:, :1]))

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
                    help="log2 size of the contribute phase (>= 14)")
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

    with torch.no_grad():
        rows = compare_kernels(dev, BATCH)
        wrappers = [r["_wrapper"] for r in rows]
        # the main path: counts to 0 just before, read just after
        for w in wrappers:
            w.launches = 0
            w.plain_calls = 0
        scalar_mul_phase(dev, BATCH)
        contribute_phase(dev, args.power, BATCH,
                         [w for w in wrappers if w.ops.spec.name == "bw6"])
        for r in rows:
            w = r.pop("_wrapper")
            r["launches"] = w.launches
            if w.launches <= 0:
                raise AssertionError(f"{r['name']} was never launched on the main path")
            if w.plain_calls != 0:
                raise AssertionError(f"{r['name']}: the plain version ran on the main path")
        breakdown_phase(dev, BATCH)
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
