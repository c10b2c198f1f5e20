#!/usr/bin/env python3
"""Time the hand-written kernels of two trees of the PyTorch/CUDA port on
one card, in turns.

    python3 scripts/compare_kernels.py --first-form DIR [--kernels k2,k3,k4,k5,k6,k7,k8,sqrt] [--route-muls]
        [--launch-weights SMOKE_LOG]

DIR holds another checkout of the repository (for example `git archive` of
the commit before a kernel's redesign, unpacked under `build/`). The script
runs four timing processes on the card, in the order DIR, this tree, this
tree, DIR; each builds its own tree's kernels (into that tree's `build/`)
and times, through the wrappers a caller uses:

- k2: the group-op kernel's double and add (`group_ops_for(...).double /
  .add`) on BW6-761 G1 / G2 and BLS12-377 G1 at 1, nwin (the Pippenger
  bucket finalize's width), 1024 and 16384 lanes, and an addition of
  sum_reduce's strided even / odd lanes at 16384 (a tree that copies those
  views pays for it inside the call);
- k3 / k4: the GLV digits kernel (`glv_digits_for(...)`) and the whole
  ladder (`fused_ladder_for(...)`) on the same three groups at 1, 4, 7, 17,
  4096, 16384 and 65536 lanes (4 and 7 are the narrow tails a BW6-761
  contribution launches), each process also reporting a checksum of the
  ladder's output at 4097 lanes, which must agree across the turns;
- k5 / k6 / k7 / k8: the stacked product (K5) and its opt-in routes' kernels
  (`stacked_product_for(...).k6 / .k7 / .k8`) at chip_smoke.py's
  ROUTE_SHAPES (K5 at all of them, the yardstick) at 1, 17, 4096, 16384
  and 65536 lanes, each process also reporting a checksum of every
  shape's output at 4097 lanes, which must agree across the turns; K5
  also at S = G = 1 (one Fq product, the shape the square root's chains
  launched before they became one kernel), for the record;
- sqrt: the decompression square root over Fq through the codec's
  `ExtSqrt.sqrt` (the call a caller makes: one launch of csrc/fq_sqrt.cu
  where the tree has it, ~600-1600 one-product launches of K5 where it does
  not) on BW6-761, BLS12-377 and BLS12-381 at 1, 33, 4097 and 16384 lanes:
  `sqrt <curve> call <w>` around the whole call (host time included) and
  `sqrt <curve> kernels <w>` the sum of its launches' events, each process
  also reporting a checksum of the root and mask at 4097 lanes.

`--launch-weights SMOKE_LOG` reads the `{"kernels": [...]}` line of a
chip_smoke.py run and weights K5's time at each shape (16384 lanes) by the
launches of that shape on the default path of its curve (`launches_by_shape`
of the K5 rows), for every turn: the summary's `k5_launch_weighted` gives
each turn's weighted milliseconds, the ratio of the trees' best turns and
each tree's spread — the redesign takes the path if the ratio clears both
spreads. Shapes of the path that are not timed here carry no weight.

`--route-muls` also runs chip_smoke.py's route scalar-mul phase in each
turn (the batch scalar-mul under a route switch on BLS12-377 G2, MNT4-753
G1 and MNT6-753 G2, host-oracle spot checks) and reports the seconds
inside each stacked-product kernel there, from its launch events.

Every time is the mean over the calls of the wrapper's per-launch CUDA
events (kernel time, host time between launches not counted), except the
strided addition, timed around the whole call (event_ms: copies included).
Each process also prints its tree's `nvcc -Xptxas -v` lines for the
libraries it timed and, where `cuobjdump` is found, each library's SASS
instruction count and a hash of its instructions, so the summary can say
whether a kernel's machine code differs between the trees.

`--variants V ...` then times this tree again once per variant V, a
comma-separated list of PREFIX:NAME=VALUE items: every library whose name
starts with PREFIX is built with -DNAME=VALUE (for example
`group_ops_nl24:TEAM=4` or `glv_ladder:TABLE_LOCAL=0`); `--first-form` may
then be left out. The summary (per kernel and shape: every turn's time, the
ratio first form / this tree from the best turns, the spread of each tree's
two turns, and the bound as chip_smoke.py counts it) goes to standard
output and to `--out` (default build/compare_kernels.json; the raw runs
beside it, as *_runs.json, written after each process). Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 50
LADDER_REPEATS = 5
GLV_WIDTHS = (1, 4, 7, 17, 4096, 16384, 65536)
ROUTE_WIDTHS = (1, 17, 4096, 16384, 65536)
SQRT_WIDTHS = (1, 33, 4097, 16384)
SQRT_REPEATS = 5
KERNELS = ("k2", "k3", "k4", "k5", "k6", "k7", "k8", "sqrt")
LIBS = {"k2": ("group_ops",), "k3": ("glv_digits",), "k4": ("glv_ladder",), "k5": ("stacked_mul_nl",),
        "k6": ("stacked_cols",), "k7": ("stacked_mul_v3",), "k8": ("stacked_mul_v2",), "sqrt": ("fq_sqrt",)}
# K5 at one Fq product a launch (S = G = 1), for the record
K5_RECORD = (("bw6_761", "g1", "Fq product (S=G=1)", ((1,),)),
             ("bls12_377", "g1", "Fq product (S=G=1)", ((1,),)))


def smoke():
    """This tree's chip_smoke.py (the other tree may hold an older one)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_digest(lib: str) -> dict | None:
    """The SASS instruction count of a built library, a hash of its
    instruction lines (`cuobjdump -sass`) and its most frequent opcodes
    (with their modifiers, e.g. IMAD.HI.U32); None where the toolkit's
    `cuobjdump` is not found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True, timeout=300).stdout
    lines = [ln.strip() for ln in text.splitlines() if re.search(r"/\*[0-9a-f]{4}\*/", ln)]
    ops = {}
    for ln in lines:
        m = re.match(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return {"instructions": len(lines), "sha256": hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16],
            "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:16])}


def stacked_shapes(cs, kernel: str) -> list:
    """(curve, group, label, weights) of chip_smoke.py's ROUTE_SHAPES that
    `kernel` is timed at: its own, or for K5 all of them (once each)."""
    if kernel != "k5":
        return list(cs.ROUTE_SHAPES[kernel])
    seen = {}
    for shapes in cs.ROUTE_SHAPES.values():
        for shape in shapes:
            seen.setdefault(shape[:3], shape)
    return [*seen.values(), *K5_RECORD]


def flattened(F, weights):
    """(composite weights, row maps) of a tower-level shape, as chip_smoke.py
    hands them to the wrappers."""
    S = len(weights[0])
    return (weights, (tuple(range(S)), tuple(range(S)), (0,) * S)) if F.degree == 1 else F._flattened(weights, S)


def time_tree(defines=(), kernels=KERNELS, route_muls=False) -> dict:
    """The timings of the package first on sys.path (a child process);
    `defines`: PREFIX:NAME=VALUE items added to those libraries' flags."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops import build

    for item in defines:
        prefix, define = item.split(":", 1)
        for target, (src, flags) in list(build.TARGETS.items()):
            if target.startswith(prefix):
                build.TARGETS[target] = (src, [*flags, f"-D{define}"])
    from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops

    cs = smoke()
    dev = torch.device("cuda", 0)
    out = {"package": os.path.dirname(build.__file__), "ms": {}, "checksum": {}}
    ms = out["ms"]
    with torch.no_grad():
        if "k2" in kernels:
            from snark_setup_tpu_torch.ops.cuda_group import group_ops_for
            from snark_setup_tpu_torch.ops.msm import RLC_BITS
            from snark_setup_tpu_torch.ops.pippenger import PippengerMSM

            for ci, (curve, group) in enumerate(cs.CONFIGS):
                ops = curve_ops(curve, group)
                k2 = group_ops_for(curve, group)
                rng = np.random.default_rng(cs.SEED + 700 + ci)
                _, _, P2, Q2 = cs.group_inputs(ops, 2 * cs.BATCH, rng, dev)
                nwin = PippengerMSM(ops, cs.BATCH, RLC_BITS).nwin
                for w in (1, nwin, 1024, cs.BATCH):
                    pw = PointVec({k: v[:, :w].contiguous() for k, v in P2.items()})
                    qw = PointVec({k: v[:, :w].contiguous() for k, v in Q2.items()})
                    ms[f"k2 {curve}/{group} dbl {w}"] = cs.launch_ms(k2.dbl, lambda: k2.double(pw), REPEATS)
                    ms[f"k2 {curve}/{group} add {w}"] = cs.launch_ms(k2.add_k, lambda: k2.add(pw, qw), REPEATS)
                even = PointVec({k: v[:, 0::2] for k, v in P2.items()})
                odd = PointVec({k: v[:, 1::2] for k, v in P2.items()})
                ms[f"k2 {curve}/{group} add even/odd {cs.BATCH} (call)"] = cs.event_ms(
                    lambda: k2.add(even, odd), REPEATS)
        if "k3" in kernels or "k4" in kernels:
            from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for
            from snark_setup_tpu_torch.ops.cuda_ladder import fused_ladder_for

            for ci, (curve, group) in enumerate(cs.CONFIGS):
                ops = curve_ops(curve, group)
                dig, lad = glv_digits_for(curve, group), fused_ladder_for(curve, group)
                rng = np.random.default_rng(cs.SEED + 800 + ci)
                pts, scalars, _, _ = cs.make_inputs(ops, max(GLV_WIDTHS), rng, dev, edge=True, projective=True)
                digits = dig(scalars)
                for w in GLV_WIDTHS:
                    sw = scalars[:, :w].contiguous()
                    pw = PointVec({k: v[:, :w].contiguous() for k, v in pts.items()})
                    dw = [d[..., :w].contiguous() for d in digits]
                    if "k3" in kernels:
                        ms[f"k3 {curve}/{group} {w}"] = cs.launch_ms(dig, lambda: dig(sw), REPEATS)
                    if "k4" in kernels:
                        ms[f"k4 {curve}/{group} {w}"] = cs.launch_ms(lad, lambda: lad(pw, *dw), LADDER_REPEATS)
                if "k4" in kernels:
                    got = lad(PointVec({k: v[:, :cs.RAGGED].contiguous() for k, v in pts.items()}),
                              *(d[..., :cs.RAGGED].contiguous() for d in digits))
                    out["checksum"][f"k4 {curve}/{group}"] = [
                        int((got[k].long() * torch.arange(1, got[k].numel() + 1, device=dev).view_as(got[k]))
                            .sum()) for k in "xyz"]
                if "k3" in kernels:
                    out["checksum"][f"k3 {curve}/{group}"] = [int(d.long().sum()) for d in digits]
        stacked = [k for k in ("k5", "k6", "k7", "k8") if k in kernels]
        if stacked:
            from snark_setup_tpu_torch.ops.cuda_routes import stacked_product_for

            for kern in stacked:
                for ci, (curve, group, label, weights) in enumerate(stacked_shapes(cs, kern)):
                    F = curve_ops(curve, group).field
                    fq = F.fp
                    P = stacked_product_for(fq.modulus)
                    K = getattr(P, kern)
                    comp, maps = flattened(F, weights)
                    SU = F.degree * len(weights[0])
                    rng = np.random.default_rng(cs.SEED + 900 + ci)
                    U = cs.stacked_inputs(fq, SU, max(ROUTE_WIDTHS), rng, dev)
                    V = cs.stacked_inputs(fq, SU, max(ROUTE_WIDTHS), rng, dev)
                    for w in ROUTE_WIDTHS:
                        Uw, Vw = U[..., :w].contiguous(), V[..., :w].contiguous()
                        ms[f"{kern} {curve} {label} {w}"] = cs.launch_ms(K, lambda: K(Uw, Vw, comp, maps), REPEATS)
                    got = K(U[..., :cs.RAGGED].contiguous(), V[..., :cs.RAGGED].contiguous(), comp, maps)
                    words = got.long() & 0xFFFFFFFF  # K6's 32-bit columns read as unsigned
                    out["checksum"][f"{kern} {curve} {label}"] = int(
                        (words * torch.arange(1, got.numel() + 1, device=dev).view_as(got)).sum())
        if "sqrt" in kernels:
            from snark_setup_tpu_torch.ops.codec import batch_codec

            for ci, curve in enumerate(("bw6_761", "bls12_377", "bls12_381")):
                codec = batch_codec(curve, "g1", dev)
                sq, fq = codec.sqrter, codec.fp
                # the kernels a square root launches: K5 of the modulus, and
                # the square-root kernel where this tree has one
                counters = [codec.F.product.k5]
                try:
                    from snark_setup_tpu_torch.ops.cuda_sqrt import fq_sqrt_for

                    counters.append(fq_sqrt_for(sq.q, sq.z_coeffs[0]))
                except ImportError:
                    pass
                rng = np.random.default_rng(cs.SEED + 950 + ci)
                for w in SQRT_WIDTHS:
                    a = cs.sqrt_inputs(fq, sq.z_coeffs[0], w, rng, dev)
                    ms[f"sqrt {curve} call {w}"] = cs.event_ms(lambda: sq.sqrt(a), SQRT_REPEATS)
                    for c in counters:
                        c.events = []
                    for _ in range(SQRT_REPEATS):
                        sq.sqrt(a)
                    torch.cuda.synchronize()
                    ms[f"sqrt {curve} kernels {w}"] = sum(
                        s.elapsed_time(e) for c in counters for s, e in c.events) / SQRT_REPEATS
                    for c in counters:
                        c.events = None
                    if w == cs.RAGGED:
                        root, ok = sq.sqrt(a)
                        out["checksum"][f"sqrt {curve}"] = [
                            int((root.long() * torch.arange(1, root.numel() + 1, device=dev).view_as(root)).sum()),
                            int(ok.long().sum())]
        if route_muls:
            from snark_setup_tpu_torch.ops.cuda_routes import stacked_product_for

            wrappers = {}
            for curve in ("bls12_377", "mnt4_753", "mnt6_753"):
                P = stacked_product_for(curve_ops(curve, "g1").field.fp.modulus)
                wrappers.update({f"{k} {curve}": getattr(P, k) for k in ("k5", "k6", "k7", "k8")})
            out["route_muls"] = cs.route_scalar_mul_phase(dev, cs.BATCH, wrappers,
                                                          cs.mxu_reducers(("mnt4_753", "mnt6_753")))
    mine = [t for t in build.build_logs if any(t.startswith(p) for k in kernels for p in LIBS[k])]
    out["ptxas"] = {t: [ln.strip() for ln in build.build_logs[t].splitlines()
                        if "registers" in ln or "spill" in ln or "smem" in ln] for t in mine}
    out["libraries"] = {t: build._lib_path(t) for t in mine}
    out["sass"] = {t: sass_digest(build._lib_path(t)) for t in build.TARGETS
                   if any(t.startswith(p) for k in kernels for p in LIBS[k])}
    return out


def launch_weights(path: str) -> dict:
    """{(curve, shape_key): launches} from the K5 rows of a chip_smoke.py
    log's kernels line, each on the default path of its curve."""
    with open(path) as f:
        line = next(ln for ln in f if ln.startswith('{"kernels"'))
    weights = {}
    for row in json.loads(line)["kernels"]:
        if row["name"].startswith("stacked_mul[") and row.get("path") == row["name"][12:].split()[0]:
            for key, n in row.get("launches_by_shape", {}).items():
                weights[(row["path"], key)] = n
    return weights


def k5_weighted(runs, weights: dict) -> dict:
    """K5's launch-weighted milliseconds per turn at 16384 lanes."""
    cs = smoke()
    from snark_setup_tpu_torch.ops.cuda_mul import shape_key
    from snark_setup_tpu_torch.ops.curve import curve_ops

    terms = []
    for curve, group, label, wts in stacked_shapes(cs, "k5"):
        comp, _ = flattened(curve_ops(curve, group).field, wts)
        n = weights.get((curve, shape_key(comp)), 0)
        if n:
            terms.append((f"k5 {curve} {label} {cs.BATCH}", n))
    turns = [(label, sum(n * r["ms"][name] for name, n in terms)) for label, r in runs if "k5" in
             {k.split()[0] for k in r["ms"]}]
    best = {}
    spread = {}
    for label in {t[0] for t in turns}:
        vals = [v for lab, v in turns if lab == label]
        best[label] = min(vals)
        spread[label] = max(vals) / min(vals) if len(vals) > 1 else None
    ratio = best["first form"] / best["redesign"] if {"first form", "redesign"} <= best.keys() else None
    clears = ratio is not None and all(s is not None and ratio > s for s in
                                       (spread.get("first form"), spread.get("redesign")))
    return {"shapes": dict(terms), "turns": turns, "best": best, "spread": spread,
            "ratio_first_over_redesign": ratio, "redesign_takes_the_path": clears}


def bounds(kernels) -> dict:
    """chip_smoke.py's bounds (ms, by) at the timed shapes, from this tree."""
    cs = smoke()
    from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for
    from snark_setup_tpu_torch.ops.cuda_ladder import fused_ladder_for
    from snark_setup_tpu_torch.ops.curve import curve_ops
    from snark_setup_tpu_torch.ops.msm import RLC_BITS
    from snark_setup_tpu_torch.ops.pippenger import PippengerMSM

    out = {}
    for curve, group in cs.CONFIGS:
        ops = curve_ops(curve, group)
        nwin = PippengerMSM(ops, cs.BATCH, RLC_BITS).nwin
        for w in (1, nwin, 1024, cs.BATCH):
            for kind in ("dbl", "add"):
                out[f"k2 {curve}/{group} {kind} {w}"] = cs.bound(*cs.group_work(ops, kind, w))
        out[f"k2 {curve}/{group} add even/odd {cs.BATCH} (call)"] = out[f"k2 {curve}/{group} add {cs.BATCH}"]
        dig, lad = glv_digits_for(curve, group), fused_ladder_for(curve, group)
        for w in GLV_WIDTHS:
            work = cs.kernel_work(ops, dig, lad, w)
            out[f"k3 {curve}/{group} {w}"] = cs.bound(*work["glv_digits"])
            out[f"k4 {curve}/{group} {w}"] = cs.bound(*work["glv_ladder"])
    for kern in ("k5", "k6", "k7", "k8"):
        for curve, group, label, weights in stacked_shapes(cs, kern):
            F = curve_ops(curve, group).field
            comp, _ = flattened(F, weights)
            SU = F.degree * len(weights[0])
            for w in ROUTE_WIDTHS:
                work = cs.stacked_work(F.fp, comp, SU, SU, w) if kern == "k5" else \
                    cs.route_work(kern, F.fp, comp, SU, SU, w)
                out[f"{kern} {curve} {label} {w}"] = cs.bound(*work)
    from snark_setup_tpu_torch.ops.codec import ExtSqrt
    from snark_setup_tpu_torch.ops.cuda_sqrt import fq_sqrt_for

    for curve in ("bw6_761", "bls12_377", "bls12_381"):
        F = curve_ops(curve, "g1").field
        sq = ExtSqrt(F, F.fp.modulus)
        K = fq_sqrt_for(sq.q, sq.z_coeffs[0])
        for w in SQRT_WIDTHS:
            out[f"sqrt {curve} kernels {w}"] = out[f"sqrt {curve} call {w}"] = cs.bound(*cs.sqrt_work(K, w))
    return {k: v for k, v in out.items() if k.split()[0] in kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-form", help="root of the other checkout (its package is timed first and last)")
    ap.add_argument("--kernels", default=",".join(KERNELS), help=f"comma-separated subset of {','.join(KERNELS)}")
    ap.add_argument("--route-muls", action="store_true",
                    help="also sum each stacked-product kernel's seconds in the route scalar-mul phase")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="variants of this tree to time, each PREFIX:NAME=VALUE[,PREFIX:NAME=VALUE]")
    ap.add_argument("--launch-weights", help="a chip_smoke.py log: weight K5's shapes by their launches")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "compare_kernels.json"),
                    help="where to write the summary (JSON)")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)  # child: time the package under this root
    ap.add_argument("--define", action="append", default=[], help=argparse.SUPPRESS)  # child: PREFIX:NAME=VALUE
    args = ap.parse_args()
    kernels = tuple(k for k in args.kernels.split(",") if k)
    if any(k not in KERNELS for k in kernels):
        ap.error(f"--kernels takes a subset of {','.join(KERNELS)}")

    if args.time_tree:
        sys.path.insert(0, args.time_tree)  # that tree's package
        import torch

        if not torch.cuda.is_available():
            print("compare_kernels: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(time_tree(args.define, kernels, args.route_muls)), flush=True)
        return 0

    if not args.first_form and not args.variants:
        ap.error("give --first-form DIR, --variants, or both")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    turns = []
    if args.first_form:
        first = os.path.abspath(args.first_form)
        turns = [("first form", first, ()), ("redesign", HERE, ()), ("redesign", HERE, ()), ("first form", first, ())]
    turns += [(f"variant {v}", HERE, tuple(v.split(","))) for v in args.variants]
    runs, failed = [], []
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    raw = out[: -len(".json")] + "_runs.json" if out.endswith(".json") else out + "_runs"
    for label, root, defines in turns:
        cmd = [sys.executable, os.path.abspath(__file__), "--time-tree", root, "--kernels", ",".join(kernels)]
        if args.route_muls:
            cmd.append("--route-muls")
        for d in defines:
            cmd += ["--define", d]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        if done.returncode != 0:
            sys.stderr.write(f"{label} failed:\n{done.stderr[-4000:]}\n")
            if not label.startswith("variant"):
                return done.returncode or 1
            failed.append(label)  # a variant that does not build is reported and skipped
            continue
        runs.append((label, json.loads(done.stdout.strip().splitlines()[-1])))
        with open(raw, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs, "failed": failed}, f)
    sums = {}
    for label, r in runs:
        for key, value in r["checksum"].items():
            sums.setdefault(key, set()).add(json.dumps(value))
    mismatched = sorted(k for k, v in sums.items() if len(v) > 1)
    sys.path.insert(0, HERE)
    bnd = bounds(kernels)
    summary = {"nvidia_smi": smi, "order": [r[0] for r in runs], "failed": failed,
               "outputs_equal_across_turns": not mismatched, "mismatched": mismatched, "rows": [],
               # a tree's libraries are built (and ptxas heard) in its first turn only
               "ptxas": {label: r["ptxas"] for label, r in reversed(runs) if r["ptxas"]},
               "libraries": {label: r["libraries"] for label, r in reversed(runs) if r["libraries"]},
               "sass": {label: r["sass"] for label, r in runs},
               "route_muls": [(label, r.get("route_muls")) for label, r in runs if r.get("route_muls")]}
    if args.first_form:  # libraries of one name in both trees: is the machine code the same?
        first, mine = runs[0][1]["sass"], runs[1][1]["sass"]
        summary["sass_equal"] = {t: first[t] == mine[t] for t in first.keys() & mine.keys()
                                 if first[t] and mine[t]}
    for name in runs[0][1]["ms"]:
        first_ms = [r["ms"][name] for label, r in runs if label == "first form"]
        new_ms = [r["ms"][name] for label, r in runs if label == "redesign"]
        b = bnd.get(name)
        summary["rows"].append({
            "name": name, "first_form_ms": first_ms, "redesign_ms": new_ms,
            **{label: r["ms"].get(name) for label, r in runs if label.startswith("variant")},
            "ratio": min(first_ms) / min(new_ms) if first_ms and new_ms else None,
            # the same tree timed in two turns: the spread a ratio must clear
            "spread_first": max(first_ms) / min(first_ms) if len(first_ms) > 1 else None,
            "spread_redesign": max(new_ms) / min(new_ms) if len(new_ms) > 1 else None,
            "bound_ms": b[0] if b else None, "bound_by": b[1] if b else None,
        })
    if args.launch_weights and "k5" in kernels:
        summary["k5_launch_weighted"] = k5_weighted(runs, launch_weights(args.launch_weights))
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 1 if mismatched else 0


if __name__ == "__main__":
    sys.exit(main())
