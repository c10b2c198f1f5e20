#!/usr/bin/env python3
"""Time the group-op kernel K2 and the stacked-product kernel K5 of two
trees of the PyTorch/CUDA port on one card, in turns.

    python3 scripts/compare_k2_k5.py --first-form DIR

DIR holds another checkout of the repository (for example `git archive` of
the commit before a kernel's redesign, unpacked under `build/`). The script
runs four timing processes on the card, in the order DIR, this tree, this
tree, DIR; each builds its own tree's kernels (into that tree's `build/`)
and times, through the wrappers a caller uses (`group_ops_for(...)
.double / .add`, `stacked_mul_for(q)(U, V, weights, rows)`):

- K2 double and add on BW6-761 G1 / G2 and BLS12-377 G1 at 1, nwin (the
  Pippenger bucket finalize's width), 1024 and 16384 lanes, and an addition
  of sum_reduce's strided even / odd lanes at 16384 (a tree that copies
  those views pays for it inside the call);
- K5 at chip_smoke.py's STACKED shapes, 16384 lanes.

Every time is the mean over the calls of the wrapper's per-launch CUDA
events (kernel time, host time between launches not counted), except the
strided addition, timed around the whole call (event_ms: copies included).
Each process also prints its tree's `nvcc -Xptxas -v` lines for the two
libraries. `--variants 12:2,24:4 24:2 ...` then times this tree again once
per variant, its K2 libraries built with -DTEAM=T for the limb counts named
(NL:T), to choose the team size by measurement; `--first-form` may then be
left out. The summary (per kernel and shape: both trees' times, their
ratio, the bound as chip_smoke.py counts it) goes to standard output and to
`--out` (default build/compare_k2_k5.json; the raw runs beside it, as
*_runs.json, written after each process). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 50


def smoke():
    """This tree's chip_smoke.py (the other tree may hold an older one)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(teams=()) -> dict:
    """The timings of the package first on sys.path (a child process);
    `teams`: "NL:T" items, that limb count's K2 library built with -DTEAM=T."""
    import numpy as np
    import torch

    from snark_setup_tpu_torch.ops import build

    for item in teams:  # NL:T
        nl, t = item.split(":")
        src, defines = build.TARGETS[f"group_ops_nl{nl}"]
        build.TARGETS[f"group_ops_nl{nl}"] = (src, [*defines, f"-DTEAM={t}"])
    from snark_setup_tpu_torch.ops.cuda_group import group_ops_for
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for
    from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops
    from snark_setup_tpu_torch.ops.msm import RLC_BITS
    from snark_setup_tpu_torch.ops.pippenger import PippengerMSM

    cs = smoke()
    dev = torch.device("cuda", 0)
    out = {"package": os.path.dirname(build.__file__), "k2": {}, "k5": {}}
    with torch.no_grad():
        for ci, (curve, group) in enumerate(cs.CONFIGS):
            ops = curve_ops(curve, group)
            k2 = group_ops_for(curve, group)
            rng = np.random.default_rng(cs.SEED + 700 + ci)
            _, _, P2, Q2 = cs.group_inputs(ops, 2 * cs.BATCH, rng, dev)
            nwin = PippengerMSM(ops, cs.BATCH, RLC_BITS).nwin
            res = {}
            for w in (1, nwin, 1024, cs.BATCH):
                pw = PointVec({k: v[:, :w].contiguous() for k, v in P2.items()})
                qw = PointVec({k: v[:, :w].contiguous() for k, v in Q2.items()})
                res[f"dbl {w}"] = cs.launch_ms(k2.dbl, lambda: k2.double(pw), REPEATS)
                res[f"add {w}"] = cs.launch_ms(k2.add_k, lambda: k2.add(pw, qw), REPEATS)
            even = PointVec({k: v[:, 0::2] for k, v in P2.items()})
            odd = PointVec({k: v[:, 1::2] for k, v in P2.items()})
            res[f"add even/odd {cs.BATCH} (call)"] = cs.event_ms(lambda: k2.add(even, odd), REPEATS)
            out["k2"][f"{curve}/{group}"] = res
        for ci, (curve, group, label, weights) in enumerate(cs.STACKED):
            F = curve_ops(curve, group).field
            fq = F.fp
            K = stacked_mul_for(fq.modulus)
            S = len(weights[0])
            comp, maps = (weights, (tuple(range(S)), tuple(range(S)), (0,) * S)) if F.degree == 1 \
                else F._flattened(weights, S)
            rng = np.random.default_rng(cs.SEED + 900 + ci)
            U = cs.stacked_inputs(fq, F.degree * S, cs.BATCH, rng, dev)
            V = cs.stacked_inputs(fq, F.degree * S, cs.BATCH, rng, dev)
            out["k5"][f"{curve} {label}"] = cs.launch_ms(K, lambda: K(U, V, comp, maps), REPEATS)
    mine = ("group_ops_nl12", "group_ops_nl24", "stacked_mul_nl12", "stacked_mul_nl24")
    out["ptxas"] = {t: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
                    for t, log in build.build_logs.items() if t in mine}
    out["libraries"] = {t: build._lib_path(t) for t in mine}
    return out


def bounds() -> dict:
    """chip_smoke.py's bounds (ms) at the timed shapes, from this tree."""
    cs = smoke()
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
    for curve, group, label, weights in cs.STACKED:
        F = curve_ops(curve, group).field
        S = len(weights[0])
        comp = weights if F.degree == 1 else F._flattened(weights, S)[0]
        SU = F.degree * S
        out[f"k5 {curve} {label}"] = cs.bound(*cs.stacked_work(F.fp, comp, SU, SU, cs.BATCH))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-form", help="root of the other checkout (its package is timed first and last)")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="team-size variants of this tree to time, each NL:T[,NL:T]")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "compare_k2_k5.json"),
                    help="where to write the summary (JSON)")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)  # child: time the package under this root
    ap.add_argument("--team", action="append", default=[], help=argparse.SUPPRESS)  # child: NL:T
    args = ap.parse_args()

    if args.time_tree:
        sys.path.insert(0, args.time_tree)  # that tree's package
        import torch

        if not torch.cuda.is_available():
            print("compare_k2_k5: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(time_tree(args.team)), flush=True)
        return 0

    if not args.first_form and not args.variants:
        ap.error("give --first-form DIR, --variants, or both")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    turns = []
    if args.first_form:
        first = os.path.abspath(args.first_form)
        turns = [("first form", first, ()), ("redesign", HERE, ()), ("redesign", HERE, ()), ("first form", first, ())]
    turns += [(f"TEAM {v}", HERE, tuple(v.split(","))) for v in args.variants]
    runs, failed = [], []
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    for label, root, teams in turns:
        cmd = [sys.executable, os.path.abspath(__file__), "--time-tree", root]
        for t in teams:
            cmd += ["--team", t]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        if done.returncode != 0:
            sys.stderr.write(f"{label} failed:\n{done.stderr[-4000:]}\n")
            if not label.startswith("TEAM"):
                return done.returncode or 1
            failed.append(label)  # a variant that does not build is reported and skipped
            continue
        runs.append((label, json.loads(done.stdout.strip().splitlines()[-1])))
        with open(out[: -len(".json")] + "_runs.json" if out.endswith(".json") else out + "_runs", "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs, "failed": failed}, f)
    sys.path.insert(0, HERE)
    bnd = bounds()
    summary = {"nvidia_smi": smi, "order": [r[0] for r in runs], "failed": failed, "rows": [],
               "ptxas": {label: r["ptxas"] for label, r in runs}, "libraries": {label: r["libraries"] for label, r in runs}}
    base = 4 if args.first_form else 0
    for kernel in ("k2", "k5"):
        for shape in runs[0][1][kernel]:
            items = runs[0][1][kernel][shape].items() if kernel == "k2" else [("", runs[0][1][kernel][shape])]
            for key, _ in items:
                def pick(r):
                    v = r[1][kernel][shape]
                    return v[key] if kernel == "k2" else v
                first_ms = [pick(r) for r in runs if r[0] == "first form"]
                new_ms = [pick(r) for r in runs if r[0] == "redesign"]
                name = f"{kernel} {shape} {key}".strip()
                b = bnd.get(name)
                summary["rows"].append({
                    "name": name, "first_form_ms": first_ms, "redesign_ms": new_ms,
                    **{label: pick((label, r)) for label, r in runs[base:]},
                    "ratio": min(first_ms) / min(new_ms) if first_ms else None,
                    "bound_ms": b[0] if b else None, "bound_by": b[1] if b else None,
                })
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
