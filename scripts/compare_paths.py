#!/usr/bin/env python3
"""Time the main paths of two trees of the PyTorch/CUDA port on one card, in
turns.

    python3 scripts/compare_paths.py --first-form DIR [--out build/compare_paths.json]

DIR holds another checkout of the repository (for example `git archive` of
the parent commit, unpacked under `build/`). The inputs are made once, by
this tree, into `build/compare_paths/`: the initial BW6-761 accumulator at
power 16 and the BLS12-377 one at power 13 (uncompressed challenges, as the
CLI's `new` writes them), and a streaming phase-2 chunk of BW6-761 with
the counts of the SHA-256 circuit's chunk 0 (2^15 h points, 29860 L
points, scalar-muls of the generator on the card). Then four processes, in
the order DIR, this tree, this tree, DIR, each import their tree's package,
build its kernels (into that tree's `build/`), run every step once to warm
up at a small size, and time, through the protocol's entry points with the
batch size of chip_smoke.py (16384):

- `bw6_761 contribute 16`: Phase1.computation of the challenge into a
  compressed response;
- `bw6_761 verify 16`: Phase1.verification of that response (FULL output
  check, AUTO subgroup mode, the ratio checks);
- `bls12_377 verify 13`: the same on BLS12-377 (its contribution, untimed,
  first);
- `bw6_761 phase2 chunked contribute`: phase2/chunked.contribute in place
  on the chunk.

Each step's wall is a host clock around the call, ended by a synchronize;
its kernel seconds are the sum of the launch events of every kernel
wrapper of the tree (any object of its `ops/cuda_*.py` modules with
`launches` and `events`); the
device-busy share is their ratio. Each process also reports the Blake2b of
every output, which must agree across the turns: the two trees write the
same bytes. The summary gives per step and tree both turns, the mean and
the spread (max - min), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 16384
BW6_POWER, BLS_POWER = 16, 13
H_POINTS, L_POINTS = 1 << 15, 29860
WARM_POWER, WARM_BATCH = 6, 64  # the warm-up's contributions and verifications
DEVICE = "cuda"  # a CPU rehearsal of the steps sets "cpu" and small sizes
WRAPPER_MODULES = "snark_setup_tpu_torch.ops.cuda_"  # the kernel wrappers' modules
STEPS = ("bw6_761 contribute 16", "bw6_761 verify 16", "bls12_377 verify 13", "bw6_761 phase2 chunked contribute")


def _blake(data) -> str:
    return hashlib.blake2b(bytes(data), digest_size=16).hexdigest()


def make_inputs(work: str) -> None:
    """The challenges and the phase-2 chunk, written once into `work`."""
    import torch

    from snark_setup_tpu_torch.curves.constants import get_curve
    from snark_setup_tpu_torch.curves.host import g1_curve, g2_curve
    from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
    from snark_setup_tpu_torch.ops.curve import curve_ops
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.phase1.testing import generate_input
    from snark_setup_tpu_torch.phase2.parameters import MPCParameters, ProvingKey, VerifyingKey
    from snark_setup_tpu_torch.utils.enums import ProvingSystem, UseCompression

    os.makedirs(work, exist_ok=True)
    for curve, power in (("bw6_761", BW6_POWER), ("bls12_377", BLS_POWER)):
        params = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, power, BATCH)
        with open(os.path.join(work, f"challenge_{curve}"), "wb") as f:
            f.write(generate_input(params, UseCompression.NO))
    dev = torch.device(DEVICE)
    spec = get_curve("bw6_761")
    ops = curve_ops("bw6_761", "g1")
    c1, c2 = g1_curve(spec), g2_curve(spec)
    n = H_POINTS + L_POINTS
    ks = [(7 * i + 5) % spec.r for i in range(n)]
    gen = ops.from_affine_host([c1.generator], dev)
    pts = {k: v.expand(*v.shape[:-1], n).contiguous() for k, v in gen.items()}
    raw = torch.from_numpy(ints_to_limbs_batch(ks, ops.fr.L).T.astype("int32")).to(dev)
    with torch.no_grad():
        walk = ops.to_affine_host(ops.scalar_mul(type(gen)(pts), raw))
    vk = VerifyingKey(c1.generator, c2.generator, c2.generator, c2.generator, [c1.generator])
    pk = ProvingKey(vk, c1.generator, c1.generator, [], [], [], walk[:H_POINTS], walk[H_POINTS:])
    with open(os.path.join(work, "phase2_chunk"), "wb") as f:
        f.write(MPCParameters(spec, pk, bytes(range(64)), []).write(UseCompression.NO, dev))


def time_tree(work: str) -> dict:
    """The steps, timed with the package first on sys.path."""
    import random

    import torch

    from snark_setup_tpu_torch.curves.constants import get_curve
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.phase1.protocol import Phase1
    from snark_setup_tpu_torch.phase1.testing import generate_input, generate_output
    from snark_setup_tpu_torch.phase2 import chunked
    from snark_setup_tpu_torch.phase2.keypair import Phase2PublicKey
    from snark_setup_tpu_torch.transcript.hashing import blank_hash, derive_rng_from_seed
    from snark_setup_tpu_torch.utils.enums import (
        BatchExpMode, CheckForCorrectness, ProvingSystem, SubgroupCheckMode, UseCompression,
    )

    dev = torch.device(DEVICE)
    NO, YES = UseCompression.NO, UseCompression.YES
    FULL = CheckForCorrectness.FULL

    def read(name) -> bytes:
        with open(os.path.join(work, name), "rb") as f:
            return f.read()

    def contribute(curve, power, batch, challenge):
        params = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, power, batch)
        pub, priv = Phase1.key_generation(params.spec, derive_rng_from_seed(curve.encode() * 4), blank_hash())
        out = generate_output(params, YES)
        Phase1.computation(challenge, out, NO, YES, CheckForCorrectness.NO, BatchExpMode.AUTO, priv, params,
                           device=dev)
        return params, pub, out

    def verify(params, pub, challenge, response):
        new = generate_output(params, NO)
        Phase1.verification(challenge, response, new, pub, blank_hash(), NO, YES, NO, CheckForCorrectness.NO, FULL,
                            SubgroupCheckMode.AUTO, True, params, rlc_rng=random.Random(5), device=dev)
        return new

    spec = get_curve("bw6_761")
    chunk = read("phase2_chunk")

    def phase2(data, batch):
        buf = bytearray(data) + bytes(Phase2PublicKey.size(spec))
        chunked.contribute(spec, buf, derive_rng_from_seed(b"\x21" * 32), batch, NO, FULL, device=dev)
        return buf

    # warm-up at a small size: builds and loads the kernels, first-use constants
    with torch.no_grad():
        for curve in ("bw6_761", "bls12_377"):
            small = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, WARM_POWER, WARM_BATCH)
            p, pub, out = contribute(curve, WARM_POWER, WARM_BATCH, generate_input(small, NO))
            verify(p, pub, generate_input(small, NO), out)
        phase2(chunk, WARM_BATCH * 16)
    torch.cuda.synchronize()
    wrappers = [o for o in gc.get_objects() if str(getattr(type(o), "__module__", "")).startswith(WRAPPER_MODULES)
                and {"launches", "events"} <= set(getattr(o, "__dict__", ()))]

    steps, digests = {}, {}

    def step(name, fn):
        for w in wrappers:
            w.events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernel = sum(s.elapsed_time(e) for w in wrappers for s, e in w.events) / 1e3
        for w in wrappers:
            w.events = None
        steps[name] = {"wall_seconds": wall, "kernel_seconds": kernel, "device_busy_share": kernel / wall}
        return out

    bw6 = read("challenge_bw6_761")
    params, pub, response = step(STEPS[0], lambda: contribute("bw6_761", BW6_POWER, BATCH, bw6))
    digests["bw6_761 response"] = _blake(response)
    digests["bw6_761 new challenge"] = _blake(step(STEPS[1], lambda: verify(params, pub, bw6, response)))
    bls = read("challenge_bls12_377")
    with torch.no_grad():
        bparams, bpub, bresponse = contribute("bls12_377", BLS_POWER, BATCH, bls)
    digests["bls12_377 new challenge"] = _blake(step(STEPS[2], lambda: verify(bparams, bpub, bls, bresponse)))
    digests["bw6_761 phase2 chunk"] = _blake(step(STEPS[3], lambda: phase2(chunk, BATCH)))
    return {"steps": steps, "digests": digests, "wrappers": len(wrappers)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-form", required=False, help="root of the other checkout (timed first and last)")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "compare_paths.json"))
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)  # child: time the package under this root
    ap.add_argument("--work", default=os.path.join(HERE, "build", "compare_paths"))
    args = ap.parse_args()
    if args.time_tree:
        sys.path.insert(0, args.time_tree)
        import torch

        if not torch.cuda.is_available():
            print("compare_paths: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(time_tree(args.work)), flush=True)
        return 0
    if not args.first_form:
        ap.error("give --first-form DIR")
    import torch

    if not torch.cuda.is_available():
        print("compare_paths: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    make_inputs(args.work)
    inputs_s = time.perf_counter() - t0
    first = os.path.abspath(args.first_form)
    turns = [("parent", first), ("change", HERE), ("change", HERE), ("parent", first)]
    runs = []
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    for label, root in turns:
        cmd = [sys.executable, os.path.abspath(__file__), "--time-tree", root, "--work", args.work]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=1500)
        if done.returncode != 0:
            sys.stderr.write(f"{label} failed:\n{done.stderr[-4000:]}\n")
            return done.returncode or 1
        r = json.loads(done.stdout.strip().splitlines()[-1])
        r["process_seconds"] = time.perf_counter() - t0
        runs.append((label, r))
        print(json.dumps({"turn": label, **r}), flush=True)
    digests = {json.dumps(r["digests"], sort_keys=True) for _, r in runs}
    rows = []
    for name in STEPS:
        row = {"step": name}
        for tree in ("parent", "change"):
            walls = [r["steps"][name]["wall_seconds"] for label, r in runs if label == tree]
            kern = [r["steps"][name]["kernel_seconds"] for label, r in runs if label == tree]
            row[tree] = {"walls": walls, "mean_wall": sum(walls) / len(walls), "spread": max(walls) - min(walls),
                         "kernel_seconds": kern, "device_busy_share": [k / w for k, w in zip(kern, walls)]}
        row["change_over_parent"] = row["change"]["mean_wall"] / row["parent"]["mean_wall"]
        rows.append(row)
    summary = {"nvidia_smi": smi, "order": [label for label, _ in runs], "inputs_seconds": inputs_s,
               "outputs_equal_across_turns": len(digests) == 1, "rows": rows}
    with open(out, "w") as f:
        json.dump({"summary": summary, "runs": runs}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
