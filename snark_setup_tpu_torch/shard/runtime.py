"""Runtime of the contribution hot loop: one device, or a mesh of them.

When a mesh is active (`active_mesh`), `put_points` / `put_scalars` cut a
batch over it (shard/mesh.py), `scalar_mul` runs the ladder on every shard
and gathers the products, and `reduce_over` adds per-shard partial sums
across the shards; `phase1/protocol.py`'s verification reduces its RLC MSMs
and subset sums that way. With no mesh every function is the single-device
code: placement is a copy to the chosen device and the pad width is the
identity.

Policy (the reference package's `shard/runtime.py`): `SNARK_SETUP_SHARD` is
`auto` (default), `0` / `off` / `false` or `1`. Under `auto` a mesh spans
the cards when there are two or more, and never the CPU; `1` also builds one
on the CPU, of `SNARK_SETUP_SHARD_DEVICES` entries of the CPU device (the
counterpart of the reference tests' virtual CPU devices: the split, pad,
placement and gather code run with the plain versions). On cards,
`SNARK_SETUP_SHARD_DEVICES` bounds the mesh. The mesh takes the largest
power of two of its devices and is None below 2. The decision is cached per
device type (`reset_mesh_cache` drops it).

No batch-width guard is carried over: the reference's lane bounds worked
around compiler faults of its backend and have no counterpart here. The only
bound on a batch is the card's memory — the ladder kernel needs ~8 KB of
local memory per resident thread and 6 L + 2 nwin + 2 words of global memory
per lane; the ladder over the group law (Fp2 / Fp3 coordinates, MNT curves)
keeps a 16-entry table of 48 L d words per lane and a few stacked rounds of
6 L d T words (T = 9 tower products for Fp3): about 0.1 MB per lane at
L = 48, d = 3, so 16384 lanes take ~2 GB, far below 80 GB.
"""

from __future__ import annotations

import os

import torch

from ..ops.curve import CurveOps, PointVec
from ..utils.device import resolve_device
from . import mesh as _mesh
from .mesh import Mesh, Sharded, width

_mesh_cache: dict = {}


def _shard_flag() -> str:
    return os.environ.get("SNARK_SETUP_SHARD", "auto").lower()


def reset_mesh_cache() -> None:
    """Drop the cached mesh decisions (tests flip the variables at run time)."""
    _mesh_cache.clear()


def active_mesh(device=None) -> Mesh | None:
    """The mesh of the device type `device` names (default: the cards), or
    None when running on one device — or on none: without a card there is
    no mesh of cards, and the entry points that compute raise there when
    they resolve their device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        return None
    if dev.type not in _mesh_cache:
        _mesh_cache[dev.type] = _decide_mesh(dev)
    return _mesh_cache[dev.type]


def _decide_mesh(dev: torch.device) -> Mesh | None:
    flag = _shard_flag()
    if flag in ("0", "off", "false"):
        return None
    bound = os.environ.get("SNARK_SETUP_SHARD_DEVICES")
    if dev.type == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif flag == "auto":
        return None
    else:
        devs = [dev] * int(bound or 1)
    n = min(len(devs), int(bound)) if bound else len(devs)
    # even shards want a power-of-two count (small pads; the FFT needs it)
    while n & (n - 1):
        n &= n - 1
    if n < 2:
        return None
    return Mesh(devs[:n])


def mesh_size(device=None) -> int:
    m = active_mesh(device)
    return 1 if m is None else m.size


def pad_width(pad: int, device=None) -> int:
    """A batch pad size rounded up to a multiple of the mesh size, so that
    the batch cuts into equal shards. Identity on one device."""
    n = mesh_size(device)
    return -(-pad // n) * n


def put_points(ops: CurveOps, pts: PointVec, device=None):
    """Place a point batch on the device (default: the card), or cut it over
    the active mesh (a `Sharded`)."""
    m = active_mesh(device)
    if m is None:
        return pts.to(resolve_device(device))
    return _mesh.shard_points(m, ops, pts)


def put_scalars(ops: CurveOps, scalars: torch.Tensor, device=None):
    m = active_mesh(device)
    if m is None:
        return scalars.to(resolve_device(device))
    return _mesh.shard_lanes(m, scalars)


def gather(pts) -> PointVec:
    """A batch from `put_points` as one PointVec (on the mesh's first
    device); a PointVec as is."""
    return _mesh.gather_points(pts) if isinstance(pts, Sharded) else pts


def reduce_over(ops: CurveOps, fn, pts, *lane_args) -> PointVec:
    """fn(points, *lane_args): a point batch of sums over the lanes (an MSM,
    subset sums). On a batch from `put_points` over a mesh, fn runs on each
    shard with its lanes of every argument (tensors or numpy arrays, lanes
    last, as wide as the padded batch) and the partial sums are added across
    the shards on the first device."""
    if not isinstance(pts, Sharded):
        return fn(pts, *lane_args)
    args = [_mesh.shard_lanes(pts.mesh, a, _mesh.padded_width(pts)) for a in lane_args]
    return _mesh.reduce_partials(ops, pts.mesh, _mesh.map_shards(fn, pts, *args))


def all_over(fn, pts) -> torch.Tensor:
    """fn(points) -> a boolean tensor, all of it true, per shard: one flag."""
    if not isinstance(pts, Sharded):
        return fn(pts).all()
    first = pts.mesh.devices[0]
    return torch.stack([f.all().to(first) for f in _mesh.map_shards(fn, pts)]).all()


def scalar_mul(ops: CurveOps, pts, scalars_raw, device=None) -> PointVec:
    """The contribution hot loop's batch scalar-mul: [k mod r]P per lane for
    subgroup points, through the port's kernels on the card (GLV digits and
    ladder, or the stacked-product kernel under the group law) and their
    plain versions when the caller asked for the CPU. Over an active mesh
    each shard runs on its own device and the products are gathered on the
    first."""
    m = active_mesh(device)
    with torch.no_grad():
        if m is None:
            dev = resolve_device(device)
            return ops.scalar_mul(pts.to(dev), scalars_raw.to(dev))
        return _mesh.sharded_batch_exp_fn(ops, m)(pts, scalars_raw)
