"""Data parallelism over the batch (lane) axis on a mesh of devices.

The reference package's module of this name expresses the same schedule
with `jax.sharding` and lets the compiler insert the collectives. Here:

- a mesh is an ordered list of `torch.device`s (`Mesh.devices`);
- a sharded batch (`Sharded`) is a point batch or a tensor cut on its last
  axis into `mesh.size` equal shards, shard i on device i; a batch whose
  width is no multiple of the mesh size is padded first, points with
  infinity and scalars with 0, and the padding is dropped when the shards
  are gathered;
- each shard's launches go to its own device (CUDA launches are
  asynchronous, so the shards overlap);
- a reduction adds per-shard partial sums: the partials are copied onto the
  first device with `.to()` and added there with the group law (curve
  points have no integer `psum`);
- the inverse group FFT runs `ntt/group_fft.py: GroupFFT`'s butterflies on
  each shard; the stages whose blocks span shards exchange the halves
  between the two devices of each pair.

Every value is the single-device one, lane for lane: per-lane kernels see
the same operands, and only the order in which partial sums are added
differs, which changes a sum's projective form but not its point.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.curve import CurveOps, PointVec
from ..ops.lanes import cat, lanewise
from ..utils.device import resolve_device


class Mesh:
    """An ordered list of devices; shard i of a batch lives on devices[i]."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


class Sharded(list):
    """A batch cut on its last axis: one PointVec or tensor per mesh device,
    all of one width; `width` is the batch's width before padding."""

    def __init__(self, mesh: Mesh, shards, width: int):
        super().__init__(shards)
        self.mesh = mesh
        self.width = width


def make_mesh(n_devices: int | None = None, devices=None, device=None) -> Mesh:
    """A 1-D mesh: the given `devices` (the same device may appear more than
    once), else the first `n_devices` cards (default: all of them), or, when
    the caller asks for the CPU, `n_devices` entries of the CPU device."""
    if devices is not None:
        return Mesh(devices)
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return Mesh(cards[: n_devices or len(cards)])
    return Mesh([dev] * (n_devices or 1))


def on_device(dev: torch.device):
    """The context in which a shard's launches go to its own card."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def width(operand) -> int:
    """Lanes of a batch: a PointVec, a tensor / array, or a Sharded."""
    if isinstance(operand, Sharded):
        return operand.width
    return int((operand["x"] if isinstance(operand, dict) else operand).shape[-1])


def padded_width(shards: Sharded) -> int:
    """Lanes of a sharded batch with its padding."""
    return len(shards) * width(shards[0])


def _bounds(mesh: Mesh, n: int) -> list[tuple[int, int]]:
    s = -(-n // mesh.size)
    return [(i * s, (i + 1) * s) for i in range(mesh.size)]


def shard_points(mesh: Mesh, ops: CurveOps, pts) -> Sharded:
    """`pts` padded with infinity to a multiple of the mesh size and cut into
    equal shards, shard i copied to mesh.devices[i] (already sharded: as is)."""
    if isinstance(pts, Sharded):
        return pts
    n = width(pts)
    padded = -(-n // mesh.size) * mesh.size
    if padded > n:
        pts = cat([pts, ops.infinity((padded - n,), pts["x"].device)])
    return Sharded(mesh, [PointVec({k: v[..., lo:hi] for k, v in pts.items()}).to(dev)
                          for (lo, hi), dev in zip(_bounds(mesh, padded), mesh.devices)], n)


def shard_lanes(mesh: Mesh, operand, n: int | None = None) -> Sharded:
    """A tensor or numpy array (lanes last) zero-padded to `n` lanes (default:
    its own width rounded up to the mesh size) and cut like shard_points;
    tensors are copied to their shard's device, arrays stay on the host."""
    if isinstance(operand, Sharded):
        return operand
    w = int(operand.shape[-1])
    n = -(-w // mesh.size) * mesh.size if n is None else n
    if isinstance(operand, np.ndarray):
        if n > w:
            operand = np.concatenate([operand, np.zeros((*operand.shape[:-1], n - w), operand.dtype)], axis=-1)
        return Sharded(mesh, [np.ascontiguousarray(operand[..., lo:hi]) for lo, hi in _bounds(mesh, n)], w)
    if n > w:
        operand = torch.cat([operand, operand.new_zeros((*operand.shape[:-1], n - w))], dim=-1)
    return Sharded(mesh, [operand[..., lo:hi].to(dev) for (lo, hi), dev in zip(_bounds(mesh, n), mesh.devices)], w)


def gather_points(shards: Sharded) -> PointVec:
    """The shards put back together on the mesh's first device, padding
    dropped."""
    first = shards.mesh.devices[0]
    whole = cat([p.to(first) for p in shards])
    return PointVec({k: v[..., : shards.width] for k, v in whole.items()})


def map_shards(fn, *operands) -> list:
    """fn(shard of each operand) on each shard's device. The operands are
    Sharded batches over one mesh, cut alike."""
    first = operands[0]
    out = []
    for i, dev in enumerate(first.mesh.devices):
        with on_device(dev):
            out.append(fn(*(o[i] for o in operands)))
    return out


def reduce_partials(ops: CurveOps, mesh: Mesh, partials: list) -> PointVec:
    """Per-shard point batches of one shape added lane by lane across the
    shards: gathered onto the first device as one more (last) axis, then one
    tree reduction with the group law."""
    first = mesh.devices[0]
    stacked = PointVec({k: torch.stack([p[k].to(first) for p in partials], dim=-1) for k in ("x", "y", "z")})
    return PointVec({k: v[..., 0] for k, v in ops.sum_reduce(stacked).items()})


def sharded_batch_exp_fn(ops: CurveOps, mesh: Mesh):
    """(points, scalars) -> points: the GLV scalar-mul elementwise over the
    sharded batch, with no communication; the result gathered on the first
    device."""

    def f(pts, scalars):
        p = shard_points(mesh, ops, pts)
        s = shard_lanes(mesh, scalars, padded_width(p))
        return gather_points(Sharded(mesh, map_shards(ops.scalar_mul, p, s), p.width))

    return f


def sharded_msm_fn(ops: CurveOps, mesh: Mesh):
    """(points, scalars) -> one point: a partial MSM per shard (GLV
    scalar-mul and tree reduction), one point per shard gathered onto the
    first device and reduced there."""

    def f(pts, scalars):
        p = shard_points(mesh, ops, pts)
        s = shard_lanes(mesh, scalars, padded_width(p))
        return reduce_partials(ops, mesh, map_shards(ops.msm, p, s))

    return f


def sharded_step_fn(ops: CurveOps, mesh: Mesh):
    """(points, scalars) -> (points, msm point): the contribution step and
    verification's cross-shard MSM reduction from one ladder per shard."""

    def f(pts, scalars):
        p = shard_points(mesh, ops, pts)
        s = shard_lanes(mesh, scalars, padded_width(p))
        prods = map_shards(ops.scalar_mul, p, s)
        partials = map_shards(ops.sum_reduce, Sharded(mesh, prods, p.width))
        return gather_points(Sharded(mesh, prods, p.width)), reduce_partials(ops, mesh, partials)

    return f


def sharded_group_ifft_fn(curve_name: str, group: str, n: int, mesh: Mesh):
    """PointVec -> PointVec: the inverse group FFT of n points with the batch
    sharded over the mesh (n a multiple of the mesh size).

    After the bit-reverse permutation (an all-to-all: each shard takes its
    lanes from every shard), the stages whose blocks of m points fit in a
    shard run on each shard alone; in the log2(mesh size) stages whose
    blocks span shards, shard e of a block's even half pairs with shard o of
    its odd half: o multiplies its points by their twiddles, sends the
    products to e and receives e's points, then e keeps even + t and o
    keeps even - t. The 1/n scale is elementwise. The result is gathered
    on the first device."""
    from ..ntt.group_fft import _bit_reverse_indices, group_fft

    gf = group_fft(curve_name, group, n)
    ops, D = gf.ops, mesh.size
    if n % D:
        raise ValueError(f"{n} points do not cut into {D} equal shards")
    s = n // D
    rev = _bit_reverse_indices(n)

    def permuted(shards) -> list:
        out = []
        for i, dev in enumerate(mesh.devices):
            src = rev[i * s : (i + 1) * s]
            owner = src // s
            pieces, positions = [], []
            for k, kdev in enumerate(mesh.devices):
                sel = np.nonzero(owner == k)[0]
                if sel.size:
                    idx = torch.from_numpy(src[sel] % s).to(kdev)
                    pieces.append(PointVec({c: v.index_select(-1, idx) for c, v in shards[k].items()}).to(dev))
                    positions.append(sel)
            order = torch.from_numpy(np.argsort(np.concatenate(positions))).to(dev)
            out.append(PointVec({c: v.index_select(-1, order) for c, v in cat(pieces).items()}))
        return out

    def f(p: PointVec) -> PointVec:
        if width(p) != n:
            raise ValueError(f"expected {n} points, got {width(p)}")
        x = permuted(shard_points(mesh, ops, p))
        tables = {dev: gf.tables(True, dev) for dev in set(mesh.devices)}
        m = 2
        while m <= n:
            k = (m // 4).bit_length() - 1  # stage table index: m = 4 << k
            half = m // 2
            if m <= s:  # blocks inside a shard: shard-local butterflies
                for i, dev in enumerate(mesh.devices):
                    tw = None if m == 2 else tables[dev][1][k][..., i * s // 2 : (i + 1) * s // 2]
                    with on_device(dev):
                        x[i] = gf._butterflies(x[i], m, tw)
            else:  # blocks span m // s shards: exchange between pairs
                span = m // s
                new = list(x)
                for b in range(D // span):
                    for q in range(span // 2):
                        e, o = b * span + q, b * span + q + span // 2
                        de, do = mesh.devices[e], mesh.devices[o]
                        with on_device(do):
                            if m == 2:
                                t = x[o]
                            else:
                                lo = b * half + q * s
                                t = lanewise(ops.scalar_mul, x[o], tables[do][1][k][..., lo : lo + s])
                            even = x[e].to(do)
                            new[o] = lanewise(ops.add, even, ops.neg(t))
                        with on_device(de):
                            new[e] = lanewise(ops.add, x[e], t.to(de))
                x = new
            m <<= 1
        for i, dev in enumerate(mesh.devices):
            with on_device(dev):
                x[i] = lanewise(ops.scalar_mul, x[i], tables[dev][2][..., i * s : (i + 1) * s])
        return gather_points(Sharded(mesh, x, n))

    return f
