"""Complete group doubling and addition, one launch each (K2): CUDA kernel
wrapper and its plain PyTorch version.

`GroupOps.double(p)` and `GroupOps.add(p, q)` take point batches of
(L, *batch) int32 limb planes (Montgomery, projective, infinity (0 : 1 : 0))
and return the complete RCB double (Alg. 9) or sum (Alg. 7) per lane. A CUDA
tensor launches ``csrc/group_ops.cu`` (or raises); a CPU tensor runs the
plain version, the stacked group law of ops/curve.py over K5's counted
`plain` method (pure PyTorch on any device). Every field operation of both is
canonical, so their projective X, Y, Z agree limb for limb.

Scope: degree-1 coordinates with a = 0 and a small |3b| (G1 of BLS12-377 /
381, both groups of BW6-761), as the reference's kernels assert; other
groups raise. Replaces the reference's PallasGroupOps (ops/pallas_group.py).

The kernel runs on the cooperative layer of ``csrc/field_team.cuh`` (a team
of threads per lane) and reads every operand in place through its lane
layout (`lane_layout`): contiguous batches, batch-1 operands, broadcasts and
the strided views that `sum_reduce` and the Pippenger lane merge pass, with
no copy. Only a view whose batch axes need more than two strided levels is
copied first.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .curve import PointVec, plain_group_law

MAX_LANES = (1 << 31) - 1  # the kernel splits lane indices with 32-bit division


def team_consts(fq) -> np.ndarray:
    """csrc/field_team.cuh's TeamConsts block as uint32 words: N (NL
    words), R mod N (NL words), n0 = -N^{-1} mod 2^32."""
    NL, q = fq.L // 2, fq.modulus

    def words(v: int) -> list[int]:
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(NL)]

    n0 = (-pow(q, -1, 1 << 32)) % (1 << 32)
    return np.array(words(q) + words(fq.spec.mont_r % q) + [n0], np.uint32)


def lane_layout(shape, strides) -> tuple[int, int, int] | None:
    """(inner, s1, s2) such that lane b of the flattened batch axes
    (`shape`, element `strides`) sits at storage offset
    (b // inner) * s1 + (b % inner) * s2: the axes merged into at most two
    strided levels. None where the view needs more levels."""
    dims: list[tuple[int, int]] = []
    for n, st in zip(shape, strides):
        if n == 1:
            continue
        if dims and dims[-1][1] == st * n:
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if not dims:
        return 1, 0, 0
    if len(dims) == 1:
        return dims[0][0], 0, dims[0][1]
    if len(dims) == 2:
        return dims[1][0], dims[0][1], dims[1][1]
    return None


class _Kernel:
    """Counters of one of the two kernels: `launches` where the kernel is
    launched, `plain_calls` where the plain version runs instead; `events`,
    when set to a list, collects a (start, end) CUDA event pair per launch."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0
        self.events: list | None = None


class GroupOps:
    """K2 wrapper for one CurveOps; keeps the field constants per device.
    `dbl` and `add_k` hold the two kernels' counters."""

    def __init__(self, ops):
        if ops.field.degree != 1 or not ops.a_is_zero or ops._b3_small is None:
            raise NotImplementedError(
                f"{ops.spec.name} {ops.group_name}: the group-op kernels need Fq "
                "coordinates, a = 0 and a small |3b|"
            )
        self.ops = ops
        fq = ops.fq
        self.L = fq.L
        self.NL = fq.L // 2
        # the shared-reduction product (fmul2) and the plain additions need 2N < R
        if 2 * fq.modulus >= fq.spec.mont_r_pow:
            raise ValueError("modulus too close to R for the group-op kernels")
        self.b3w, b3neg = ops._b3_small
        self.b3neg = int(b3neg)
        self._consts_host = team_consts(fq)  # by value into the kernel's parameter
        self._fns: dict = {}
        self.team: int | None = None  # threads per lane, read from the library at first launch
        self.dbl = _Kernel("group_dbl")
        self.add_k = _Kernel("group_add")

    # -- operand checks ----------------------------------------------------
    def _batch_of(self, p: PointVec, what: str) -> torch.Size:
        x = p["x"]
        for k in "xyz":
            c = p[k]
            if c.dtype != torch.int32 or c.ndim < 2 or c.shape[0] != self.L or c.shape != x.shape:
                raise ValueError(
                    f"{what}: coordinates must be int32 ({self.L}, *batch) of one shape, "
                    f"got {c.dtype} {tuple(c.shape)}"
                )
            if c.device != x.device:
                raise ValueError(f"{what}: coordinates on different devices")
        return x.shape[1:]

    def operand(self, c: torch.Tensor, batch) -> tuple[torch.Tensor, list[int]]:
        """One coordinate as the kernel reads it: the tensor (kept alive
        for the launch) and its descriptor [pointer, plane stride, inner,
        s1, s2] (`lane_layout` of the view broadcast to `batch`). A batch-1
        operand gets zero strides; a view of three or more unmergeable
        strided levels is copied to contiguous planes first (no caller of
        the package passes one)."""
        if math.prod(c.shape[1:]) == 1:
            return c, [c.data_ptr(), c.stride(0), 1, 0, 0]
        v = c.expand(self.L, *batch) if c.shape[1:] != batch else c
        lay = lane_layout(v.shape[1:], v.stride()[1:])
        if lay is None:
            v = v.contiguous()
            lay = lane_layout(v.shape[1:], v.stride()[1:])
        return v, [v.data_ptr(), v.stride(0), *lay]

    # -- entry points --------------------------------------------------------
    def double(self, p: PointVec) -> PointVec:
        batch = self._batch_of(p, "double")
        dev = p["x"].device
        if dev.type == "cpu":
            self.dbl.plain_calls += 1
            return plain_group_law(self.ops).double(p)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        return self._launch("dbl", [self.operand(p[k], batch) for k in "xyz"], batch)

    def add(self, p: PointVec, q: PointVec) -> PointVec:
        pb, qb = self._batch_of(p, "add: p"), self._batch_of(q, "add: q")
        dev = p["x"].device
        if q["x"].device != dev:
            raise ValueError("add: operands on different devices")
        if dev.type == "cpu":
            self.add_k.plain_calls += 1
            return plain_group_law(self.ops).add(p, q)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        batch = torch.broadcast_shapes(pb, qb)
        return self._launch("add", [self.operand(t[k], batch) for t in (p, q) for k in "xyz"], batch)

    # -- launch ------------------------------------------------------------
    def _launch_fn(self, kind: str):
        fn = self._fns.get(kind)
        if fn is None:
            from .build import TARGETS, load

            target = f"group_ops_nl{self.NL}"
            if target not in TARGETS:
                raise NotImplementedError(f"no group-op kernel is instantiated for {self.L} limbs")
            lib = load(target)
            if lib.group_ops_nl() != self.NL:
                raise RuntimeError(f"{target} was built for another limb count")
            self.team = lib.group_ops_team()
            fn = lib.group_dbl_launch if kind == "dbl" else lib.group_add_launch
            # operand descriptors, ox, oy, oz, B, b3w, b3neg, constants, stream
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_uint] * 2 + [
                ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            self._fns[kind] = fn
        return fn

    def _launch(self, kind: str, ins, batch) -> PointVec:
        dev = ins[0][0].device
        B = math.prod(batch)
        if B > MAX_LANES:
            raise ValueError(f"at most {MAX_LANES} lanes a launch, got {B}")
        out = [torch.empty((self.L, B), dtype=torch.int32, device=dev) for _ in range(3)]
        shaped = lambda: PointVec(x=out[0].view(self.L, *batch), y=out[1].view(self.L, *batch),
                                  z=out[2].view(self.L, *batch))
        if B == 0:
            return shaped()
        desc = np.array([d for _, d in ins], dtype=np.int64)
        counter = self.dbl if kind == "dbl" else self.add_k
        fn = self._launch_fn(kind)
        stream = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev):
            if counter.events is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            err = fn(
                desc.ctypes.data, *(o.data_ptr() for o in out), B, self.b3w, self.b3neg,
                self._consts_host.ctypes.data, stream.cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"{counter.name} kernel launch failed: CUDA error {err}")
        counter.launches += 1
        if counter.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            counter.events.append((start, end))
        return shaped()


@functools.lru_cache(maxsize=None)
def _group_ops_of(ops) -> GroupOps:
    return GroupOps(ops)


def group_ops_for(curve_name: str, group: str) -> GroupOps:
    """The one K2 wrapper (and launch counts) of a (curve, group)."""
    from .curve import curve_ops

    return _group_ops_of(curve_ops(curve_name, group))
