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
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .curve import PointVec, plain_group_law


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
        q = fq.modulus
        # the shared-reduction product (fmul2) and the plain additions need 2N < R
        if 2 * q >= fq.spec.mont_r_pow:
            raise ValueError("modulus too close to R for the group-op kernels")
        self.b3w, b3neg = ops._b3_small
        self.b3neg = int(b3neg)

        def words(v: int) -> list[int]:
            return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(self.NL)]

        # field.cuh's FieldConsts: N, R mod N, beta (unused here), n0
        n0 = (-pow(q, -1, 1 << 32)) % (1 << 32)
        consts = words(q) + words(fq.spec.mont_r % q) + [0] * self.NL + [n0]
        self._consts_np = np.array(consts, np.uint32).view(np.int32)
        self._consts_dev: dict = {}
        self._fns: dict = {}
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

    def _planes(self, c: torch.Tensor, batch, B: int) -> tuple[torch.Tensor, int]:
        """(L, B') contiguous planes of one coordinate and its batch stride
        B' (1 or B): a batch-1 operand is read at lane 0 by every thread,
        any other broadcast is materialised."""
        n = math.prod(c.shape[1:])
        if n == 1:
            return c.reshape(self.L, 1).contiguous(), 1
        if c.shape[1:] != batch:
            c = c.expand(self.L, *batch)
        return c.reshape(self.L, B).contiguous(), B

    # -- entry points --------------------------------------------------------
    def double(self, p: PointVec) -> PointVec:
        batch = self._batch_of(p, "double")
        dev = p["x"].device
        if dev.type == "cpu":
            self.dbl.plain_calls += 1
            return plain_group_law(self.ops).double(p)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        B = math.prod(batch)
        ins = [self._planes(p[k], batch, B)[0] for k in "xyz"]
        return self._launch("dbl", ins, batch, B, (B,))

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
        B = math.prod(batch)
        ps = [self._planes(p[k], batch, B) for k in "xyz"]
        qs = [self._planes(q[k], batch, B) for k in "xyz"]
        ins = [t for t, _ in ps] + [t for t, _ in qs]
        return self._launch("add", ins, batch, B, (B, ps[0][1], qs[0][1]))

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
            if kind == "dbl":
                fn = lib.group_dbl_launch
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_uint] * 2 + [
                    ctypes.c_void_p] * 2
            else:
                fn = lib.group_add_launch
                fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 3 + [ctypes.c_uint] * 2 + [
                    ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            self._fns[kind] = fn
        return fn

    def _launch(self, kind: str, ins, batch, B: int, sizes) -> PointVec:
        dev = ins[0].device
        out = [torch.empty((self.L, B), dtype=torch.int32, device=dev) for _ in range(3)]
        shaped = lambda: PointVec(x=out[0].view(self.L, *batch), y=out[1].view(self.L, *batch),
                                  z=out[2].view(self.L, *batch))
        if B == 0:
            return shaped()
        consts = self._consts_dev.get(dev)
        if consts is None:
            consts = self._consts_dev[dev] = torch.from_numpy(self._consts_np).to(dev)
        counter = self.dbl if kind == "dbl" else self.add_k
        fn = self._launch_fn(kind)
        stream = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev):
            if counter.events is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            err = fn(
                *(t.data_ptr() for t in ins), *(o.data_ptr() for o in out), *sizes,
                self.b3w, self.b3neg, consts.data_ptr(), stream.cuda_stream,
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
