"""Whole GLV windowed ladder: CUDA kernel wrapper and its plain PyTorch
version.

`FusedGLVLadder.__call__` takes a point batch ((L, B) int32 limb planes,
Montgomery, projective), the two digit planes and the two sign masks from
`GLVDigits`, and returns the projective result [k]P per lane. A CUDA tensor
launches ``csrc/glv_ladder.cu`` (or raises); a CPU tensor runs
`glv_ladder_plain`. Both follow one schedule — sign-adjusted base, 16-entry
table, beta-multiplied endomorphism table, then per window four doublings
and two complete additions — and every field operation is canonical, so
their outputs are equal limb for limb, X, Y and Z alike.

The kernel runs one team of threads of a warp per lane on the cooperative
layer (``csrc/field_team.cuh``, the group law of ``csrc/group_team.cuh``
that the group-op kernel K2 shares), each thread keeping its slice of the
16-entry tables in local memory; its modulus constants and beta reach it by
value (`ladder_consts`).

Replaces the reference's FusedGLVLadder (ops/pallas_ladder.py).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .cuda_group import team_consts
from .curve import PointVec, plain_group_law

WINDOW = 4


def ladder_consts(fq, beta: int) -> np.ndarray:
    """The constants block the kernel's parameter is packed from, as uint32
    words: beta (Montgomery form, NL words), then csrc/field_team.cuh's
    TeamConsts (N, R mod N, n0). `beta` is in standard form."""
    NL = fq.L // 2
    beta_mont = beta * fq.spec.mont_r % fq.modulus
    words = [(beta_mont >> (32 * i)) & 0xFFFFFFFF for i in range(NL)]
    return np.concatenate([np.array(words, np.uint32), team_consts(fq)])


def glv_ladder_plain(ops, pts: PointVec, d1, d2, neg1, flip) -> PointVec:
    """Plain PyTorch version, built from CurveOps' stacked group law with
    every product in plain PyTorch (no kernel launch on any device)."""
    ops = plain_group_law(ops)
    F = ops.field
    neg1 = neg1.bool()
    flip = flip.bool()
    base = ops.select(neg1, ops.neg(pts), pts)
    t1 = ops._window_table(base)
    t2 = {
        "x": ops.fq.mont_mul(t1["x"], ops._const("beta_np", t1["x"])),
        "y": F.select(flip, F.neg(t1["y"]), t1["y"]),
        "z": t1["z"],
    }
    acc = ops.infinity((pts["x"].shape[-1],), pts["x"].device)
    for k in range(d1.shape[0]):
        acc = ops._window_doubles(acc, WINDOW)
        acc = ops.add(acc, ops._select_entry(t1, d1[k]))
        acc = ops.add(acc, ops._select_entry(t2, d2[k]))
    return acc


class FusedGLVLadder:
    """Ladder wrapper for one CurveOps; keeps the kernel's constants and
    counts launches. `team` (threads a lane) is read from the library at
    its first launch."""

    def __init__(self, ops):
        if ops.glv is None or ops._b3_small is None:
            raise NotImplementedError(
                f"{ops.spec.name} {ops.group_name}: the ladder kernel needs the GLV "
                "endomorphism and a small |3b|"
            )
        self.ops = ops
        fq = ops.fq
        self.L = fq.L
        self.NL = fq.L // 2
        # the team layer's products and additions need 2N < R
        if 2 * fq.modulus >= fq.spec.mont_r_pow:
            raise ValueError("modulus too close to R for the ladder kernel")
        self.b3w, b3neg = ops._b3_small
        self.b3neg = int(b3neg)
        self._consts_host = ladder_consts(fq, ops.glv.p.beta)  # by value into the kernel's parameter
        self._fn = None
        self.team: int | None = None
        self.launches = 0
        self.widths: collections.Counter = collections.Counter()  # launches by lane count
        self.plain_calls = 0
        # when set to a list, every launch appends its (start, end) CUDA
        # timing events: lets a caller sum the time spent inside the kernel
        self.events: list | None = None

    def _launch_fn(self):
        if self._fn is None:
            from .build import TARGETS, load

            target = f"glv_ladder_nl{self.NL}"
            if target not in TARGETS:
                raise NotImplementedError(f"no ladder kernel is instantiated for {self.L} limbs")
            lib = load(target)
            if lib.glv_ladder_nl() != self.NL:
                raise RuntimeError(f"{target} was built for another limb count")
            self.team = lib.glv_ladder_team()
            fn = lib.glv_ladder_launch
            fn.argtypes = (
                [ctypes.c_void_p] * 10
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_uint]
                + [ctypes.c_void_p] * 2
            )
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, pts: PointVec, d1, d2, neg1, flip) -> PointVec:
        """pts: PointVec of (L, B) coords; d1/d2: (nwin, B) MSB-first w=4
        digit planes; neg1/flip: (B,) 0/1 masks — all int32, one device."""
        x = pts["x"]
        B = x.shape[-1]
        nwin = d1.shape[0]
        tensors = [pts["x"], pts["y"], pts["z"], d1, d2, neg1, flip]
        shapes = [(self.L, B)] * 3 + [(nwin, B)] * 2 + [(B,)] * 2
        for t, shape in zip(tensors, shapes):
            if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != x.device:
                raise ValueError(
                    f"ladder operand must be int32 {shape} on {x.device}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
        if x.device.type == "cpu":
            self.plain_calls += 1
            return glv_ladder_plain(self.ops, pts, d1, d2, neg1, flip)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return self._launch([t.contiguous() for t in tensors], B, nwin)

    def _launch(self, tensors, B: int, nwin: int) -> PointVec:
        dev = tensors[0].device
        out = [torch.empty((self.L, B), dtype=torch.int32, device=dev) for _ in range(3)]
        if B == 0:
            return PointVec(x=out[0], y=out[1], z=out[2])
        fn = self._launch_fn()
        stream = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev):
            if self.events is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            err = fn(
                *(t.data_ptr() for t in tensors), *(o.data_ptr() for o in out),
                B, nwin, self.b3w, self.b3neg, self._consts_host.ctypes.data,
                stream.cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"glv_ladder kernel launch failed: CUDA error {err}")
        self.launches += 1
        self.widths[B] += 1
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self.events.append((start, end))
        return PointVec(x=out[0], y=out[1], z=out[2])


@functools.lru_cache(maxsize=None)
def _ladder_of(ops) -> FusedGLVLadder:
    return FusedGLVLadder(ops)


def fused_ladder_for(curve_name: str, group: str) -> FusedGLVLadder:
    """The one ladder wrapper (and launch count) of a (curve, group)."""
    from .curve import curve_ops

    return _ladder_of(curve_ops(curve_name, group))
