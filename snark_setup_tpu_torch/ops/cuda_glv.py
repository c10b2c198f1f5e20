"""GLV decomposition + window-digit extraction: CUDA kernel wrapper and its
plain PyTorch version.

`GLVDigits.__call__` maps (Ls, B) raw standard-form scalar limbs to what the
ladder consumes: two (nwin, B) planes of MSB-first 4-bit digits (of |k1| and
|k2|) and two (B,) masks — `neg1` (k1 < 0) and `flip` (sign(k1) != sign(k2)).
A CUDA tensor launches the kernel ``csrc/glv_digits.cu`` (or raises); a CPU
tensor runs `glv_digits_plain`. Nothing falls back from one to the other.

Replaces the reference's PallasGLVDigits (ops/pallas_glv.py); the exact
integer model of both is GLVOps.decompose_host.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

WINDOW = 4
_MAXL = 64  # limb capacity of the kernel's per-thread arrays (csrc/glv_digits.cu)
_NCONST = 400


def glv_digits_plain(ops, scalars_raw: torch.Tensor):
    """Plain PyTorch version: GLVOps.decompose + scalar_digits_msb.
    Returns (d1, d2, neg1, flip) as int32 tensors."""
    nbits = ops.glv.p.nbits
    m1, neg1, m2, neg2 = ops.glv.decompose(scalars_raw)
    d1 = ops.scalar_digits_msb(m1, WINDOW, nbits)
    d2 = ops.scalar_digits_msb(m2, WINDOW, nbits)
    return (
        d1.contiguous(),
        d2.contiguous(),
        neg1.to(torch.int32),
        (neg1 != neg2).to(torch.int32),
    )


class GLVDigits:
    """Digits wrapper for one CurveOps; keeps the kernel's constant tensor
    per device and counts launches."""

    def __init__(self, ops):
        if ops.glv is None:
            raise ValueError(f"{ops.spec.name} {ops.group_name} has no GLV endomorphism")
        self.ops = ops
        self.glv = g = ops.glv
        self.Ls = ops.fr.L
        self.nwin = -(-g.p.nbits // WINDOW)
        self.launches = 0
        self.plain_calls = 0
        # when set to a list, every launch appends its (start, end) CUDA
        # timing events: lets a caller sum the time spent inside the kernel
        self.events: list | None = None
        self._consts_np = self._pack_consts()
        self._consts_dev: dict = {}
        self._fn = None

    def _pack_consts(self) -> np.ndarray:
        """The kernel's constant block (layout documented in the source)."""
        g = self.glv
        limbs = [*g.mu, *(t[1] if t else np.zeros(0, np.uint32) for t in (*g.k1_terms, *g.k2_terms))]
        widest = max(
            self.Ls + max(len(m) for m in g.mu), g.S_limbs + g.Lc, g.LT, *(len(a) for a in limbs)
        )
        if widest > _MAXL or g.Lh > g.LT or 4 * g.Lh < self.nwin:
            raise ValueError("GLV geometry exceeds the digits kernel's limb capacity")
        c = np.zeros(_NCONST, np.int64)
        c[:8] = [self.Ls, g.S_limbs, g.Lc, g.LT, g.Lh, self.nwin, len(g.mu[0]), len(g.mu[1])]
        for t, term in enumerate((*g.k1_terms, *g.k2_terms)):
            if term is not None:
                sgn, coeff = term
                c[8 + 2 * t] = 1 if sgn > 0 else 2
                c[9 + 2 * t] = len(coeff)
        for i, arr in enumerate(limbs):
            c[16 + 64 * i : 16 + 64 * i + len(arr)] = arr
        return c.astype(np.int32)

    def _launch_fn(self):
        if self._fn is None:
            from .build import load

            fn = load("glv_digits").glv_digits_launch
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, scalars_raw: torch.Tensor):
        """(Ls, B) int32 raw scalar limbs -> (d1, d2, neg1, flip), all int32
        on the input's device."""
        if scalars_raw.dtype != torch.int32 or scalars_raw.ndim != 2 or scalars_raw.shape[0] != self.Ls:
            raise ValueError(
                f"scalars must be int32 ({self.Ls}, B), got {scalars_raw.dtype} {tuple(scalars_raw.shape)}"
            )
        if scalars_raw.device.type == "cpu":
            self.plain_calls += 1
            return glv_digits_plain(self.ops, scalars_raw)
        if scalars_raw.device.type != "cuda":
            raise ValueError(f"unsupported device {scalars_raw.device}")
        return self._launch(scalars_raw.contiguous())

    def _launch(self, k: torch.Tensor):
        dev = k.device
        B = k.shape[1]
        consts = self._consts_dev.get(dev)
        if consts is None:
            consts = self._consts_dev[dev] = torch.from_numpy(self._consts_np).to(dev)
        d1 = torch.empty((self.nwin, B), dtype=torch.int32, device=dev)
        d2 = torch.empty((self.nwin, B), dtype=torch.int32, device=dev)
        neg = torch.empty((B,), dtype=torch.int32, device=dev)
        flip = torch.empty((B,), dtype=torch.int32, device=dev)
        if B == 0:
            return d1, d2, neg, flip
        fn = self._launch_fn()
        stream = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev):
            if self.events is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            err = fn(
                k.data_ptr(), consts.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                neg.data_ptr(), flip.data_ptr(), B, stream.cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"glv_digits kernel launch failed: CUDA error {err}")
        self.launches += 1
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self.events.append((start, end))
        return d1, d2, neg, flip


@functools.lru_cache(maxsize=None)
def _digits_of(ops) -> GLVDigits:
    return GLVDigits(ops)


def glv_digits_for(curve_name: str, group: str) -> GLVDigits:
    """The one digits wrapper (and launch count) of a (curve, group)."""
    from .curve import curve_ops

    return _digits_of(curve_ops(curve_name, group))
