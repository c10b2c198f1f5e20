"""GLV decomposition + window-digit extraction: CUDA kernel wrapper and its
plain PyTorch version.

`GLVDigits.__call__` maps (Ls, B) raw standard-form scalar limbs to what the
ladder consumes: two (nwin, B) planes of MSB-first 4-bit digits (of |k1| and
|k2|) and two (B,) masks — `neg1` (k1 < 0) and `flip` (sign(k1) != sign(k2)).
A CUDA tensor launches the kernel ``csrc/glv_digits.cu`` (or raises); a CPU
tensor runs `glv_digits_plain`. Nothing falls back from one to the other.

The kernel's shapes are compile-time, one library per curve; its constants
reach it by value (`digits_consts`).

Replaces the reference's PallasGLVDigits (ops/pallas_glv.py); the exact
integer model of both is GLVOps.decompose_host.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

WINDOW = 4


def digits_geometry(ops) -> dict:
    """The compile-time shapes of the digits kernel for one (curve, group):
    scalar limbs LS, rounded-quotient limbs LC, working width LT, magnitude
    limbs LH, windows NWIN, and the zero-padded limb counts of the Barrett
    reciprocals (MU) and of the lattice coefficients (CO)."""
    g = ops.glv
    coeffs = [t[1] for t in (*g.k1_terms, *g.k2_terms) if t is not None]
    return {
        "LS": ops.fr.L, "LC": g.Lc, "LT": g.LT, "LH": g.Lh, "NWIN": -(-g.p.nbits // WINDOW),
        "MU": max(len(m) for m in g.mu), "CO": max(len(c) for c in coeffs),
    }


def digits_consts(ops) -> np.ndarray:
    """csrc/glv_digits.cu's DigitsConsts block as uint32 words: mu[2][MU]
    (16-bit limbs), coeff[4][CO] (the terms k1: c_1, c_2; k2: c_1, c_2; an
    absent term is zeros), to_neg[4] (1 where the term is subtracted)."""
    g, geo = ops.glv, digits_geometry(ops)
    mu = np.zeros((2, geo["MU"]), np.uint32)
    for i, m in enumerate(g.mu):
        mu[i, : len(m)] = m
    coeff = np.zeros((4, geo["CO"]), np.uint32)
    to_neg = np.zeros(4, np.uint32)
    for t, term in enumerate((*g.k1_terms, *g.k2_terms)):
        if term is not None:
            sgn, limbs = term
            coeff[t, : len(limbs)] = limbs
            to_neg[t] = 1 if sgn > 0 else 0  # k = ... - sgn * c * |coeff|
    return np.concatenate([mu.ravel(), coeff.ravel(), to_neg])


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
    """Digits wrapper for one CurveOps; keeps the kernel's constants and
    counts launches. The kernel is the curve's library (its geometry is
    compile-time), checked against `digits_geometry` at the first launch."""

    def __init__(self, ops):
        if ops.glv is None:
            raise ValueError(f"{ops.spec.name} {ops.group_name} has no GLV endomorphism")
        self.ops = ops
        self.glv = g = ops.glv
        self.Ls = ops.fr.L
        self.nwin = -(-g.p.nbits // WINDOW)
        self.geometry = digits_geometry(ops)
        self.launches = 0
        self.widths: collections.Counter = collections.Counter()  # launches by lane count
        self.plain_calls = 0
        # when set to a list, every launch appends its (start, end) CUDA
        # timing events: lets a caller sum the time spent inside the kernel
        self.events: list | None = None
        self._consts_host = digits_consts(ops)  # by value into the kernel's parameter
        self._fn = None

    def _launch_fn(self):
        if self._fn is None:
            from .build import TARGETS, load

            target = f"glv_digits_{self.ops.spec.name}"  # one library per curve
            if target not in TARGETS:
                raise NotImplementedError(f"no digits kernel is instantiated for {self.ops.spec.name}")
            lib = load(target)
            cfg = (ctypes.c_longlong * 7)()
            lib.glv_digits_config(cfg)
            built = dict(zip(("LS", "LC", "LT", "LH", "NWIN", "MU", "CO"), cfg))
            if built != self.geometry:
                raise RuntimeError(f"{target} was built for {built}, the curve needs {self.geometry}")
            fn = lib.glv_digits_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
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
                k.data_ptr(), d1.data_ptr(), d2.data_ptr(), neg.data_ptr(), flip.data_ptr(), B,
                self._consts_host.ctypes.data, stream.cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"glv_digits kernel launch failed: CUDA error {err}")
        self.launches += 1
        self.widths[B] += 1
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
