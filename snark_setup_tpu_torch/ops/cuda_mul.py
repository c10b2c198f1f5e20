"""Stacked weighted Montgomery products (K5): CUDA kernel wrapper and its
plain PyTorch version.

`StackedMul.__call__(U, V, weights, rows=None)` returns the (L, G, B) planes
of ``redc(sum_r W[g][r] * u_r * v_r)``: G Montgomery products, each a
weighted sum of S stacked products, canonical. Without `rows` the stacked
operands are U[:, r] and V[:, r]; with ``rows = (urow, vrow, uneg)`` they are
U[:, urow[r]] (negated mod N where uneg[r]) and V[:, vrow[r]], which lets the
extension towers hand over their coefficient planes without gathering them
first. A CUDA tensor launches ``csrc/stacked_mul.cu`` (or raises); a CPU
tensor runs `stacked_mul_plain` on the gathered operands. The results are
exact integers: kernel and plain version agree limb for limb.

This one primitive is every multiplication round of the generic group law
and of the Fp2 / Fp3 towers (ops/ext.py, ops/curve.py). Replaces the
reference's PallasFieldMul.__call__ (ops/pallas_field.py).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib

import numpy as np
import torch

from ..utils.device import to_device
from .fp import FpOps, fp_ops


def stacked_mul_plain(fq: FpOps, U: torch.Tensor, V: torch.Tensor, weights) -> torch.Tensor:
    """Plain PyTorch version: product columns of every stacked pair, the
    weighted merge per group, one Montgomery reduction per group.
    U, V: (L, S, B) int32 -> (L, G, B) int32."""
    cols = fq.school_cols(U, V)  # (2L, S, B) int64
    groups = []
    for g_w in weights:
        acc = torch.zeros_like(cols[:, 0])
        for s, w in enumerate(g_w):
            if w:
                acc = acc + (cols[:, s] if w == 1 else w * cols[:, s])
        groups.append(acc)
    nprod = max(1, max((sum(g) for g in weights), default=1))
    return fq.redc_cols(torch.stack(groups, dim=1), nprod)


@functools.lru_cache(maxsize=None)
def shape_key(weights) -> str:
    """A short name of one launch shape: S, G and a digest of the weights
    (two rounds of one S and G differ in their weights)."""
    digest = hashlib.sha1(repr(tuple(tuple(g) for g in weights)).encode()).hexdigest()[:8]
    return f"S{len(weights[0])}G{len(weights)}-{digest}"


class StackedMul:
    """K5 wrapper for one modulus; keeps the kernel's by-value constants and
    per-device weight tables and counts launches (`shapes`: by weight
    shape). The opt-in routes' kernels (ops/cuda_routes.py) share its
    arguments, checks and tables and replace the library (`TARGET`), the
    output, the extra launch arguments and the plain version."""

    TARGET = "stacked_mul"
    EXTRA_ARGTYPES: tuple = ()

    def __init__(self, fq: FpOps):
        self.fq = fq
        self.L = fq.L
        self.NL = fq.L // 2
        q = fq.modulus
        self.R = fq.spec.mont_r_pow
        if 2 * q >= self.R:
            raise ValueError("modulus too close to R for the stacked-product kernel")

        def words(v: int) -> list[int]:
            return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(self.NL)]

        n0 = (-pow(q, -1, 1 << 32)) % (1 << 32)
        # csrc/stacked_mul.cu's K5Consts (N, n0), by value into the kernel's parameter
        self._consts_np = np.array(words(q) + [n0], np.uint32)
        self._tables: dict = {}
        self._checked: set = set()
        self._fn = None
        self._lib = None
        self.launches = 0
        self.shapes: collections.Counter = collections.Counter()  # launches by `shape_key`
        self.plain_calls = 0
        # when set to a list, every launch appends its (start, end) CUDA
        # timing events: lets a caller sum the time spent inside the kernel
        self.events: list | None = None

    def check_weights(self, weights, S: int) -> None:
        """Weights are G rows of S non-negative ints with
        max_g sum_s W[g, s] * N < R: the precondition under which one
        conditional subtraction makes the reduced value canonical."""
        if any(len(g) != S for g in weights):
            raise ValueError(f"every weight row must have {S} entries")
        if any(int(w) != w or w < 0 or w >= 1 << 31 for g in weights for w in g):
            raise ValueError("weights must be non-negative integers below 2^31")
        if max((sum(g) for g in weights), default=0) * self.fq.modulus >= self.R:
            raise ValueError("weighted sum exceeds the REDC bound: max_g sum_s W[g,s] * N >= R")

    def __call__(self, U: torch.Tensor, V: torch.Tensor, weights, rows=None) -> torch.Tensor:
        """U (L, SU, B), V (L, SV, B) int32 on one device; weights: G tuples
        of S ints; rows: None (then SU == SV == S) or (urow, vrow, uneg),
        three S-tuples of ints. Returns (L, G, B) int32."""
        weights, rows = self._checked_args(U, V, weights, rows)
        if U.device.type == "cpu":
            return self._plain(U, V, weights, rows)
        if U.device.type != "cuda":
            raise ValueError(f"unsupported device {U.device}")
        return self._launch(U.contiguous(), V.contiguous(), weights, rows)

    def plain(self, U: torch.Tensor, V: torch.Tensor, weights, rows=None) -> torch.Tensor:
        """`stacked_mul_plain` on any device, with `__call__`'s arguments and
        checks, counted in `plain_calls` (the product of the group law that
        the ladder kernel's plain version runs, ops/cuda_ladder.py)."""
        weights, rows = self._checked_args(U, V, weights, rows)
        return self._plain(U, V, weights, rows)

    def _plain(self, U, V, weights, rows) -> torch.Tensor:
        self.plain_calls += 1
        return self.plain_fn(*self.gather(U, V, rows), weights)

    def plain_fn(self, U: torch.Tensor, V: torch.Tensor, weights) -> torch.Tensor:
        """The plain version on gathered operands, uncounted."""
        return stacked_mul_plain(self.fq, U, V, weights)

    def _checked_args(self, U, V, weights, rows):
        """Validated (weights, rows) as tuples of ints."""
        weights = tuple(tuple(g) for g in weights)
        for t in (U, V):
            if t.dtype != torch.int32 or t.ndim != 3 or t.shape[0] != self.L or t.device != U.device:
                raise ValueError(
                    f"stacked operands must be int32 ({self.L}, S, B) on {U.device}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
        if U.shape[2] != V.shape[2]:
            raise ValueError("U and V must have the same batch width")
        if rows is None:
            if U.shape[1] != V.shape[1]:
                raise ValueError("without row maps U and V must stack the same rows")
            S = U.shape[1]
            rows = (tuple(range(S)), tuple(range(S)), (0,) * S)
        else:
            rows = tuple(tuple(int(i) for i in r) for r in rows)
            S = len(rows[0])
            if any(len(r) != S for r in rows):
                raise ValueError("row maps must have one entry per stacked product")
        if max(rows[0], default=-1) >= U.shape[1] or max(rows[1], default=-1) >= V.shape[1] or min(
            (*rows[0], *rows[1]), default=0
        ) < 0:
            raise ValueError("row map out of range")
        if (weights, rows) not in self._checked:
            self.check_weights(weights, S)
            self._checked.add((weights, rows))
        return weights, rows

    def gather(self, U: torch.Tensor, V: torch.Tensor, rows):
        """The stacked operands the row maps name, as (L, S, B) tensors:
        U[:, urow] (negated where uneg) and V[:, vrow], copies unless the map
        is the identity."""
        urow, vrow, uneg = rows
        # identity maps (every degree-1 round) need no copy
        Ub = U if urow == tuple(range(U.shape[1])) else U.index_select(1, self._host_const(urow, U.device))
        if any(uneg):
            neg = self._host_const(uneg, U.device, np.bool_)[:, None]
            Ub = torch.where(neg, self.fq.neg(Ub), Ub)
        return Ub, V if vrow == tuple(range(V.shape[1])) else V.index_select(1, self._host_const(vrow, V.device))

    def _host_const(self, values: tuple, dev, dtype=np.int64) -> torch.Tensor:
        """A row map's indices or signs on `dev`, copied there once."""
        key = (values, dtype, dev)
        t = self._tables.get(key)
        if t is None:
            t = self._tables[key] = to_device(np.array(values, dtype), dev)
        return t

    def _launch_fn(self):
        if self._fn is None:
            from .build import TARGETS, load

            target = f"{self.TARGET}_nl{self.NL}"
            if target not in TARGETS:
                raise NotImplementedError(f"no {self.TARGET} kernel is instantiated for {self.L} limbs")
            lib = self._lib = load(target)
            if getattr(lib, f"{self.TARGET}_nl")() != self.NL:
                raise RuntimeError(f"{target} was built for another limb count")
            fn = getattr(lib, f"{self.TARGET}_launch")
            fn.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                + list(self.EXTRA_ARGTYPES) + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _table(self, weights, rows, dev) -> torch.Tensor:
        key = (weights, rows, dev)
        t = self._tables.get(key)
        if t is None:
            flat = [w for g in weights for w in g] + [i for r in rows for i in r]
            t = self._tables[key] = torch.tensor(flat, dtype=torch.int32).to(dev)
        return t

    def _out(self, G: int, B: int, dev) -> torch.Tensor:
        return torch.empty((self.L, G, B), dtype=torch.int32, device=dev)

    def _consts_ptr(self, dev) -> int:
        """The launch's `consts` argument: a HOST pointer to the constants
        block the kernel takes by value."""
        return self._consts_np.ctypes.data

    def _extra_args(self, weights, dev) -> tuple:
        """Launch arguments after the field constants (EXTRA_ARGTYPES)."""
        return ()

    def _launch(self, U, V, weights, rows) -> torch.Tensor:
        dev = U.device
        G, S, B = len(weights), len(rows[0]), U.shape[2]
        out = self._out(G, B, dev)
        if B == 0 or G == 0:
            return out
        consts = self._consts_ptr(dev)
        table = self._table(weights, rows, dev)
        extra = self._extra_args(weights, dev)
        fn = self._launch_fn()
        stream = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev):
            if self.events is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            err = fn(
                U.data_ptr(), V.data_ptr(), out.data_ptr(), table.data_ptr(),
                B, S, G, U.shape[1], V.shape[1], consts, *extra, stream.cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"{self.TARGET} kernel launch failed: CUDA error {err}")
        self.launches += 1
        self.shapes[shape_key(weights)] += 1
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self.events.append((start, end))
        return out


@functools.lru_cache(maxsize=None)
def stacked_mul_for(modulus: int) -> StackedMul:
    """The one K5 wrapper (and launch count) of a modulus."""
    return StackedMul(fp_ops(modulus))
