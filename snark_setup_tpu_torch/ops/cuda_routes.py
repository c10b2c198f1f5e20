"""The stacked product's three opt-in routes: kernels K6, K7 and K8, their
plain PyTorch versions, and the dispatcher that picks a route per call.

Every route takes K5's arguments, `(U, V, weights, rows=None)` with the same
row maps and per-row negation (ops/cuda_mul.py), and the same checks:

- K6 `StackedCols` (``csrc/stacked_cols.cu``): the weighted product columns
  in the reference's form, not reduced — (2L, G, B) 32-bit columns, the low
  16 bits of every limb product in column i + j and the high 16 bits in
  column i + j + 1, in a torch.int32 tensor read as unsigned (the
  reference's uint32: a column can reach 2^32 - 1). `MxuStacked` reduces
  them with
  `FpOps.redc_cols_matmul` (the route of SNARK_SETUP_MXU_STACKED).
  Replaces PallasFieldMul.cols (ops/pallas_field.py).
- K7 `StackedMulV3` (``csrc/stacked_mul_v3.cu``): K5's exact 32-bit
  schoolbook, then the Montgomery reduction as two constant Toeplitz
  products over the two byte planes of the resolved sum, on the tensor
  cores (``csrc/toeplitz_tc.cuh``). Replaces PallasFieldMul.v3.
- K8 `StackedMulV2` (``csrc/stacked_mul_v2.cu``): the product as three
  float32 byte-plane column sums A1, A2, A3, then K7's reduction; only for
  weights that `v2_bounds` accepts (it raises on others). Replaces
  PallasFieldMul.v2.

K7 and K8 return the canonical Montgomery product: K5's limbs, for every
input they take. A CUDA tensor launches the route's kernel (or raises); a
CPU tensor runs its plain version, which takes the reference's route (the
16-bit column form, the reference's four-plane Toeplitz reduction in
float64 products — exact for these integers below 2^24 whatever the TF32
flags say — and float32 A-planes for K8). The kernels' own arithmetic is
rehearsed on the CPU by tests/test_torch_toeplitz_tc.py.

`StackedProduct` picks the route at every call in the reference's order
(ops/ext_jax.py: mul_stacked): K8 where SNARK_SETUP_KERNEL_V2 is set and the
weights pass `v2_supported`, else K7 under SNARK_SETUP_KERNEL_V3, else
K6 + the matrix-product reduction under SNARK_SETUP_MXU_STACKED, else K5.
Its `plain` method picks the same route's plain version, so a plain version
never launches a kernel under any switch (ops/curve.py: plain_group_law).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_mul import StackedMul, stacked_mul_for
from .fp import FpOps, _diag_rect, _resolve_carries, _shift_up
from .toeplitz import (
    kernel_v2_enabled,
    kernel_v3_enabled,
    mxu_stacked_forced,
    mma_fragments,
    redc_matrices,
    tc_matrices,
    v2_bounds,
    v2_supported,
)


def _lo16(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return torch.mul(x, y, out=out).bitwise_and_(0xFFFF)


def _hi16(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return torch.mul(x, y, out=out).bitwise_right_shift_(16)


def _cols16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L, *batch) int64 16-bit limbs each -> (2L, *batch) int64 columns:
    the low 16 bits of a_i b_j in column i + j, the high 16 in i + j + 1."""
    L = a.shape[0]
    return _diag_rect(a, b, 2 * L, _lo16) + _shift_up(_diag_rect(a, b, 2 * L, _hi16), 1)


def stacked_cols_plain(fq: FpOps, U: torch.Tensor, V: torch.Tensor, weights) -> torch.Tensor:
    """Plain version of K6: U, V (L, S, B) int32 -> (2L, G, B) weighted
    columns in the reference's form, 32-bit words in an int32 tensor (read
    them as unsigned: `& 0xFFFFFFFF` after widening)."""
    cols = _cols16(U.to(torch.int64), V.to(torch.int64))  # (2L, S, B)
    groups = []
    for g_w in weights:
        acc = torch.zeros_like(cols[:, 0])
        for s, w in enumerate(g_w):
            if w:
                acc = acc + w * cols[:, s]
        groups.append(acc)
    out = torch.stack(groups, dim=1)  # values in [0, 2^32): the same words as int32
    return (out - ((out >> 31) << 32)).to(torch.int32)


def _redc_mats(fq: FpOps, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`redc_matrices` of the modulus as float64 tensors on `device`."""
    key = ("redc_matrices", device)
    mats = fq._dev_consts.get(key)
    if mats is None:
        tl, tf = redc_matrices(fq.modulus, fq.spec.n0_inv, fq.L)
        mats = fq._dev_consts[key] = (torch.from_numpy(tl.astype(np.float64)).to(device),
                                      torch.from_numpy(tf.astype(np.float64)).to(device))
    return mats


def toeplitz_redc_plain(fq: FpOps, c: torch.Tensor, fused_s: bool) -> torch.Tensor:
    """The reference's `_redc_v2_kernel` on columns c (2L, *batch), each
    < 2^32, of a value < R N: m16 from T_low4 times the four byte planes of
    the unresolved low columns, m = resolve(m16) mod R, u16 from T_full times
    the two byte planes of m, s = resolve(c + u16) (c resolved first unless
    `fused_s`), then one conditional subtraction. Returns (L, *batch) int32."""
    L = fq.L
    shape = c.shape
    c = c.reshape(2 * L, -1).to(torch.int64) & 0xFFFFFFFF  # K6's words are unsigned
    tlow, tfull = _redc_mats(fq, c.device)
    low = c[:L]
    y = (tlow @ torch.cat([low & 0xFF, (low >> 8) & 0xFF, (low >> 16) & 0xFF, low >> 24]).double()).long()
    m = _resolve_carries(y[:L] + (y[L:] << 8))
    u = (tfull @ torch.cat([m & 0xFF, m >> 8]).double()).long()
    u16 = u[: 2 * L] + (u[2 * L :] << 8)
    s = _resolve_carries((c if fused_s else _resolve_carries(c)) + u16, 33)
    return fq._cond_sub_n(s[L:].to(torch.int32)).reshape(L, *shape[1:])


def stacked_mul_v3_plain(fq: FpOps, U: torch.Tensor, V: torch.Tensor, weights) -> torch.Tensor:
    """Plain version of K7: K6's columns, then the Toeplitz reduction.
    U, V (L, S, B) int32 -> (L, G, B) int32."""
    return toeplitz_redc_plain(fq, stacked_cols_plain(fq, U, V, weights), True)


def stacked_mul_v2_plain(fq: FpOps, U: torch.Tensor, V: torch.Tensor, weights) -> torch.Tensor:
    """Plain version of K8: the reference's float32 byte-plane schoolbook
    (`_school_f32_accum`: A1 = sum w al bl, A2 = sum w (al bh + ah bl),
    A3 = sum w ah bh per column, in float32, exact while `v2_bounds`
    holds: every partial sum is an integer below 2^24, so the order of the
    additions cannot change a bit), c = A1 + 2^8 A2 + A3 shifted one column up, then the Toeplitz
    reduction. U, V (L, S, B) int32 -> (L, G, B) int32."""
    ok, fused_s = v2_bounds(fq.L, weights)
    if not ok:
        raise ValueError("weights exceed the f32 exactness bounds (v2_bounds): use another route")
    L = fq.L
    a, b = U.to(torch.int64), V.to(torch.int64)
    al, ah = (a & 0xFF).float(), (a >> 8).float()
    bl, bh = (b & 0xFF).float(), (b >> 8).float()
    planes = []
    for g_w in weights:
        A1 = A2 = A3 = torch.zeros((2 * L, *a.shape[2:]), dtype=torch.float32, device=a.device)
        for s, w in enumerate(g_w):
            if w:
                wl, wh = al[:, s] * float(w), ah[:, s] * float(w)
                A1 = A1 + _diag_rect(wl, bl[:, s], 2 * L)
                A2 = A2 + _diag_rect(wl, bh[:, s], 2 * L) + _diag_rect(wh, bl[:, s], 2 * L)
                A3 = A3 + _diag_rect(wh, bh[:, s], 2 * L)
        planes.append(A1.long() + (A2.long() << 8) + _shift_up(A3.long(), 1))
    return toeplitz_redc_plain(fq, torch.stack(planes, dim=1), fused_s)


# The 16-bit-limb column bound shared by K6 and K7: a column is a sum of
# 2L terms below 2^16 per unit of weight.
def _check_columns(L: int, weights) -> None:
    if 2 * L * (1 << 16) * max(sum(g) for g in weights) >= 1 << 32:
        raise ValueError("column bound: 2 L * 2^16 * max_g sum_s W[g, s] >= 2^32")


class _ByValueN(StackedMul):
    """A route's wrapper whose kernel takes the modulus by value
    (`tc_consts`, a host buffer: csrc/stacked_routes.cuh, TcConsts), with no
    constant-memory copy before the launch."""

    def __init__(self, fq: FpOps):
        super().__init__(fq)
        q = fq.modulus
        self.tc_consts = np.array([(q >> (32 * i)) & 0xFFFFFFFF for i in range(self.NL)], np.uint32)

    def _consts_ptr(self, dev) -> int:
        return self.tc_consts.ctypes.data


class StackedCols(_ByValueN):
    """K6 wrapper: (2L, G, B) weighted columns, not reduced, as 32-bit
    words in an int32 tensor (read as unsigned)."""

    TARGET = "stacked_cols"

    def check_weights(self, weights, S: int) -> None:
        super().check_weights(weights, S)
        _check_columns(self.L, weights)

    def plain_fn(self, U, V, weights):
        return stacked_cols_plain(self.fq, U, V, weights)

    def _out(self, G: int, B: int, dev) -> torch.Tensor:
        return torch.empty((2 * self.L, G, B), dtype=torch.int32, device=dev)


class StackedMulV3(_ByValueN):
    """K7 wrapper: canonical (L, G, B) products, K5's schoolbook into the
    tensor-core Toeplitz reduction. The kernel takes the modulus by value
    (`tc_consts`, a host buffer) and the two constant matrices packed as
    tensor-core fragments (`fragments`, one device buffer)."""

    TARGET = "stacked_mul_v3"
    EXTRA_ARGTYPES = (ctypes.c_void_p,)

    def __init__(self, fq: FpOps):
        super().__init__(fq)
        mats = tc_matrices(fq.modulus, fq.spec.n0_inv, self.L)
        self._fragments = np.concatenate([mma_fragments(T) for T in mats])

    def check_weights(self, weights, S: int) -> None:
        super().check_weights(weights, S)
        _check_columns(self.L, weights)

    def plain_fn(self, U, V, weights):
        return stacked_mul_v3_plain(self.fq, U, V, weights)

    def fragments(self, dev) -> torch.Tensor:
        """T_low2 then T_full (`tc_matrices`) as `mma_fragments`, one uint8
        buffer on `dev`."""
        key = ("fragments", dev)
        buf = self._tables.get(key)
        if buf is None:
            buf = self._tables[key] = torch.from_numpy(self._fragments).to(dev)
        return buf

    def _launch_fn(self):
        if self._fn is None:
            fn = super()._launch_fn()
            built = getattr(self._lib, f"{self.TARGET}_tc_bytes")()
            if built != self._fragments.size:
                self._fn = None
                raise RuntimeError(f"{self.TARGET} was built for {built} bytes of matrices, "
                                   f"not {self._fragments.size}")
            return fn
        return self._fn

    def _extra_args(self, weights, dev) -> tuple:
        return (self.fragments(dev).data_ptr(),)


class StackedMulV2(StackedMulV3):
    """K8 wrapper: raises on weights that `v2_bounds` refuses, as the
    reference asserts; the dispatcher decides which products come here.
    K7's launch arguments."""

    TARGET = "stacked_mul_v2"

    def check_weights(self, weights, S: int) -> None:
        StackedMul.check_weights(self, weights, S)
        if not v2_bounds(self.L, weights)[0]:
            raise ValueError("weights exceed the f32 exactness bounds (v2_bounds): use another route")

    def plain_fn(self, U, V, weights):
        return stacked_mul_v2_plain(self.fq, U, V, weights)


class MxuStacked:
    """The SNARK_SETUP_MXU_STACKED route: K6's columns, then
    `FpOps.redc_cols_matmul`, bounded by the weights' largest row sum."""

    def __init__(self, cols: StackedCols):
        self.cols = cols
        # when set to a list, every reduction on the card appends its
        # (start, end) CUDA events: the route's cost outside K6
        self.events: list | None = None

    def _reduce(self, cols: torch.Tensor, weights) -> torch.Tensor:
        return self.cols.fq.redc_cols_matmul(cols, max(1, max(sum(g) for g in weights)))

    def __call__(self, U, V, weights, rows=None) -> torch.Tensor:
        cols = self.cols(U, V, weights, rows)
        if self.events is None or cols.device.type != "cuda":
            return self._reduce(cols, weights)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._reduce(cols, weights)
        end.record()
        self.events.append((start, end))
        return out

    def plain(self, U, V, weights, rows=None) -> torch.Tensor:
        return self._reduce(self.cols.plain(U, V, weights, rows), weights)


class StackedProduct:
    """The product every `mul_stacked` and `_fq_mul_planes` calls
    (ops/ext.py, ops/curve.py): one modulus, its four routes, the switches
    read at every call."""

    def __init__(self, modulus: int):
        self.k5 = stacked_mul_for(modulus)
        fq = self.k5.fq
        self.k6, self.k7, self.k8 = StackedCols(fq), StackedMulV3(fq), StackedMulV2(fq)
        self.mxu = MxuStacked(self.k6)
        self._v2_ok: dict = {}

    def route(self, weights):
        """The wrapper that takes these weights under the current switches."""
        if kernel_v2_enabled():
            key = tuple(tuple(g) for g in weights)
            ok = self._v2_ok.get(key)
            if ok is None:
                ok = self._v2_ok[key] = v2_supported(self.k5.fq.modulus, self.k5.L, key)
            if ok:
                return self.k8
        if kernel_v3_enabled():
            return self.k7
        if mxu_stacked_forced():
            return self.mxu
        return self.k5

    def __call__(self, U, V, weights, rows=None) -> torch.Tensor:
        return self.route(weights)(U, V, weights, rows)

    def plain(self, U, V, weights, rows=None) -> torch.Tensor:
        return self.route(weights).plain(U, V, weights, rows)


@functools.lru_cache(maxsize=None)
def stacked_product_for(modulus: int) -> StackedProduct:
    """The one dispatcher (and K6-K8 wrappers and counts) of a modulus."""
    return StackedProduct(modulus)
