"""Vectorised multi-limb Montgomery field arithmetic in plain PyTorch.

This is the port's plain field layer: everything on the contribute path that
is not one of the two CUDA kernels (Montgomery conversion, tau powers, batch
inversion, sign flags) runs through it, on the card or on the CPU alike.

Layout and conventions (identical to the reference at every seam):

- Field elements are little-endian vectors of 16-bit limbs, **limbs-leading**:
  shape ``(L, *batch)``, batch axes last, Montgomery form with
  ``R = 2^(16 L)``. Every public function returns the canonical value
  ``< N``, so results agree with the reference limb for limb.
- Limbs are carried as ``torch.int32`` (values ``< 2^16``; PyTorch on the CPU
  cannot add, shift or compare ``uint32``). The CUDA kernels reinterpret the
  same memory as ``uint32``. Products are computed in ``torch.int64``: a full
  32-bit limb product and a column of up to ``L`` of them fit without the
  lo/hi split a 32-bit lane needs, so `school_cols` returns columns
  ``< L * 2^32`` instead of the reference's ``< 2^23`` — the represented
  value is the same.
- Carry resolution folds the high parts down until limbs are ``< 2^17`` and
  finishes with a carry-lookahead written as one running-maximum scan over
  the limb axis (`_ks_carry`): few launches, no data-dependent loop.
- Constants live in the ops object as host numpy and are materialised once
  per device on first use.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..fields.limb import (
    LIMB_BITS,
    LIMB_MASK,
    LimbSpec,
    int_to_limbs,
    ints_to_limbs_batch,
    limbs_batch_to_ints,
)
from ..utils.device import to_device

MASK = LIMB_MASK
SHIFT = LIMB_BITS


def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """Shift limbs towards higher indices by d (zero-fill), axis 0."""
    if d == 0:
        return x
    return torch.constant_pad_nd(x[:-d], [0, 0] * (x.ndim - 1) + [d, 0])


@functools.lru_cache(maxsize=None)
def _limb_codes(L: int, ndim: int, dtype, device) -> torch.Tensor:
    """2(k+1) for limb k, shaped (L, 1, ..., 1): the position part of the
    carry-lookahead codes of `_ks_carry`."""
    pos = torch.arange(2, 2 * L + 2, 2, dtype=dtype, device=device)
    return pos.reshape(L, *([1] * (ndim - 1)))


def _ks_carry(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Binary carry resolution for limbs v < 2^17 by carry-lookahead.
    Returns (limbs < 2^16, carry out of the top limb as 0/1).

    A limb *decides* its carry-out unless it is exactly 0xFFFF (no generate,
    full propagate); a deciding limb's carry-out is its generate bit v >> 16
    whatever comes in (callers keep v + carry-in < 2^17: folded columns are
    <= 0x1FFFE, and a complement's 0x1FFFF can occur only at limb 0). The carry
    out of limb k is therefore the generate bit of the most recent deciding
    limb <= k, found with one cummax over codes 2(k+1)+g."""
    g = v >> SHIFT
    pos = _limb_codes(v.shape[0], v.ndim, v.dtype, v.device)
    code = torch.where(v != MASK, pos + g, 0)
    carry_out = torch.cummax(code, dim=0).values & 1
    out = ((v & MASK) + _shift_up(carry_out, 1)) & MASK
    return out, carry_out[-1]


def _resolve_carries(cols: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """Propagate carries along axis 0. Input limbs are non-negative and
    < 2^bits (host-known bound, <= 62); output limbs < 2^16 with the final
    carry dropped (callers guarantee the value fits). Redundant folding
    rounds bring limbs under 2^17, then the lookahead finishes."""
    assert bits <= 62
    v = cols
    while bits > 32:
        v = (v & MASK) + _shift_up(v >> SHIFT, 1)
        bits = bits - SHIFT + 1
    v = (v & MASK) + _shift_up(v >> SHIFT, 1)
    out, _ = _ks_carry(v)
    return out


def _sub_with_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b limbwise (axis 0); returns (diff limbs, final borrow mask).
    Two's-complement addition in base 2^16 with carry-lookahead."""
    comp = MASK - b
    comp[0] += 1
    return _add_complement(a, comp)


def _add_complement(a: torch.Tensor, comp_b: torch.Tensor):
    """(a - b limbs, borrow mask) from a and the unresolved limbs of
    2^(16 L) - b: (0xFFFF - b) + 1 at limb 0."""
    out, top_carry = _ks_carry(a + comp_b)  # limbs < 2^17
    return out, top_carry == 0


def _broadcast_rest(sa, sb) -> tuple:
    """Broadcast of two batch shapes (right-aligned, sizes equal or 1)."""
    if len(sa) < len(sb):
        sa, sb = sb, sa
    sb = (1,) * (len(sa) - len(sb)) + tuple(sb)
    return tuple(y if x == 1 else x for x, y in zip(sa, sb))


def _diag_rect(a: torch.Tensor, b: torch.Tensor, rows: int | None = None, op=torch.mul) -> torch.Tensor:
    """Column sums of the product of two limb vectors: a (na, *batch) and
    b (nb, *batch'), broadcastable batches, in a's dtype ->
    out[k] = sum_{i+j=k} a[i] * b[j] for k < rows (default na+nb; columns
    past na+nb-2 are zero) — by strides, no gather. `op(x, y, out=)` in
    place of `torch.mul` sums another table of the pairs (a[i], b[j]).

    The (na, nb) product table is written into a zeroed flat buffer at row
    pitch rows+1; flat index i*(rows+1) + j equals i*rows + (i+j), so
    re-reading the buffer at row pitch `rows` lines every anti-diagonal k up
    in column k, and one sum over the leading axis finishes."""
    na, nb = a.shape[0], b.shape[0]
    rows = na + nb if rows is None else rows
    assert rows >= max(na, nb)
    rest = _broadcast_rest(a.shape[1:], b.shape[1:])
    flat = torch.zeros(((na + 1) * rows, *rest), dtype=a.dtype, device=a.device)
    table = flat[: na * (rows + 1)].view(na, rows + 1, *rest)[:, :nb]
    op(a[:, None], b[None, :], out=table)
    return flat.view(na + 1, rows, *rest).sum(dim=0)


class FpOps:
    """Montgomery field ops for one modulus, vectorised over trailing axes.

    Elements are int32 tensors (L, *batch) in Montgomery form (R = 2^(16 L)).
    """

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.spec = LimbSpec(modulus)
        L = self.spec.n_limbs
        self.L = L
        # host numpy constants, (L, 1)-shaped so they broadcast against
        # (L, *batch) from the left limb axis
        self.N = int_to_limbs(modulus, L)[:, None]
        self.Nprime = int_to_limbs(self.spec.n0_inv, L)[:, None]
        self.one_mont_np = int_to_limbs(self.spec.mont_r % modulus, L)[:, None]
        self.r2_np = int_to_limbs(self.spec.mont_r2, L)[:, None]
        unit = np.zeros((L, 1), np.uint32)
        unit[0] = 1
        self.unit_np = unit
        comp = LIMB_MASK - self.N  # limbs of R - N, unresolved (see _add_complement)
        comp[0] += 1
        self.comp_N = comp
        self._dev_consts: dict = {}

    # -- constants ---------------------------------------------------------
    def const(self, name: str, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
        """The host constant `name` ((L, 1) numpy attribute) as a tensor on
        `like`'s device, reshaped to broadcast against `like`."""
        return self.const_of(name, getattr(self, name), like, dtype)

    def const_of(self, key, arr: np.ndarray, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
        """A caller's (L,)/(L, 1) host limb constant, materialised once per
        (key, device, dtype) and reshaped to broadcast against `like`."""
        ck = (key, like.device, dtype)
        t = self._dev_consts.get(ck)
        if t is None:
            t = to_device(np.asarray(arr).astype(np.int64), like.device).to(dtype)
            self._dev_consts[ck] = t
        return t.reshape(self.L, *([1] * (like.ndim - 1)))

    def tensor(self, limbs: np.ndarray, device) -> torch.Tensor:
        """Host limb array (any integer dtype, values < 2^16) -> int32 tensor."""
        return to_device(np.ascontiguousarray(limbs).astype(np.int32), device)

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros((self.L, *shape), dtype=torch.int32, device=device)

    def ones(self, shape, device) -> torch.Tensor:
        one = self.tensor(self.one_mont_np[:, 0], device)
        return one.reshape(self.L, *([1] * len(shape))).expand(self.L, *shape).contiguous()

    # -- host conversion (pure host math — no device round trips) ----------
    def from_int(self, values) -> np.ndarray:
        """Host ints (standard form) -> Montgomery limbs (L, n) host numpy
        uint32. A single int gives shape (L,)."""
        single = isinstance(values, int)
        if single:
            values = [values]
        R = self.spec.mont_r
        m = self.modulus
        arr = ints_to_limbs_batch([(v % m) * R % m for v in values], self.L).T
        return arr[:, 0] if single else np.ascontiguousarray(arr)

    def to_int(self, limbs) -> list[int]:
        """Montgomery limbs (L, n) (tensor or numpy) -> host ints."""
        rinv = pow(self.spec.mont_r, -1, self.modulus)
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.cpu().numpy()
        arr = np.asarray(limbs)
        if arr.ndim == 1:
            arr = arr[:, None]
        flat = arr.reshape(self.L, -1).T
        return [v * rinv % self.modulus for v in limbs_batch_to_ints(flat)]

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self.const("unit_np", a))

    def to_mont_raw(self, a: torch.Tensor) -> torch.Tensor:
        """Standard-form limbs -> Montgomery form (device)."""
        return self.mont_mul(a, self.const("r2_np", a))

    # -- core arithmetic ---------------------------------------------------
    def school_cols(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Full product column sums: (2L, *batch) int64, columns < L * 2^32.
        One (L, L, *batch) outer product + anti-diagonal sums."""
        return _diag_rect(a.to(torch.int64), b.to(torch.int64))

    def _cols_bits(self, nprod: int) -> int:
        return 32 + (self.L * nprod).bit_length()

    def redc_cols(self, cols: torch.Tensor, nprod: int = 1) -> torch.Tensor:
        """Montgomery-reduce a column-space value V (< nprod * N^2, the sum
        of `nprod` `school_cols` results) to V * R^{-1} mod N as int32 limbs.
        Requires nprod * N < R, asserted: then the quotient is < 2N and one
        conditional subtraction makes it canonical. Columns may also come as
        32-bit words in an int32 tensor (K6's form), read as unsigned."""
        assert nprod * self.modulus < self.spec.mont_r_pow, "REDC bound violated"
        if cols.dtype == torch.int32:
            cols = cols.to(torch.int64) & 0xFFFFFFFF
        L = self.L
        bits = self._cols_bits(nprod)
        if bits + SHIFT + L.bit_length() > 62:
            # a wide weighted sum: the product with N' below would leave
            # int64, so resolve the columns first (V < nprod N^2 < R N fits
            # the 2L limbs exactly)
            cols = _resolve_carries(cols, bits)
            bits = self._cols_bits(1)
        # m = (V mod R) * N' mod R, straight from the unresolved low columns
        # (a product of two L-limb operands truncated to L columns)
        m_cols = _diag_rect(cols[:L], self.const("Nprime", cols, torch.int64))[:L]
        m = _resolve_carries(m_cols, bits + SHIFT + L.bit_length())
        u_cols = _diag_rect(m, self.const("N", cols, torch.int64))
        # s = V + m*N; its low L limbs are 0 mod R, the result is the high half
        s = _resolve_carries(cols + u_cols, bits + 1)
        return self._cond_sub_n(s[L : 2 * L].to(torch.int32))

    # -- the matrix-product reduction (SNARK_SETUP_MXU_STACKED) -------------
    # Both constant multiplies of REDC, m = t_low * N' mod R and u = m * N,
    # are products of constant Toeplitz matrices with the 8-bit limb planes
    # of the operand: terms < 2^16, at most 2 L8 = 4L of them per sum, every
    # sum < 2^24. Copied from the reference's fp_jax.py
    # (`_toeplitz8`, `_to8`, `_fold16`, `redc_cols_matmul`).
    def _toeplitz8(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(T_low (L8, L8), T_full (2 L8, L8)) over 8-bit digits (unblocked
        layout), float64 on `device`."""
        key = ("toeplitz8", device)
        mats = self._dev_consts.get(key)
        if mats is None:
            L8 = 2 * self.L

            def l8(v, n):
                return np.array([(v >> (8 * i)) & 0xFF for i in range(n)], np.float64)

            N8, Np8 = l8(self.modulus, L8), l8(self.spec.n0_inv, L8)
            ii = np.arange(L8)[None, :]
            d = np.arange(L8)[:, None] - ii
            T_low = np.where(d >= 0, Np8[np.clip(d, 0, L8 - 1)], 0.0)
            d2 = np.arange(2 * L8)[:, None] - ii
            T_full = np.where((d2 >= 0) & (d2 < L8), N8[np.clip(d2, 0, L8 - 1)], 0.0)
            mats = self._dev_consts[key] = (torch.from_numpy(T_low).to(device),
                                            torch.from_numpy(T_full).to(device))
        return mats

    @staticmethod
    def _to8(t16: torch.Tensor) -> torch.Tensor:
        """(R, n) 16-bit limbs -> (2R, n) float64 8-bit limb planes, digit
        2 i + p = byte p of limb i."""
        return torch.stack([t16 & 0xFF, (t16 >> 8) & 0xFF], dim=1).reshape(2 * t16.shape[0], -1).double()

    @staticmethod
    def _fold16(cols8: torch.Tensor) -> torch.Tensor:
        """(2R, n) base-2^8 columns (integers < 2^24) -> (R, n) int64
        base-2^16 columns."""
        c = cols8.to(torch.int64)
        return c[0::2] + (c[1::2] << 8)

    def redc_cols_matmul(self, cols: torch.Tensor, nprod: int = 1) -> torch.Tensor:
        """`redc_cols` with the two constant multiplies as matrix products:
        columns (2L, *batch) of a value < nprod * N^2, each < 2^32 (the
        stacked-columns kernel's form: int64, or 32-bit words in an int32
        tensor, read as unsigned) -> canonical (L, *batch) int32 limbs.

        The products run in float64, whose exactness for these integers
        (< 2^24) depends on no global flag (a float32 product on the card
        may be taken in TF32, which keeps 10 mantissa bits)."""
        if nprod * self.modulus >= self.spec.mont_r_pow:
            raise ValueError("REDC bound violated: nprod * N >= R")
        L = self.L
        shape = cols.shape
        flat = cols.reshape(2 * L, -1).to(torch.int64) & 0xFFFFFFFF
        t = _resolve_carries(flat)
        T_low, T_full = self._toeplitz8(cols.device)
        m = _resolve_carries(self._fold16(T_low @ self._to8(t[:L])))
        u16 = self._fold16(T_full @ self._to8(m))
        s = _resolve_carries(t + u16, 33)
        return self._cond_sub_n(s[L:].to(torch.int32)).reshape(L, *shape[1:])

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b*R^{-1} mod N, over slices of the widest
        batch axis of at most `lanes.MAX_LANES` elements a call: the product
        columns take 16 L (L + 1) bytes an element (37.6 KB at L = 48), so
        a 2^21-lane BW6-761 batch at once would need 79 GB."""
        from . import lanes  # lanes imports curve, which imports this module

        rest = _broadcast_rest(a.shape[1:], b.shape[1:])
        total = math.prod(rest)
        if total <= lanes.MAX_LANES:
            return self.redc_cols(self.school_cols(a, b))
        axis = max(range(-len(rest), 0), key=lambda i: rest[i])  # batch axes are right-aligned
        width = max(1, lanes.MAX_LANES // (total // rest[axis]))

        def take(t, lo):  # an operand broadcast along the axis stays whole
            if t.dim() - 1 < -axis or t.shape[axis] == 1:
                return t
            return t.narrow(axis, lo, min(width, t.shape[axis] - lo))

        return torch.cat([self.redc_cols(self.school_cols(take(a, lo), take(b, lo)))
                          for lo in range(0, rest[axis], width)], dim=axis)

    def mont_sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, a)

    mul = mont_mul  # the name the field-ops protocol (ext.py) uses

    def _cond_sub_n(self, a: torch.Tensor) -> torch.Tensor:
        d, borrow = _add_complement(a, self.const("comp_N", a))
        return torch.where(borrow, a, d)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s, _ = _ks_carry(a + b)  # limbs <= 0x1FFFE: the lookahead applies directly
        # note: sum < 2N < R so no top carry is lost
        return self._cond_sub_n(s)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        d, borrow = _sub_with_borrow(a, b)
        dn, _ = _ks_carry(d + self.const("N", a))
        return torch.where(borrow, dn, d)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        d, _ = _sub_with_borrow(self.const("N", a).expand_as(a), a)
        return torch.where(self.is_zero(a), a, d)

    def double_el(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul_small(self, a: torch.Tensor, k: int) -> torch.Tensor:
        """Multiply by a small constant via repeated additions (k <= ~30)."""
        assert k >= 0
        if k == 0:
            return torch.zeros_like(a)
        result = None
        addend = a
        while k:
            if k & 1:
                result = addend if result is None else self.add(result, addend)
            k >>= 1
            if k:
                addend = self.add(addend, addend)
        return result

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        """All-limbs-zero mask over the batch shape (*batch,)."""
        return (a == 0).all(dim=0)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=0)

    def select(self, cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """cond is a boolean tensor over the batch shape (broadcasts from
        the right against (L, *batch))."""
        return torch.where(cond, a, b)

    # -- inversion ---------------------------------------------------------
    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Inversion, Montgomery form in and out; a==0 maps to 0. Callers
        invert one element or a few (the root of a batch inversion, an
        extension field's norm). On a CUDA tensor: one launch of the power
        kernel, a^(p-2) (ops/cuda_sqrt.py: fq_inv_for), with no wait for
        the card. On the CPU: the exact host inversion, (aR)^-1 R^2 = a^-1 R,
        equal to the kernel's plain chain (tests/test_torch_pipeline.py)."""
        if a.device.type == "cuda":
            from .cuda_sqrt import fq_inv_for

            return fq_inv_for(self.modulus)(a)
        m, r2 = self.modulus, self.spec.mont_r2
        vals = limbs_batch_to_ints(a.reshape(self.L, -1).cpu().numpy().T)
        inv = [pow(v, -1, m) * r2 % m if v % m else 0 for v in vals]
        out = ints_to_limbs_batch(inv, self.L).T
        return self.tensor(out, a.device).reshape(a.shape)

    def batch_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Batched inversion over the last axis with a single inversion
        (Montgomery's trick as a product tree: pairwise products
        up to one root, one inversion, then inverses pushed back down by
        multiplying with the sibling). ~3 multiplications per element in
        2*log2(n) full-width steps. Zero elements pass through as zero
        (matching the projective normalisation use where Z=0 marks
        infinity). The inverses are canonical, so they equal the
        reference's prefix/suffix-scan result limb for limb."""
        return _tree_batch_inv(self, a)


def _tree_batch_inv(F, a: torch.Tensor) -> torch.Tensor:
    """Product-tree batch inversion over the last axis for any ops object
    with is_zero/select/ones/mul/inv (see FpOps.batch_inv)."""
    n = a.shape[-1]
    is_zero = F.is_zero(a)
    one = F.ones((1,), device=a.device)
    level = F.select(is_zero, one.expand_as(a), a)
    levels = []
    while level.shape[-1] > 1:
        if level.shape[-1] % 2:
            level = torch.cat([level, one.expand(*level.shape[:-1], 1)], dim=-1)
        levels.append(level)
        level = F.mul(level[..., 0::2], level[..., 1::2])
    inv = F.inv(level)
    for level in reversed(levels):
        # inverse of a child = inverse of the parent times the sibling
        # (a parent level padded to even width carries one inverse too many)
        sib = torch.stack([level[..., 1::2], level[..., 0::2]], dim=-1)
        inv = F.mul(inv[..., : sib.shape[-2]].unsqueeze(-1), sib).reshape(level.shape)
    return F.select(is_zero, torch.zeros_like(a), inv[..., :n])


@functools.lru_cache(maxsize=None)
def fp_ops(modulus: int) -> FpOps:
    return FpOps(modulus)
