"""Pippenger (bucket-method) multi-scalar multiplication on the card.

Replaces the per-point ladder inside every random-linear-combination ratio
check (power_pairs, setup-utils/src/helpers.rs:371-424) with the bucket
method, as the reference's ops/pippenger.py does, and computes the same
projective point:

- Signed-digit recoding with window width c (host numpy; the scalars are
  public randomness): adding sum_k 2^(c-1) 2^(kc) to each scalar makes every
  digit d_k - 2^(c-1) lie in [-2^(c-1), 2^(c-1)], so buckets store |digit|
  in [0, 2^(c-1)] (row 0 is a dead bucket for zero digits) and the point's y
  is negated where the digit is negative.
- Bucket accumulation: the batch is split into G lanes x S steps; step s
  adds the G points of row s into per-lane bucket arrays of shape
  (L[, d], nwin, 2^(c-1)+1, G), every window at once. Each lane owns its
  buckets, so the touched row is gathered, added (one group addition over
  nwin x G lanes: K2 on Fq coordinates with a = 0, K5 rounds elsewhere) and
  scattered back with indices that never repeat within a step — a
  deterministic update on the card. Padding lanes hold infinity with digit
  0 (the dead bucket).
- Lane merge: log2(G) batched additions; then the descending running-sum
  bucket finalize (2 additions per bucket row, batched over windows); then
  the window combine (c doublings + 1 addition per window).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.limb import LIMB_BITS
from ..utils.device import to_device
from .curve import CurveOps, PointVec

_DEF_C = 8


def signed_digits_host(scalars_raw: np.ndarray, nbits: int, c: int = _DEF_C):
    """(Ls, B) raw 16-bit limb scalars -> (idx, neg): |digit| in
    [0, 2^(c-1)] and sign masks, both (nwin, B), LSB-window first. Pure
    numpy."""
    if c > LIMB_BITS:
        raise ValueError("digit extraction pulls at most one extra limb")
    Ls, B = scalars_raw.shape
    nwin = -(-(nbits + 1) // c)
    half = 1 << (c - 1)
    # t = scalar + sum_k half * 2^(kc), carry-propagated in 16-bit limbs
    const = sum(half << (k * c) for k in range(nwin))
    # only nwin digits are extracted, so t must fit in nwin * c bits
    if (1 << nbits) - 1 + const >= 1 << (nwin * c):
        raise ValueError(f"signed-digit recoding overflow: nbits={nbits} c={c} nwin={nwin}")
    L2 = max(Ls, (nwin * c + 1 + LIMB_BITS - 1) // LIMB_BITS) + 1
    t = np.zeros((L2, B), np.uint64)
    t[:Ls] = scalars_raw.astype(np.uint64)
    for i in range(L2):
        t[i] += (const >> (i * LIMB_BITS)) & 0xFFFF
    carry = np.zeros(B, np.uint64)
    for i in range(L2):
        t[i] += carry
        carry = t[i] >> LIMB_BITS
        t[i] &= 0xFFFF
    idx = np.empty((nwin, B), np.int32)
    neg = np.empty((nwin, B), bool)
    mask = (1 << c) - 1
    for k in range(nwin):
        lo_limb, off = divmod(k * c, LIMB_BITS)
        v = t[lo_limb] >> off
        if off + c > LIMB_BITS and lo_limb + 1 < L2:
            v |= t[lo_limb + 1] << (LIMB_BITS - off)
        d = (v.astype(np.int64) & mask) - half  # [-half, half-1]
        neg[k] = d < 0
        idx[k] = np.abs(d)
    return idx, neg


class PippengerMSM:
    """Bucket MSM for one (ops, B, nbits, c, lanes) signature."""

    def __init__(self, ops: CurveOps, batch: int, nbits: int, c: int = _DEF_C, lanes: int | None = None):
        self.ops = ops
        self.nbits = nbits
        self.c = c
        self.nwin = -(-(nbits + 1) // c)
        self.nb = (1 << (c - 1)) + 1  # bucket rows incl. dead row 0
        if lanes is None:
            lanes = max(8, min(256, batch // 8))
        g = 1
        while g * 2 <= lanes:
            g *= 2
        self.G = g
        self.S = -(-batch // g)  # steps (batch padded to S * G)
        self.B_pad = self.S * self.G

    def __call__(self, pts: PointVec, scalars_raw: np.ndarray) -> PointVec:
        """pts: device batch (padding beyond the scalar count must be
        infinity); scalars_raw: HOST (Ls, B) raw limb planes. Returns a
        1-point PointVec on the points' device."""
        ops, F = self.ops, self.ops.field
        el = 1 if F.degree == 1 else 2  # element axes: (L[, d])
        nwin, nb, G, S = self.nwin, self.nb, self.G, self.S
        dev = pts["x"].device
        B = scalars_raw.shape[-1]
        if pts["x"].shape[-1] != B or B > self.B_pad:
            raise ValueError("points and scalars must have one batch width, at most the planned one")
        idx, neg = signed_digits_host(np.asarray(scalars_raw), self.nbits, self.c)
        if self.B_pad != B:
            pad = self.B_pad - B
            idx = np.concatenate([idx, np.zeros((nwin, pad), np.int32)], 1)
            neg = np.concatenate([neg, np.zeros((nwin, pad), bool)], 1)
            inf = ops.infinity((pad,), dev)
            pts = PointVec({k: torch.cat([pts[k], inf[k]], dim=-1) for k in "xyz"})
        p = {k: v.reshape(*v.shape[:el], S, G) for k, v in pts.items()}
        idx_t = to_device(np.ascontiguousarray(idx.reshape(nwin, S, G).transpose(1, 0, 2), np.int64), dev)
        neg_t = to_device(np.ascontiguousarray(neg.reshape(nwin, S, G).transpose(1, 0, 2)), dev)

        buckets = ops.infinity((nwin, nb, G), dev)
        axis = el + 1  # the bucket-row axis of (L[, d], nwin, nb, G)
        lead = buckets["x"].shape[:el]
        for s in range(S):
            pt = PointVec({k: v[..., s, :].unsqueeze(-2).expand(*lead, nwin, G) for k, v in p.items()})
            pt["y"] = F.select(neg_t[s], F.neg(pt["y"]), pt["y"])
            ix = idx_t[s].view(*([1] * el), nwin, 1, G).expand(*lead, nwin, 1, G)
            row = PointVec({k: torch.gather(v, axis, ix).squeeze(axis) for k, v in buckets.items()})
            added = ops.add(row, pt)
            for k in "xyz":
                buckets[k].scatter_(axis, ix, added[k].unsqueeze(axis))

        # lane merge: tree-reduce the G axis -> (L[, d], nwin, nb)
        g = G
        while g > 1:
            h = g // 2
            buckets = ops.add(
                PointVec({k: v[..., :h] for k, v in buckets.items()}),
                PointVec({k: v[..., h:g] for k, v in buckets.items()}),
            )
            g = h
        buckets = {k: v[..., 0] for k, v in buckets.items()}

        # bucket finalize: acc runs from the top bucket down, tot += acc
        # each step, so tot = sum_j j * B_j (j >= 1), per window
        acc = ops.infinity((nwin,), dev)
        tot = ops.infinity((nwin,), dev)
        for j in range(nb - 1, 0, -1):
            acc = ops.add(acc, PointVec({k: v[..., j] for k, v in buckets.items()}))
            tot = ops.add(tot, acc)

        # window combine: T = 2^c T + S_k from the top window down
        T = ops.infinity((1,), dev)
        for k in range(nwin - 1, -1, -1):
            T = ops._window_doubles(T, self.c)
            T = ops.add(T, PointVec({kk: v[..., k : k + 1] for kk, v in tot.items()}))
        return T


@functools.lru_cache(maxsize=None)
def pippenger_for(curve_name: str, group: str, batch: int, nbits: int, c: int = _DEF_C) -> PippengerMSM:
    from .curve import curve_ops

    return PippengerMSM(curve_ops(curve_name, group), batch, nbits, c)
