"""Multi-scalar multiplication: over PUBLIC (verifier-side) scalars, and the
constant-time MSM for SECRET ones.

One chooser for the random-linear-combination ratio checks of phase 1 and
phase 2 (`msm_public`):
Pippenger buckets (ops/pippenger.py) from PIPPENGER_MIN points up, the raw
windowed ladder + tree reduction below. Both run the group law of
ops/curve.py — K2 on Fq coordinates with a = 0, K5 rounds elsewhere — on the
card, and their plain versions on CPU tensors.

Secret-scalar paths (contribution, key material, the prover's witness) must
NOT take `msm_public`: they use `msm_secret`, the constant-time GLV ladder.

Replaces the reference's ops/msm.py (msm_public, msm_secret, RLC scalar
generation); its host-bigint fallbacks for XLA:CPU have no counterpart here.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..fields.limb import LIMB_BITS, ints_to_limbs_batch
from ..utils.device import to_device
from .curve import CurveOps, PointVec
from .lanes import lanewise

RLC_BITS = 128
"""Width of random-linear-combination scalars: the ~2^-128 collision bound
is all soundness needs, and half the field width halves both the ladder and
the Pippenger window count."""

PIPPENGER_MIN = 1 << 9
"""Batch size from which public-scalar MSMs use the Pippenger buckets."""


def rlc_scalars(n: int, bits: int = RLC_BITS, rng=None) -> np.ndarray:
    """n random `bits`-wide scalars as raw 16-bit limb planes (Ls, n), host
    numpy; `rng` (a `random.Random`) makes them reproducible, drawn as the
    reference draws them."""
    L = -(-bits // LIMB_BITS)
    if rng is None:
        vals = [secrets.randbits(bits) for _ in range(n)]
    else:
        vals = [rng.randrange(1 << bits) for _ in range(n)]
    return np.ascontiguousarray(ints_to_limbs_batch(vals, L).T)


def rlc_scalars_padded(n: int, pad: int, bits: int = RLC_BITS, rng=None) -> np.ndarray:
    """n random scalars zero-padded to `pad` columns (padding scalars
    multiply padding infinity points: the identity of the sum)."""
    out = rlc_scalars(n, bits, rng)
    if pad > n:
        out = np.concatenate([out, np.zeros((out.shape[0], pad - n), out.dtype)], axis=1)
    return out


def msm_public(ops: CurveOps, pts: PointVec, scalars_raw: np.ndarray, nbits: int) -> PointVec:
    """sum_i k_i P_i over public scalars `scalars_raw` ((Ls, B) host raw
    limbs, at most `nbits` wide); returns a 1-point PointVec on the points'
    device. Any point may be off the subgroup: no GLV."""
    B = int(pts["x"].shape[-1])
    if B >= PIPPENGER_MIN:
        from .pippenger import pippenger_for

        return pippenger_for(ops.spec.name, ops.group_name, B, nbits)(pts, scalars_raw)
    dev = pts["x"].device
    scalars = to_device(np.asarray(scalars_raw).astype(np.int32), dev)
    return ops.sum_reduce(ops.scalar_mul_windowed(pts, scalars, nbits=nbits))


def msm_secret(ops: CurveOps, pts: PointVec, scalars_raw) -> PointVec:
    """sum_i k_i P_i for SECRET scalars (prover witness, key material): the
    GLV scalar-mul (K3 + K4 on the card for Fq coordinates), then the tree
    reduction (K2). No host digit recoding, no data-dependent bucket gather,
    no skipping of zero scalars: every scalar does the same work, so the
    device's time and memory traffic do not depend on the witness. The
    bases must lie in the prime-order subgroup (the GLV contract).
    `scalars_raw`: (Ls, B) raw limbs, host numpy or a tensor; returns a
    1-point PointVec on the points' device."""
    dev = pts["x"].device
    if not isinstance(scalars_raw, torch.Tensor):
        scalars_raw = ops.fr.tensor(np.asarray(scalars_raw), dev)
    return ops.sum_reduce(lanewise(ops.scalar_mul, pts, scalars_raw.to(dev)))
