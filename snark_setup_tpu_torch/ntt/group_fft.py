"""Radix-2 (I)FFT over batched curve points — prepare_phase2's transform.

Reference behavior: ark-poly `domain.ifft` applied to projective points
(setup-utils/src/groth16_utils.rs:44-53); the reference package's
`ntt/group_fft.py`. Design:

- a bit-reverse gather (`index_select` on the device), then log2(n)
  butterfly stages as one plain Python loop; each stage is one batched GLV
  `scalar_mul` of the odd half by the stage's twiddles (K3 + K4 on the card
  for Fq coordinates) and two batched `add`s (K2), `even + t` and
  `even - t`; an inverse transform ends with one scalar-mul by 1/n;
- the twiddles are made on the host once per (curve, group, n, direction,
  device) — n/2 powers of omega, converted to limbs in one call and tiled
  per stage with numpy — and kept on the device;
- stage 1's twiddles are all 1 and the forward transform's scale is 1: both
  multiplications are skipped (the reference runs them; the points, and so
  every affine output and byte, are the same);
- everything stays projective until the caller normalizes.

Also `h_query_device`: h[i] = tau^(i+m)·G − tau^i·G for i < m−1
(groth16_utils.rs:59-63), one batched add of negated slices.

No launch spans more than `ops/lanes.py: MAX_LANES` lanes; a wider batch is
cut into slices of that width and put back together, which changes no value.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.limb import ints_to_limbs_batch
from ..ops.curve import CurveOps, PointVec, curve_ops
from ..ops.lanes import lanewise
from .domain import Radix2Domain


def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


class GroupFFT:
    """(I)FFT over the batch axis of a PointVec for one fixed domain size."""

    def __init__(self, ops: CurveOps, domain: Radix2Domain):
        if ops.spec.r != domain.r:
            raise ValueError("the domain must be over this curve's Fr")
        self.ops = ops
        self.domain = domain
        self.n = domain.size
        self._tables: dict = {}

    # -- tables ------------------------------------------------------------
    def twiddle_limbs(self, omega: int) -> np.ndarray:
        """(Ls, n/2) raw limbs of omega^k, k < n/2: every stage's twiddles
        are a strided subset of these."""
        r, half = self.domain.r, max(self.n // 2, 1)
        powers = [1] * half
        for k in range(1, half):
            powers[k] = powers[k - 1] * omega % r
        return np.ascontiguousarray(ints_to_limbs_batch(powers, self.ops.fr.L).T)

    def tables(self, inverse: bool, device) -> tuple:
        """(bit-reverse indices, per-stage twiddles from stage 2 on, 1/n
        scale or None) on `device`, made on the first call for it."""
        device = torch.device(device)
        key = (inverse, device)
        if key not in self._tables:
            n, fr = self.n, self.ops.fr
            omega = self.domain.group_gen_inv if inverse else self.domain.group_gen
            pw = self.twiddle_limbs(omega)
            stages = []
            m = 4
            while m <= n:
                # block-major: lane (block, j) takes omega^(j n / m)
                idx = np.tile(np.arange(m // 2) * (n // m), n // m)
                stages.append(fr.tensor(pw[:, idx], device))
                m <<= 1
            scale = None
            if inverse:
                inv = ints_to_limbs_batch([self.domain.size_inv], fr.L).T
                scale = fr.tensor(np.broadcast_to(inv, (fr.L, n)), device)
            rev = torch.from_numpy(_bit_reverse_indices(n)).to(device)
            self._tables[key] = (rev, stages, scale)
        return self._tables[key]

    # -- transform ---------------------------------------------------------
    def _butterflies(self, x: PointVec, m: int, tw) -> PointVec:
        """One stage over blocks of m points: (even, odd) -> (even + tw odd,
        even - tw odd), tw = None meaning all ones. The batch may be any
        whole number of blocks (one shard of the transform: shard/mesh.py)."""
        ops, n, half = self.ops, int(x["x"].shape[-1]), m // 2

        def part(v, i):  # lanes (block, i, j) of v -> (..., n/2), block-major
            return v.reshape(*v.shape[:-1], n // m, 2, half)[..., i, :].reshape(*v.shape[:-1], n // 2)

        even = PointVec({k: part(v, 0) for k, v in x.items()})
        odd = PointVec({k: part(v, 1) for k, v in x.items()})
        t = odd if tw is None else lanewise(ops.scalar_mul, odd, tw)
        hi = lanewise(ops.add, even, t)
        lo = lanewise(ops.add, even, ops.neg(t))

        def join(a, b):
            lead = a.shape[:-1]
            return torch.stack([a.reshape(*lead, n // m, half), b.reshape(*lead, n // m, half)], dim=-2).reshape(
                *lead, n)

        return PointVec({k: join(hi[k], lo[k]) for k in ("x", "y", "z")})

    def _transform(self, p: PointVec, inverse: bool) -> PointVec:
        if p["z"].shape[-1] != self.n:
            raise ValueError(f"expected {self.n} points, got {p['z'].shape[-1]}")
        rev, stages, scale = self.tables(inverse, p["x"].device)
        x = PointVec({k: v.index_select(-1, rev) for k, v in p.items()})
        if self.n > 1:
            x = self._butterflies(x, 2, None)
        for s, tw in enumerate(stages):
            x = self._butterflies(x, 4 << s, tw)
        if scale is not None:
            x = lanewise(self.ops.scalar_mul, x, scale)
        return x

    def ifft(self, p: PointVec) -> PointVec:
        """Evaluations -> coefficient points (interpolation over the domain)."""
        return self._transform(p, True)

    def fft(self, p: PointVec) -> PointVec:
        """Coefficient points -> evaluations over the domain."""
        return self._transform(p, False)


@functools.lru_cache(maxsize=None)
def group_fft(curve_name: str, group: str, num_coeffs: int) -> GroupFFT:
    """The one GroupFFT (and its tables) of a (curve, group, domain)."""
    return GroupFFT(curve_ops(curve_name, group), Radix2Domain(curve_name, num_coeffs))


def h_query_device(ops: CurveOps, powers: PointVec, degree: int) -> PointVec:
    """h[i] = powers[i+degree] − powers[i] for i in 0..degree-2, batched
    (setup-utils/src/groth16_utils.rs:59-63)."""
    hi = PointVec({k: v[..., degree : 2 * degree - 1] for k, v in powers.items()})
    lo = PointVec({k: v[..., : degree - 1] for k, v in powers.items()})
    return lanewise(lambda a, b: ops.add(a, ops.neg(b)), hi, lo)
