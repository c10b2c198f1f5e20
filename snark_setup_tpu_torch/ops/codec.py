"""Batched on-device point (de)serialization — the replacement for the
reference's BatchDeserializer/BatchSerializer (C17, setup-utils/src/io/).

Byte<->limb packing is vectorized numpy on the host (pure data movement);
the expensive parts — Montgomery conversion, modular sqrt for decompression,
on-curve checks, batch normalization, sign flags — run on the codec's device
over the whole batch, in the limbs-leading (L[, d], B) layout (see fp.py,
ext.py): Fq coordinates for G1 (and BW6-761's G2), Fp2 / Fp3 for the other
G2 groups.

Wire format is the arkworks encoding (see serialize/arkworks.py): LE field
bytes, coefficient by coefficient, flags in the top 2 bits of an element's
final byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.limb import int_to_limbs
from ..utils.device import resolve_device, to_device
from ..utils.enums import CheckForCorrectness, SubgroupCheckMode, UseCompression
from ..utils.errors import IncorrectSubgroupError, PointAtInfinityError, SerializationError
from .cuda_sqrt import fq_sqrt_for
from .curve import CurveOps, PointVec, curve_ops
from .fp import _sub_with_borrow
from .hostmath import host_ext_one, host_ext_pow

FLAG_Y_NEG = 1 << 7
FLAG_INFINITY = 1 << 6
FLAG_MASK = FLAG_Y_NEG | FLAG_INFINITY


def _batch_shape(F, arr):
    return arr.shape[1:] if F.degree == 1 else arr.shape[2:]


def ext_pow_const(F, a, e: int):
    """a^e in a field-ops object for a host-known (public) exponent; the
    exponent is public, so zero bits skip the multiply."""
    if e == 0:
        return F.ones(_batch_shape(F, a), a.device)
    acc = a
    for bit in bin(e)[3:]:
        acc = F.mul(acc, acc)
        if bit == "1":
            acc = F.mul(acc, a)
    return acc


class PinnedPool:
    """Page-locked host buffers for the write-back's device-to-host copies,
    reused by shape and type: at most `keep` free buffers of each."""

    def __init__(self, keep: int = 8):
        self.keep = keep
        self._free: dict = {}

    def take(self, like: torch.Tensor) -> torch.Tensor:
        free = self._free.get((like.shape, like.dtype))
        if free:
            return free.pop()
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def give(self, bufs) -> None:
        for b in bufs:
            free = self._free.setdefault((b.shape, b.dtype), [])
            if len(free) < self.keep:
                free.append(b)


class WriteHandle:
    """A write-back's four outputs (x, y, infinity and sign flags) on their
    way to the host: host tensors that `event` marks as landed, or the
    outputs themselves on the CPU (no event, no pool)."""

    def __init__(self, parts, event=None, pool: PinnedPool | None = None):
        self.parts, self.event, self.pool = parts, event, pool

    def wait(self) -> tuple:
        """The four outputs as numpy arrays, once their copies landed."""
        if self.event is not None:
            self.event.synchronize()
        return tuple(t.numpy() for t in self.parts)

    def release(self) -> None:
        if self.pool is not None:
            self.pool.give(self.parts)
            self.pool = None


class ExtSqrt:
    """Branchless Tonelli–Shanks over Fp / Fp2 / Fp3 on device. Over Fq the
    whole chain is one launch of the square-root kernel (ops/cuda_sqrt.py;
    its plain version on the CPU); over Fp2 / Fp3 every product is a round
    of the tower's stacked-product route."""

    def __init__(self, F, q: int):
        self.F = F
        self.q = q
        self.group_order = q**F.degree - 1
        s, e = self.group_order, 0
        while s % 2 == 0:
            s //= 2
            e += 1
        self.e, self.s = e, s
        self._find_nonresidue()

    def _find_nonresidue(self):
        """A non-residue of the coordinate field (host search, fixed seed:
        the same element as the reference's)."""
        import random

        rng = random.Random(99)
        q, d = self.q, self.F.degree
        nr = getattr(self.F, "nr", 0)
        half = self.group_order // 2
        while True:
            coeffs = tuple(rng.randrange(q) for _ in range(d))
            if host_ext_pow(coeffs, half, q, d, nr) != host_ext_one(d):
                self.z_coeffs = coeffs
                break

    def c_init(self) -> np.ndarray:
        """(L[, d], 1) host constant: z^s, generator of the 2-Sylow group."""
        d = self.F.degree
        return self.F.from_coeffs([host_ext_pow(self.z_coeffs, self.s, self.q, d, getattr(self.F, "nr", 0))])

    def sqrt(self, a):
        """(root, is_square mask). The loop bounds depend only on the
        field's 2-adicity, never on the data."""
        F = self.F
        if F.degree == 1:
            return fq_sqrt_for(self.q, self.z_coeffs[0])(a)
        if self.e == 1:
            r = ext_pow_const(F, a, (self.group_order + 2) // 4)
            ok = F.eq(F.mul(r, r), a) | F.is_zero(a)
            return r, ok
        w = ext_pow_const(F, a, (self.s - 1) // 2)
        r = F.mul(a, w)
        t = F.mul(r, w)
        c = F.const(("sqrt_c", self.q, F.degree), self.c_init(), a).expand_as(a)
        one = F.ones(_batch_shape(F, a), a.device)
        for i in range(self.e, 1, -1):
            b = t
            for _ in range(i - 2):
                b = F.mul(b, b)
            flip = ~F.eq(b, one)
            r = F.select(flip, F.mul(r, c), r)
            c = F.mul(c, c)
            t = F.select(flip, F.mul(t, c), t)
        ok = F.eq(F.mul(r, r), a) | F.is_zero(a)
        return r, ok


class BatchPointCodec:
    """Vectorized device codec for one source group on one device."""

    def __init__(self, ops: CurveOps, device=None):
        self.ops = ops
        self.device = resolve_device(device)
        self.F = ops.field
        self.fp = ops.fq
        self.spec = ops.spec
        self.deg = self.F.degree
        self.fp_bytes = ops.spec.fp_bytes
        self.compressed_size = self.deg * self.fp_bytes
        self.uncompressed_size = 2 * self.compressed_size
        self.sqrter = ExtSqrt(self.F, ops.spec.q)
        self._q_limbs = int_to_limbs(self.spec.q, self.fp.L)
        self._r_limbs = int_to_limbs(self.spec.r, ops.fr.L)
        self._write_selfchecked = False
        self._pinned = PinnedPool()

    def size(self, compression: UseCompression) -> int:
        return (
            self.compressed_size
            if compression is UseCompression.YES
            else self.uncompressed_size
        )

    # -- numpy byte <-> raw (standard form) limb planes -------------------
    def _bytes_to_fp_limbs(self, buf: np.ndarray) -> np.ndarray:
        """(B, fp_bytes) uint8 -> (L, B) int32 (standard form, unmasked)."""
        B = buf.shape[0]
        want = 2 * self.fp.L
        padded = np.zeros((B, want), np.uint8)
        padded[:, : self.fp_bytes] = buf
        u16 = padded.view("<u2")
        return np.ascontiguousarray(u16.astype(np.int32).T)

    def _fp_limbs_to_bytes(self, limbs: np.ndarray) -> np.ndarray:
        """(L, B) integer limbs -> (B, fp_bytes) uint8."""
        u16 = np.asarray(limbs).T.astype("<u2")
        raw = np.ascontiguousarray(u16).view(np.uint8)
        return raw[:, : self.fp_bytes]

    def _parse_coord(self, buf: np.ndarray, mask_flags: bool):
        """(B, deg*fp_bytes) -> (raw limbs (L[, d], B), flags (B,))."""
        flags = (buf[:, -1] & FLAG_MASK).copy()
        work = buf.copy()
        if mask_flags:
            work[:, -1] &= ~FLAG_MASK & 0xFF
        planes = [
            self._bytes_to_fp_limbs(work[:, i * self.fp_bytes : (i + 1) * self.fp_bytes])
            for i in range(self.deg)
        ]
        return (planes[0] if self.deg == 1 else np.stack(planes, axis=1)), flags

    def _range_check(self, raw: np.ndarray) -> np.ndarray:
        """True where every coefficient < q (vectorized bigint compare).
        raw: (L[, d], B) -> (B,)."""
        flat = raw.reshape(self.fp.L, -1)
        lt = np.zeros(flat.shape[1], bool)
        decided = np.zeros(flat.shape[1], bool)
        for k in range(self.fp.L - 1, -1, -1):
            less = flat[k] < self._q_limbs[k]
            more = flat[k] > self._q_limbs[k]
            lt |= (~decided) & less
            decided |= less | more
        # equal -> not < q -> invalid
        return lt.reshape(self.deg, -1).all(axis=0)

    # -- lexicographic y comparison ("is negative" flag) -------------------
    def y_is_negative(self, y_mont: torch.Tensor) -> torch.Tensor:
        """y > -y, comparing the highest coefficient first. Returns a (B,)
        bool tensor. Works on Montgomery inputs."""
        y_std = self.fp.from_mont(y_mont)
        coeffs = [y_std] if self.deg == 1 else [y_std[:, i] for i in range(self.deg)]
        result = decided = None
        for c in reversed(coeffs):
            n = self.fp.neg(c)
            _, gt = _sub_with_borrow(n, c)  # c > n  <=>  n - c borrows
            _, lt = _sub_with_borrow(c, n)
            if result is None:
                result, decided = gt, gt | lt
            else:
                result = result | (~decided & gt)
                decided = decided | gt | lt
        return result

    # -- curve equation ----------------------------------------------------
    def rhs(self, x):
        """x^3 + a x + b in the coordinate field (device, Montgomery)."""
        F = self.F
        ops = self.ops
        x3 = F.mul(F.mul(x, x), x)
        if not ops.a_is_zero:
            x3 = F.add(x3, F.mul(ops._const("a_np", x).expand_as(x), x))
        return F.add(x3, ops._const("b_np", x).expand_as(x))

    def on_curve_mask(self, p: PointVec):
        """Affine (Z in {0,1}) points: y^2 == rhs(x) or infinity."""
        F = self.F
        ok = F.eq(F.mul(p["y"], p["y"]), self.rhs(p["x"]))
        return ok | self.ops.is_infinity(p)

    # -- subgroup membership ------------------------------------------------
    def subgroup_mask(self, p: PointVec) -> torch.Tensor:
        """Prime-order-subgroup membership mask per element (Direct mode;
        infinity counts as in-group), on the points' device: the card's
        kernels, or their plain versions on the CPU. The reference's
        `subgroup_mask_direct`; its host-bigint fallback for XLA:CPU
        (`subgroup_mask_host`) has no counterpart here.

        Where the curve's GLV eigenvalue e satisfies e^2 + e + 1 == r
        exactly (the BLS12 groups), ker(phi - [e]) has order r and equals
        the subgroup, so `phi(P) == [e]P` decides membership with a ladder
        as wide as e (ops/glv.py). Elsewhere it is [r]P == O — both through
        the raw windowed ladder, never the GLV one: GLV computes [k mod r]P
        only inside the subgroup, and r = 0 mod r would pass every point.

        The complete formulas are exact except where the two summands differ
        by a point of order 2 (BW6-761 and BLS12-377 G1 have such points):
        there they return (0 : 0 : 0), which every later operation keeps.
        That never happens inside the odd-order subgroup, so a ladder that
        ends in (0 : 0 : 0) marks a point outside it — where the reference
        counts (0 : 0 : 0) as infinity (Z = 0) and accepts the point."""
        ops, F = self.ops, self.F
        B = p["x"].shape[-1]
        dev = p["x"].device
        if ops._endo_check is not None:
            lam_limbs, lam_bits, lam_neg = ops._endo_check
            scalars = to_device(lam_limbs.astype(np.int32), dev).expand(lam_limbs.shape[0], B)
            lp = ops.scalar_mul_windowed(p, scalars, nbits=lam_bits)
            if lam_neg:
                lp = ops.neg(lp)
            proper = ~(F.is_zero(lp["y"]) & F.is_zero(lp["z"]))  # not (0 : 0 : 0)
            return ops.eq_projective(lp, ops.endo(p)) & proper
        r = to_device(self._r_limbs.astype(np.int32), dev)
        prod = ops.scalar_mul_windowed(p, r[:, None].expand(r.shape[0], B))
        return ops.is_infinity(prod) & ~F.is_zero(prod["y"])

    # -- public batch API --------------------------------------------------
    def read_batch(
        self,
        data,
        compression: UseCompression,
        check: CheckForCorrectness = CheckForCorrectness.NO,
        subgroup_mode: SubgroupCheckMode = SubgroupCheckMode.AUTO,
        pad_to: int | None = None,
    ) -> PointVec:
        """Parse a contiguous batch of points into device projective form
        (Z=1, or Z=0 for infinity). Raises on malformed/invalid content
        according to `check` (mirrors reference read_batch semantics).

        `pad_to` pads the batch with infinity points up to a fixed size;
        validation ignores the padding."""
        size = self.size(compression)
        buf = (
            np.frombuffer(data, np.uint8)
            if isinstance(data, (bytes, bytearray, memoryview))
            else np.asarray(data, np.uint8)
        )
        if buf.size % size:
            raise SerializationError(f"batch length {buf.size} not multiple of {size}")
        n = buf.size // size
        rows = buf.reshape(n, size)
        if pad_to is not None and pad_to > n:
            pad_rows = np.zeros((pad_to - n, size), np.uint8)
            # mark padding as infinity via the flag byte of the final coord
            pad_rows[:, -1] = FLAG_INFINITY
            rows = np.concatenate([rows, pad_rows], axis=0)

        if compression is UseCompression.YES:
            x_raw, flags = self._parse_coord(rows, mask_flags=True)
            y_raw = None
            in_range = self._range_check(x_raw).all()
        else:
            x_raw, _xf = self._parse_coord(rows[:, : self.compressed_size], mask_flags=False)
            y_raw, flags = self._parse_coord(rows[:, self.compressed_size :], mask_flags=True)
            in_range = self._range_check(x_raw).all() and self._range_check(y_raw).all()
        if not in_range:
            raise SerializationError("coordinate out of field range")
        inf = (flags & FLAG_INFINITY) != 0
        neg = (flags & FLAG_Y_NEG) != 0
        if (inf & neg).any():
            raise SerializationError("invalid flags (both set)")

        dev = self.device
        inf_d = to_device(inf, dev)
        x = self.fp.to_mont_raw(to_device(x_raw, dev))
        if y_raw is None:
            y, ok = self.sqrter.sqrt(self.rhs(x))
            if not bool((ok | inf_d).all()):
                raise SerializationError("x not on curve (no sqrt)")
            flip = self.y_is_negative(y) != to_device(neg, dev)
            y = self.F.select(flip, self.F.neg(y), y)
        else:
            y = self.fp.to_mont_raw(to_device(y_raw, dev))
        F = self.F
        one, zero = F.ones((1,), dev), F.zeros((1,), dev)
        p = PointVec(
            x=F.select(inf_d, zero, x), y=F.select(inf_d, one, y), z=F.select(inf_d, zero, one)
        )
        self.validate(p, check, subgroup_mode, compression, n_valid=n)
        return p

    def validate(
        self,
        p: PointVec,
        check: CheckForCorrectness,
        subgroup_mode: SubgroupCheckMode = SubgroupCheckMode.AUTO,
        compression: UseCompression = UseCompression.NO,
        n_valid: int | None = None,
    ) -> None:
        """Raise per `check` on the first `n_valid` lanes (default: all):
        infinity (FULL, ONLY_NON_ZERO), off the curve (FULL, ONLY_IN_GROUP;
        compressed points are on the curve by construction) and outside the
        prime-order subgroup (FULL, ONLY_IN_GROUP, unless `subgroup_mode` is
        NO)."""
        if check is CheckForCorrectness.NO:
            return
        inf = self.ops.is_infinity(p)
        batch = int(inf.shape[-1])
        valid = torch.arange(batch, device=inf.device) < (batch if n_valid is None else n_valid)
        if check in (CheckForCorrectness.FULL, CheckForCorrectness.ONLY_NON_ZERO):
            if bool((inf & valid).any()):
                raise PointAtInfinityError("point at infinity in batch")
        if check in (CheckForCorrectness.FULL, CheckForCorrectness.ONLY_IN_GROUP):
            if compression is not UseCompression.YES:
                if not bool((self.on_curve_mask(p) | ~valid).all()):
                    raise SerializationError("point not on curve")
            if subgroup_mode is not SubgroupCheckMode.NO:
                if not bool((self.subgroup_mask(p) | inf | ~valid).all()):
                    raise IncorrectSubgroupError("point not in prime-order subgroup")

    def _write_device(self, p: PointVec, normalized: bool = False):
        if normalized:
            x, y, inf = p["x"], p["y"], self.ops.is_infinity(p)
        else:
            x, y, inf = self.ops.normalize(p)
        neg = self.y_is_negative(y)
        return self.fp.from_mont(x), self.fp.from_mont(y), inf, neg

    def write_batch_start(self, p: PointVec, normalized: bool = False) -> "WriteHandle":
        """Device half of write_batch: normalize, de-Montgomery, sign and
        infinity flags. On the card the four outputs are copied into
        page-locked host buffers of the codec's pool on the current stream,
        behind an event, and nothing waits for the card; on the CPU the
        handle holds them as they are. Returns the handle for
        write_batch_finish."""
        parts = self._write_device(p, normalized)
        if parts[0].device.type != "cuda":
            return WriteHandle(parts)
        bufs = tuple(self._pinned.take(t) for t in parts)
        for dst, src in zip(bufs, parts):
            dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(parts[0].device))
        return WriteHandle(bufs, event, self._pinned)

    def write_batch_finish(
        self,
        handle: "WriteHandle",
        compression: UseCompression,
        n_valid: int | None = None,
    ) -> bytes:
        """Host half of write_batch: wait for the handle's copies, pack wire
        bytes, give the buffers back to the pool."""
        out = self._finish_one(handle.wait(), compression, n_valid)
        handle.release()
        if not self._write_selfchecked and out:
            self._selfcheck_write(out, compression)
        return out

    # One-time (per codec instance) host cross-check of written bytes: for
    # a ceremony tool corrupt output is the worst failure mode. Parsing a
    # few points of the first written batch with the independent HOST codec
    # (on-curve + subgroup check included) turns a wrong device result into
    # a loud error at negligible cost.
    def _selfcheck_write(self, out: bytes, compression: UseCompression) -> None:
        from ..serialize.arkworks import g1_codec, g2_codec

        hostc = (
            g1_codec(self.spec)
            if self.ops.group_name == "g1"
            else g2_codec(self.spec)
        )
        size = self.size(compression)
        n = min(4, len(out) // size)
        for i in range(n):
            hostc.deserialize(
                out[i * size : (i + 1) * size],
                compression,
                CheckForCorrectness.ONLY_IN_GROUP,
            )
        self._write_selfchecked = True

    def _finish_one(self, parts, compression: UseCompression, n_valid: int | None = None) -> bytes:
        x_std, y_std, inf_np, neg = parts
        if n_valid is not None:
            x_std = x_std[..., :n_valid]
            y_std = y_std[..., :n_valid]
            inf_np = inf_np[:n_valid]
            neg = neg[:n_valid]
        # zero out coords at infinity
        x_std = np.where(inf_np, 0, x_std)
        y_std = np.where(inf_np, 0, y_std)
        flags = np.where(inf_np, FLAG_INFINITY, np.where(~inf_np & neg, FLAG_Y_NEG, 0))

        def coord_bytes(raw):
            planes = [raw] if self.deg == 1 else [raw[:, i] for i in range(self.deg)]
            return np.concatenate([self._fp_limbs_to_bytes(pl) for pl in planes], axis=1)

        if compression is UseCompression.YES:
            out = coord_bytes(x_std)
            out[:, -1] |= flags.astype(np.uint8)
        else:
            yb = coord_bytes(y_std)
            yb[:, -1] |= flags.astype(np.uint8)
            out = np.concatenate([coord_bytes(x_std), yb], axis=1)
        return out.tobytes()

    def write_batch(
        self,
        p: PointVec,
        compression: UseCompression,
        normalized: bool = False,
        n_valid: int | None = None,
    ) -> bytes:
        """Device points -> wire bytes. Normalizes (batch-inverts Z) unless
        the caller guarantees affine form. `n_valid` drops padding rows."""
        return self.write_batch_finish(
            self.write_batch_start(p, normalized), compression, n_valid
        )


_codecs: dict = {}


def batch_codec(curve_name: str, group: str, device=None) -> BatchPointCodec:
    """The codec of one (curve, group) on one device (default: the card)."""
    dev = resolve_device(device)
    ops = curve_ops(curve_name, group)
    key = (ops, dev)
    if key not in _codecs:
        _codecs[key] = BatchPointCodec(ops, dev)
    return _codecs[key]
