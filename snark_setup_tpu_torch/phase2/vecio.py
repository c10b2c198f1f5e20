"""Point-vector (de)serialization helpers for phase-2 wire formats.

ark-serialize 0.4 conventions (SURVEY §2.9.4): Vec<Affine> is a u64
little-endian length prefix followed by the elements; single elements are
bare. Batched byte<->point conversion runs through the port's batch codec
(ops/codec.py) on the chosen device (default: the card), in slices of at
most `ops/lanes.py: MAX_LANES` points, so large query vectors never take the
per-element host path.
"""

from __future__ import annotations

from ..curves.constants import CurveSpec
from ..curves.host import AffinePoint
from ..ops.codec import batch_codec
from ..ops.lanes import spans
from ..serialize.arkworks import g1_codec, g2_codec
from ..utils.enums import CheckForCorrectness, SubgroupCheckMode, UseCompression


class Cursor:
    """Minimal reader over bytes-like data."""

    def __init__(self, data, pos: int = 0):
        self.data = memoryview(data)
        self.pos = pos

    def take(self, n: int) -> bytes:
        out = bytes(self.data[self.pos : self.pos + n])
        if len(out) != n:
            raise EOFError(f"expected {n} bytes, got {len(out)}")
        self.pos += n
        return out

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def skip(self, n: int) -> None:
        self.pos += n


def _host_codec(spec: CurveSpec, group: str):
    return g1_codec(spec) if group == "g1" else g2_codec(spec)


def ser_element(spec: CurveSpec, group: str, p: AffinePoint, compression: UseCompression) -> bytes:
    return _host_codec(spec, group).serialize(p, compression)


def deser_element(
    spec: CurveSpec, group: str, cur: Cursor, compression: UseCompression, check: CheckForCorrectness
) -> AffinePoint:
    host = _host_codec(spec, group)
    return host.deserialize(cur.take(host.size(compression)), compression, check)


def ser_vec(
    spec: CurveSpec,
    group: str,
    pts: list[AffinePoint],
    compression: UseCompression,
    prefix: bool = True,
    device=None,
) -> bytes:
    """u64-LE-length-prefixed (or exact) vector of points, device-batched."""
    head = len(pts).to_bytes(8, "little") if prefix else b""
    if not pts:
        return head
    dev = batch_codec(spec.name, group, device)
    return head + b"".join(
        dev.write_batch(dev.ops.from_affine_host(pts[lo:hi], dev.device), compression, normalized=True)
        for lo, hi in spans(len(pts))
    )


def deser_vec(
    spec: CurveSpec,
    group: str,
    cur: Cursor,
    compression: UseCompression,
    check: CheckForCorrectness,
    count: int | None = None,
    subgroup_mode: SubgroupCheckMode = SubgroupCheckMode.AUTO,
    device=None,
) -> list[AffinePoint]:
    """Read `count` points (or a u64-prefixed vector when count is None)."""
    n = cur.u64() if count is None else count
    if n == 0:
        return []
    dev = batch_codec(spec.name, group, device)
    size = dev.size(compression)
    raw = cur.take(n * size)
    out: list[AffinePoint] = []
    for lo, hi in spans(n):
        pts = dev.read_batch(raw[lo * size : hi * size], compression, check, subgroup_mode=subgroup_mode)
        out.extend(dev.ops.to_affine_host(pts))
    return out


def skip_vec(spec: CurveSpec, group: str, cur: Cursor, compression: UseCompression) -> int:
    """Skip a u64-prefixed vector; returns its element count
    (chunked_groth16.rs:376-381)."""
    n = cur.u64()
    cur.skip(n * _host_codec(spec, group).size(compression))
    return n
