"""Pure-Python phase-2 contribution (reference phase2/src/lib.rs:15-66).

The wasm crate's `contribute_challenge` deserializes an uncompressed
MPCParameters challenge, applies one delta contribution, and reserializes
the response compressed, seeding its RNG from user/system randomness. This
module reproduces that capability without importing JAX: point
vectors are read/written with the per-element host arkworks codecs and the
delta^-1 multiplications run on the pure-Python host curve. Throughput is
browser-grade, which matches the capability's purpose — portability of the
*participant*, not the coordinator.

Wire format handled here is exactly MPCParameters (SURVEY §2.9.4 /
parameters.rs:438-516): [ProvingKey ‖ cs_hash(64) ‖ u32-BE count ‖
count × pubkeys], with the ProvingKey in ark derive order (vk ‖ beta_g1 ‖
delta_g1 ‖ u64-LE-prefixed a/b_g1/b_g2/h/l queries).
"""

from __future__ import annotations

import secrets

from ..curves.constants import get_curve
from ..curves.host import g1_curve, g2_curve
from ..phase2.keypair import Keypair, Phase2PublicKey
from ..serialize.arkworks import g1_codec, g2_codec
from ..transcript.hashing import derive_rng_from_seed, user_system_randomness
from ..utils.enums import CheckForCorrectness, UseCompression

# curve-kind aliases used by the reference wasm API (lib.rs:24-28):
# "inner" = the curve proofs are over, "outer" = the wrapping curve
_CURVE_ALIASES = {"inner": "bls12_377", "outer": "bw6_761"}


class _Cursor:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = bytes(self.data[self.pos : self.pos + n])
        if len(out) != n:
            raise EOFError(f"expected {n} bytes at {self.pos}")
        self.pos += n
        return out

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")


def _read_el(codec, cur: _Cursor, compression: UseCompression):
    size = codec.size(compression)
    return codec.deserialize(cur.take(size), compression, CheckForCorrectness.NO)


def _read_vec(codec, cur: _Cursor, compression: UseCompression):
    n = cur.u64()
    return [_read_el(codec, cur, compression) for _ in range(n)]


def _write_el(codec, pt, compression: UseCompression) -> bytes:
    return codec.serialize(pt, compression)


def _write_vec(codec, pts, compression: UseCompression) -> bytes:
    out = [len(pts).to_bytes(8, "little")]
    out.extend(codec.serialize(p, compression) for p in pts)
    return b"".join(out)


def contribute_challenge(
    challenge: bytes,
    curve_kind: str = "inner",
    seed: bytes | None = None,
) -> tuple[bytes, bytes]:
    """One portable phase-2 contribution.

    challenge: uncompressed MPCParameters bytes (the coordinator's chunk or
    full challenge). Returns (response_bytes, contribution_hash) with the
    response compressed — the exact artifact the reference wasm contributor
    produces (lib.rs:30-50). `seed` (>= 32 bytes) makes the contribution
    deterministic via the NIM-SEED derivation; omitted, entropy comes from
    the OS like `user_system_randomness` (helpers.rs:143-164)."""
    name = _CURVE_ALIASES.get(curve_kind, curve_kind)
    spec = get_curve(name)
    c1, c2 = g1_codec(spec), g2_codec(spec)
    unc = UseCompression.NO

    cur = _Cursor(challenge)
    # VerifyingKey: alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc
    alpha_g1 = _read_el(c1, cur, unc)
    beta_g2 = _read_el(c2, cur, unc)
    gamma_g2 = _read_el(c2, cur, unc)
    delta_g2 = _read_el(c2, cur, unc)
    gamma_abc = _read_vec(c1, cur, unc)
    beta_g1 = _read_el(c1, cur, unc)
    delta_g1 = _read_el(c1, cur, unc)
    a_query = _read_vec(c1, cur, unc)
    b_g1_query = _read_vec(c1, cur, unc)
    b_g2_query = _read_vec(c2, cur, unc)
    h_query = _read_vec(c1, cur, unc)
    l_query = _read_vec(c1, cur, unc)
    cs_hash = cur.take(64)
    contributions, _ = Phase2PublicKey.read_batch(spec, cur.data, cur.pos)

    if seed is None:
        seed = user_system_randomness(prompt=False) + secrets.token_bytes(32)
    rng = derive_rng_from_seed(seed)

    kp = Keypair.new(spec, rng, delta_g1, cs_hash, contributions)
    delta = kp.private_key.delta
    delta_inv = pow(delta, -1, spec.r)
    g1c, g2c = g1_curve(spec), g2_curve(spec)
    l_query = [g1c.mul(p, delta_inv) for p in l_query]
    h_query = [g1c.mul(p, delta_inv) for p in h_query]
    delta_g1 = g1c.mul(delta_g1, delta)
    delta_g2 = g2c.mul(delta_g2, delta)
    contributions = contributions + [kp.public_key]

    comp = UseCompression.YES
    response = b"".join(
        [
            _write_el(c1, alpha_g1, comp),
            _write_el(c2, beta_g2, comp),
            _write_el(c2, gamma_g2, comp),
            _write_el(c2, delta_g2, comp),
            _write_vec(c1, gamma_abc, comp),
            _write_el(c1, beta_g1, comp),
            _write_el(c1, delta_g1, comp),
            _write_vec(c1, a_query, comp),
            _write_vec(c1, b_g1_query, comp),
            _write_vec(c2, b_g2_query, comp),
            _write_vec(c1, h_query, comp),
            _write_vec(c1, l_query, comp),
            cs_hash,
            Phase2PublicKey.write_batch(spec, contributions),
        ]
    )
    return response, kp.public_key.hash(spec)


def _main(argv=None) -> int:
    """CLI shim: `python -m snark_setup_tpu_torch.portable.contributor
    <challenge> <response> [--curve inner] [--seed-file f]`."""
    import argparse

    ap = argparse.ArgumentParser(description="portable phase-2 contributor")
    ap.add_argument("challenge")
    ap.add_argument("response")
    ap.add_argument("--curve", default="inner")
    ap.add_argument("--seed-file", default=None)
    args = ap.parse_args(argv)
    with open(args.challenge, "rb") as f:
        data = f.read()
    seed = None
    if args.seed_file:
        with open(args.seed_file) as f:
            seed = bytes.fromhex(f.read().strip())
    resp, h = contribute_challenge(data, args.curve, seed)
    with open(args.response, "wb") as f:
        f.write(resp)
    print(h.hex())
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())
