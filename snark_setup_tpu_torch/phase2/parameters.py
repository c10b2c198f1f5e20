"""MPCParameters — the phase-2 Groth16 MPC over the delta trapdoor.

Reference: phase2/src/parameters.rs. Wire format (SURVEY §2.9.4):
[ProvingKey (ark derive order: vk ‖ beta_g1 ‖ delta_g1 ‖ u64-LE-prefixed
a/b_g1/b_g2/h/l queries) ‖ cs_hash(64) ‖ u32-BE count ‖ count × pubkeys].
Hot paths on the chosen device (default: the card): the QAP evaluation of
`new`, the delta^-1 batch multiplication of the h/l queries (contribute,
parameters.rs:286-307; K3 + K4) and the RLC merge-pairs MSMs of verify
(parameters.rs:393-407; Pippenger on K2), and the (de)serialization of the
query vectors. Every method that computes takes `device` (None: the card).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from ..curves.constants import CurveSpec
from ..curves.host import AffinePoint, g1_curve, g2_curve
from ..curves.pairing import pairing_engine
from ..fields.limb import ints_to_limbs_batch
from ..ops.curve import CurveOps, PointVec, curve_ops
from ..ops.lanes import lanewise
from ..transcript.hashing import hash_to_g2
from ..utils.device import resolve_device
from ..utils.enums import CheckForCorrectness, SubgroupCheckMode, UseCompression
from ..utils.errors import (
    BrokenInvariantError,
    InvalidLengthError,
    InvariantKind,
    NoContributionsError,
    UnconstrainedVariableError,
)
from ..utils.tracing import get_logger, info_span
from .keypair import Keypair, Phase2PublicKey, hash_cs_pub_keys
from .lagrange import Groth16Params
from .load_circuit import Matrices
from .polynomial import eval_qap, process_matrix
from .vecio import Cursor, deser_element, deser_vec, ser_element, ser_vec

logger = get_logger("snark_setup_tpu_torch.phase2")


# ---------------------------------------------------------------------------
# Groth16 key types (ark-groth16 layout)
# ---------------------------------------------------------------------------


@dataclass
class VerifyingKey:
    alpha_g1: AffinePoint
    beta_g2: AffinePoint
    gamma_g2: AffinePoint
    delta_g2: AffinePoint
    gamma_abc_g1: list[AffinePoint]

    def write(self, spec: CurveSpec, compression: UseCompression, device=None) -> bytes:
        return (
            ser_element(spec, "g1", self.alpha_g1, compression)
            + ser_element(spec, "g2", self.beta_g2, compression)
            + ser_element(spec, "g2", self.gamma_g2, compression)
            + ser_element(spec, "g2", self.delta_g2, compression)
            + ser_vec(spec, "g1", self.gamma_abc_g1, compression, device=device)
        )

    @classmethod
    def read(
        cls,
        spec: CurveSpec,
        cur: Cursor,
        compression: UseCompression,
        check: CheckForCorrectness,
        subgroup_mode: SubgroupCheckMode = SubgroupCheckMode.AUTO,
        device=None,
    ) -> "VerifyingKey":
        return cls(
            deser_element(spec, "g1", cur, compression, check),
            deser_element(spec, "g2", cur, compression, check),
            deser_element(spec, "g2", cur, compression, check),
            deser_element(spec, "g2", cur, compression, check),
            deser_vec(spec, "g1", cur, compression, check, subgroup_mode=subgroup_mode, device=device),
        )

    def __eq__(self, other):
        return (
            self.alpha_g1 == other.alpha_g1
            and self.beta_g2 == other.beta_g2
            and self.gamma_g2 == other.gamma_g2
            and self.delta_g2 == other.delta_g2
            and self.gamma_abc_g1 == other.gamma_abc_g1
        )


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: AffinePoint
    delta_g1: AffinePoint
    a_query: list[AffinePoint]
    b_g1_query: list[AffinePoint]
    b_g2_query: list[AffinePoint]
    h_query: list[AffinePoint]
    l_query: list[AffinePoint]

    def write(self, spec: CurveSpec, compression: UseCompression, device=None) -> bytes:
        return (
            self.vk.write(spec, compression, device)
            + ser_element(spec, "g1", self.beta_g1, compression)
            + ser_element(spec, "g1", self.delta_g1, compression)
            + ser_vec(spec, "g1", self.a_query, compression, device=device)
            + ser_vec(spec, "g1", self.b_g1_query, compression, device=device)
            + ser_vec(spec, "g2", self.b_g2_query, compression, device=device)
            + ser_vec(spec, "g1", self.h_query, compression, device=device)
            + ser_vec(spec, "g1", self.l_query, compression, device=device)
        )

    @classmethod
    def read(
        cls,
        spec: CurveSpec,
        cur: Cursor,
        compression: UseCompression,
        check: CheckForCorrectness,
        subgroup_mode: SubgroupCheckMode = SubgroupCheckMode.AUTO,
        device=None,
    ) -> "ProvingKey":
        """read_groth16_fast semantics (parameters.rs:518-584): a/b queries
        may contain infinity points for variables unused in A/B, so their
        Full check is downgraded to OnlyInGroup."""
        vk = VerifyingKey.read(spec, cur, compression, check, subgroup_mode, device)
        beta_g1 = deser_element(spec, "g1", cur, compression, check)
        delta_g1 = deser_element(spec, "g1", cur, compression, check)
        ab_check = (
            CheckForCorrectness.ONLY_IN_GROUP
            if check is CheckForCorrectness.FULL
            else check
        )

        def vec(group, chk):
            return deser_vec(spec, group, cur, compression, chk, subgroup_mode=subgroup_mode, device=device)

        a_query = vec("g1", ab_check)
        b_g1_query = vec("g1", ab_check)
        b_g2_query = vec("g2", ab_check)
        h_query = vec("g1", check)
        l_query = vec("g1", check)
        return cls(vk, beta_g1, delta_g1, a_query, b_g1_query, b_g2_query, h_query, l_query)

    def __eq__(self, other):
        return (
            self.vk == other.vk
            and self.beta_g1 == other.beta_g1
            and self.delta_g1 == other.delta_g1
            and self.a_query == other.a_query
            and self.b_g1_query == other.b_g1_query
            and self.b_g2_query == other.b_g2_query
            and self.h_query == other.h_query
            and self.l_query == other.l_query
        )


def hash_params(spec: CurveSpec, pk: ProvingKey, device=None) -> bytes:
    """Blake2b-512 of the compressed ProvingKey (parameters.rs:677-685)."""
    return hashlib.blake2b(pk.write(spec, UseCompression.YES, device), digest_size=64).digest()


def contains_contribution(contributions: list[bytes], my_contribution: bytes) -> bool:
    """parameters.rs:590-598 — check a contribution hash appears in a
    verify() result list."""
    return any(bytes(c) == bytes(my_contribution) for c in contributions)


def _copy_vk(vk: VerifyingKey) -> VerifyingKey:
    """Fresh VerifyingKey: contribute mutates delta_g2 in place, so chunk
    ProvingKeys must never share one (the Rust reference clones by value)."""
    return VerifyingKey(
        vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2, list(vk.gamma_abc_g1)
    )


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def batch_mul_device(ops: CurveOps, pts: list[AffinePoint], scalar: int, device=None) -> list[AffinePoint]:
    """All points times one scalar — the contribute hot loop (batch_mul,
    setup-utils/src/helpers.rs:117-140): the GLV scalar-mul (K3 + K4 on the
    card) in slices of at most MAX_LANES points. Points must lie in the
    prime-order subgroup (the GLV contract: [k mod r]P); infinity stays
    infinity."""
    if not pts:
        return []
    dev = resolve_device(device)
    raw = ints_to_limbs_batch([scalar], ops.fr.L).T  # (Ls, 1)
    scalars = ops.fr.tensor(np.broadcast_to(raw, (ops.fr.L, len(pts))), dev)
    return ops.to_affine_host(lanewise(ops.scalar_mul, ops.from_affine_host(pts, dev), scalars))


def merge_pairs_device(
    ops: CurveOps, v1: list[AffinePoint], v2: list[AffinePoint], rng=None, device=None
) -> tuple[AffinePoint, AffinePoint]:
    """(sum t_i v1_i, sum t_i v2_i) with shared random t_i — two device MSMs
    through the public-scalar path (Pippenger buckets on K2 above the
    threshold; merge_pairs, setup-utils/src/helpers.rs:371-384). The t_i are
    drawn from `rng` as the reference draws them (reproducible verification;
    reference wart: thread_rng)."""
    assert len(v1) == len(v2) and v1
    dev = resolve_device(device)
    return merge_point_pairs(ops, ops.from_affine_host(v1, dev), ops.from_affine_host(v2, dev), rng)


def merge_point_pairs(ops: CurveOps, p1: PointVec, p2: PointVec, rng=None) -> tuple[AffinePoint, AffinePoint]:
    """merge_pairs_device over two device batches of one width (the
    streaming verify's decoded batches): the same scalars from `rng`, the
    same sums."""
    from ..ops.msm import RLC_BITS, msm_public, rlc_scalars

    raw = rlc_scalars(int(p1["x"].shape[-1]), RLC_BITS, rng)
    s_pt = msm_public(ops, p1, raw, RLC_BITS)
    sx_pt = msm_public(ops, p2, raw, RLC_BITS)
    return ops.to_affine_host(s_pt)[0], ops.to_affine_host(sx_pt)[0]


# ---------------------------------------------------------------------------
# invariant helpers (parameters.rs:601-624)
# ---------------------------------------------------------------------------


def ensure_same_length(a, b) -> None:
    if len(a) != len(b):
        raise InvalidLengthError(len(a), len(b))


def ensure_unchanged(before, after, kind: InvariantKind) -> None:
    if before != after:
        raise BrokenInvariantError(kind)


def ensure_unchanged_vec(before, after, kind: InvariantKind) -> None:
    if len(before) != len(after):
        raise InvalidLengthError(len(before), len(after))
    for b, a in zip(before, after):
        ensure_unchanged(b, a, kind)


def verify_transcript(
    spec: CurveSpec, cs_hash: bytes, contributions: list[Phase2PublicKey]
) -> list[bytes]:
    """Signature-of-knowledge chain over all contributions
    (parameters.rs:626-655)."""
    eng = pairing_engine(spec.name)
    g2c = g2_curve(spec)
    result = []
    old_delta = g1_curve(spec).generator
    for i, pub_key in enumerate(contributions):
        h = hash_cs_pub_keys(spec, cs_hash, contributions[:i], pub_key.s, pub_key.s_delta)
        ensure_unchanged(pub_key.transcript, h, InvariantKind.TRANSCRIPT)
        r_pt = hash_to_g2(spec, h)
        eng.check_same_ratio(
            (pub_key.s, pub_key.s_delta),
            (r_pt, pub_key.r_delta),
            "Incorrect signature of knowledge",
        )
        eng.check_same_ratio(
            (old_delta, pub_key.delta_after),
            (r_pt, pub_key.r_delta),
            "Inconsistent G1 Delta",
        )
        old_delta = pub_key.delta_after
        result.append(pub_key.hash(spec))
    return result


# ---------------------------------------------------------------------------
# MPCParameters
# ---------------------------------------------------------------------------


@dataclass
class MPCParameters:
    spec: CurveSpec
    params: ProvingKey
    cs_hash: bytes
    contributions: list[Phase2PublicKey] = field(default_factory=list)

    def __eq__(self, other):
        return (
            self.params == other.params
            and self.cs_hash == other.cs_hash
            and self.contributions == other.contributions
        )

    def clone(self) -> "MPCParameters":
        import copy

        return MPCParameters(
            self.spec,
            ProvingKey(
                VerifyingKey(
                    self.params.vk.alpha_g1,
                    self.params.vk.beta_g2,
                    self.params.vk.gamma_g2,
                    self.params.vk.delta_g2,
                    list(self.params.vk.gamma_abc_g1),
                ),
                self.params.beta_g1,
                self.params.delta_g1,
                list(self.params.a_query),
                list(self.params.b_g1_query),
                list(self.params.b_g2_query),
                list(self.params.h_query),
                list(self.params.l_query),
            ),
            self.cs_hash,
            copy.copy(self.contributions),
        )

    # ------------------------------------------------------------------
    # construction (parameters.rs:71-270)
    # ------------------------------------------------------------------
    @classmethod
    def _build(cls, matrices: Matrices, params: Groth16Params, device=None):
        spec = matrices.spec
        num_vars = matrices.num_instance_variables + matrices.num_witness_variables
        at = process_matrix(matrices.a, num_vars)
        bt = process_matrix(matrices.b, num_vars)
        ct = process_matrix(matrices.c, num_vars)
        a_g1, b_g1, b_g2, gamma_abc_g1, l = eval_qap(
            spec.name,
            params.coeffs_g1,
            params.coeffs_g2,
            params.alpha_coeffs_g1,
            params.beta_coeffs_g1,
            at,
            bt,
            ct,
            matrices.num_instance_variables,
            device,
        )
        for e in l:
            if e.is_infinity:
                raise UnconstrainedVariableError("witness variable with zero L row")
        vk = VerifyingKey(
            alpha_g1=params.alpha_g1,
            beta_g2=params.beta_g2,
            # gamma = delta = 1: BGM17 pg. 14 (parameters.rs:141-144)
            gamma_g2=g2_curve(spec).generator,
            delta_g2=g2_curve(spec).generator,
            gamma_abc_g1=gamma_abc_g1,
        )
        pk = ProvingKey(
            vk=vk,
            beta_g1=params.beta_g1,
            delta_g1=g1_curve(spec).generator,
            a_query=a_g1,
            b_g1_query=b_g1,
            b_g2_query=b_g2,
            h_query=params.h_g1,
            l_query=l,
        )
        return spec, pk

    @classmethod
    def new(cls, matrices: Matrices, params: Groth16Params, device=None) -> "MPCParameters":
        with info_span("phase2-new", logger):
            spec, pk = cls._build(matrices, params, device)
            return cls(spec, pk, hash_params(spec, pk, device), [])

    @classmethod
    def new_chunked(
        cls, matrices: Matrices, params: Groth16Params, chunk_size: int, device=None
    ) -> tuple["MPCParameters", ProvingKey, list["MPCParameters"]]:
        """(full MPC, query-only ProvingKey, h/l-sliced chunk MPCs)
        (parameters.rs:166-270)."""
        with info_span("phase2-new-chunked", logger):
            spec, pk = cls._build(matrices, params, device)
            cs_hash = hash_params(spec, pk, device)
            full = cls(spec, pk, cs_hash, [])
            query = ProvingKey(
                vk=_copy_vk(pk.vk),
                beta_g1=pk.beta_g1,
                delta_g1=pk.delta_g1,
                a_query=list(pk.a_query),
                b_g1_query=list(pk.b_g1_query),
                b_g2_query=list(pk.b_g2_query),
                h_query=[],
                l_query=[],
            )
            chunks = []
            max_query = max(len(pk.h_query), len(pk.l_query))
            num_chunks = (max_query + chunk_size - 1) // chunk_size
            for i in range(num_chunks):
                lo, hi = i * chunk_size, (i + 1) * chunk_size
                chunks.append(
                    cls(
                        spec,
                        ProvingKey(
                            vk=_copy_vk(pk.vk),
                            beta_g1=pk.beta_g1,
                            delta_g1=pk.delta_g1,
                            a_query=[],
                            b_g1_query=[],
                            b_g2_query=[],
                            h_query=pk.h_query[lo:hi],
                            l_query=pk.l_query[lo:hi],
                        ),
                        cs_hash,
                        [],
                    )
                )
            return full, query, chunks

    @classmethod
    def new_from_buffer(
        cls,
        matrices: Matrices,
        transcript,
        compressed: UseCompression,
        check: CheckForCorrectness,
        domain_size: int,
        device=None,
    ) -> "MPCParameters":
        params = Groth16Params.read(
            matrices.spec.name, transcript, compressed, check, domain_size, device=device
        )
        return cls.new(matrices, params, device)

    @classmethod
    def new_from_buffer_chunked(
        cls,
        matrices: Matrices,
        transcript,
        compressed: UseCompression,
        check: CheckForCorrectness,
        domain_size: int,
        chunk_size: int,
        device=None,
    ):
        params = Groth16Params.read(
            matrices.spec.name, transcript, compressed, check, domain_size, device=device
        )
        return cls.new_chunked(matrices, params, chunk_size, device)

    # ------------------------------------------------------------------
    # contribute (parameters.rs:286-307)
    # ------------------------------------------------------------------
    def contribute(self, rng, device=None) -> bytes:
        with info_span("phase2-contribute", logger):
            spec = self.spec
            kp = Keypair.new(spec, rng, self.params.delta_g1, self.cs_hash, self.contributions)
            delta = kp.private_key.delta
            delta_inv = pow(delta, -1, spec.r)
            g1 = curve_ops(spec.name, "g1")
            self.params.l_query = batch_mul_device(g1, self.params.l_query, delta_inv, device)
            self.params.h_query = batch_mul_device(g1, self.params.h_query, delta_inv, device)
            self.params.vk.delta_g2 = g2_curve(spec).mul(self.params.vk.delta_g2, delta)
            self.params.delta_g1 = g1_curve(spec).mul(self.params.delta_g1, delta)
            self.contributions.append(kp.public_key)
            return kp.public_key.hash(spec)

    # ------------------------------------------------------------------
    # verify (parameters.rs:314-411)
    # ------------------------------------------------------------------
    def verify(self, after: "MPCParameters", rlc_rng=None, device=None) -> list[bytes]:
        with info_span("phase2-verify", logger):
            before = self
            spec = self.spec
            eng = pairing_engine(spec.name)
            if not after.contributions:
                raise NoContributionsError("There were no contributions found")
            pub_key = after.contributions[-1]
            ensure_unchanged(pub_key.delta_after, after.params.delta_g1, InvariantKind.DELTA_G1)
            eng.check_same_ratio(
                (g1_curve(spec).generator, pub_key.delta_after),
                (g2_curve(spec).generator, after.params.vk.delta_g2),
                "Inconsistent G2 Delta",
            )
            ensure_unchanged(
                before.contributions,
                after.contributions[: len(before.contributions)],
                InvariantKind.CONTRIBUTIONS,
            )
            ensure_unchanged(before.cs_hash, after.cs_hash, InvariantKind.CS_HASH)
            ensure_same_length(before.params.h_query, after.params.h_query)
            ensure_same_length(before.params.l_query, after.params.l_query)
            ensure_unchanged(
                before.params.vk.alpha_g1, after.params.vk.alpha_g1, InvariantKind.ALPHA_G1
            )
            ensure_unchanged(before.params.beta_g1, after.params.beta_g1, InvariantKind.BETA_G1)
            ensure_unchanged(before.params.vk.beta_g2, after.params.vk.beta_g2, InvariantKind.BETA_G2)
            ensure_unchanged(
                before.params.vk.gamma_g2, after.params.vk.gamma_g2, InvariantKind.GAMMA_G2
            )
            ensure_unchanged_vec(
                before.params.vk.gamma_abc_g1,
                after.params.vk.gamma_abc_g1,
                InvariantKind.GAMMA_ABC_G1,
            )
            ensure_unchanged_vec(
                before.params.a_query, after.params.a_query, InvariantKind.A_QUERY
            )
            ensure_unchanged_vec(
                before.params.b_g1_query, after.params.b_g1_query, InvariantKind.B_G1_QUERY
            )
            ensure_unchanged_vec(
                before.params.b_g2_query, after.params.b_g2_query, InvariantKind.B_G2_QUERY
            )
            g1 = curve_ops(spec.name, "g1")
            # H and L queries move by delta^-1: ratio vs (delta_after, delta_before)
            if before.params.h_query:
                eng.check_same_ratio(
                    merge_pairs_device(g1, before.params.h_query, after.params.h_query, rlc_rng, device),
                    (after.params.vk.delta_g2, before.params.vk.delta_g2),
                    "H_query ratio check failed",
                )
            if before.params.l_query:
                eng.check_same_ratio(
                    merge_pairs_device(g1, before.params.l_query, after.params.l_query, rlc_rng, device),
                    (after.params.vk.delta_g2, before.params.vk.delta_g2),
                    "L_query ratio check failed",
                )
            return verify_transcript(spec, before.cs_hash, after.contributions)

    # ------------------------------------------------------------------
    # combine (parameters.rs:413-434)
    # ------------------------------------------------------------------
    @staticmethod
    def combine(spec: CurveSpec, queries: ProvingKey, mpcs: list["MPCParameters"]) -> "MPCParameters":
        first = mpcs[0]
        combined = MPCParameters(
            spec,
            ProvingKey(
                vk=_copy_vk(first.params.vk),
                beta_g1=first.params.beta_g1,
                delta_g1=first.params.delta_g1,
                a_query=list(queries.a_query),
                b_g1_query=list(queries.b_g1_query),
                b_g2_query=list(queries.b_g2_query),
                h_query=[],
                l_query=[],
            ),
            first.cs_hash,
            list(first.contributions),
        )
        for mpc in mpcs:
            combined.params.h_query.extend(mpc.params.h_query)
            combined.params.l_query.extend(mpc.params.l_query)
        return combined

    # ------------------------------------------------------------------
    # (de)serialization (parameters.rs:438-516)
    # ------------------------------------------------------------------
    def write(self, compression: UseCompression, device=None) -> bytes:
        return (
            self.params.write(self.spec, compression, device)
            + self.cs_hash
            + Phase2PublicKey.write_batch(self.spec, self.contributions)
        )

    @classmethod
    def read(
        cls,
        spec: CurveSpec,
        data,
        compression: UseCompression,
        check_correctness: CheckForCorrectness = CheckForCorrectness.NO,
        subgroup_check_mode: SubgroupCheckMode = SubgroupCheckMode.AUTO,
        device=None,
    ) -> "MPCParameters":
        """read_fast semantics (parameters.rs:489-516)."""
        cur = Cursor(data)
        pk = ProvingKey.read(spec, cur, compression, check_correctness, subgroup_check_mode, device)
        cs_hash = cur.take(64)
        contributions, _ = Phase2PublicKey.read_batch(spec, cur.data, cur.pos)
        return cls(spec, pk, cs_hash, contributions)

    read_fast = read
