"""Serializable constraint matrices (circuit files on disk).

Reference: phase2/src/load_circuit.rs — an ark-CanonicalSerialize derive over
(num_instance, num_witness, num_constraints, a_nnz, b_nnz, c_nnz, a, b, c).
ark 0.4 encodes usize as u64 LE; Matrix<Fr> = Vec<Vec<(Fr, usize)>> with u64
LE length prefixes; Fr as plain LE field bytes (same compressed or not).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

from ..curves.constants import CurveSpec, get_curve
from ..utils.errors import SerializationError
from .r1cs import ConstraintSystem
from .vecio import Cursor

Matrix = list[list[tuple[int, int]]]


@dataclass
class Matrices:
    spec: CurveSpec
    num_instance_variables: int
    num_witness_variables: int
    num_constraints: int
    a_num_non_zero: int
    b_num_non_zero: int
    c_num_non_zero: int
    a: Matrix
    b: Matrix
    c: Matrix

    @classmethod
    def from_constraint_system(cls, spec_or_name, cs: ConstraintSystem) -> "Matrices":
        spec = spec_or_name if isinstance(spec_or_name, CurveSpec) else get_curve(spec_or_name)
        a, b, c = cs.to_matrices()
        return cls(
            spec,
            cs.num_instance_variables,
            cs.num_witness_variables,
            cs.num_constraints,
            sum(len(r) for r in a),
            sum(len(r) for r in b),
            sum(len(r) for r in c),
            a,
            b,
            c,
        )

    # -- ark CanonicalSerialize --------------------------------------------
    @property
    def _fr_bytes(self) -> int:
        return (self.spec.r.bit_length() + 7) // 8

    def write(self) -> bytes:
        out = io.BytesIO()
        for v in (
            self.num_instance_variables,
            self.num_witness_variables,
            self.num_constraints,
            self.a_num_non_zero,
            self.b_num_non_zero,
            self.c_num_non_zero,
        ):
            out.write(v.to_bytes(8, "little"))
        nb = self._fr_bytes
        for m in (self.a, self.b, self.c):
            out.write(len(m).to_bytes(8, "little"))
            for row in m:
                out.write(len(row).to_bytes(8, "little"))
                for coeff, index in row:
                    out.write(int(coeff).to_bytes(nb, "little"))
                    out.write(int(index).to_bytes(8, "little"))
        return out.getvalue()

    @classmethod
    def read(cls, spec_or_name, data) -> "Matrices":
        spec = spec_or_name if isinstance(spec_or_name, CurveSpec) else get_curve(spec_or_name)
        cur = Cursor(data)
        header = [cur.u64() for _ in range(6)]
        nb = (spec.r.bit_length() + 7) // 8
        mats = []
        for _ in range(3):
            nrows = cur.u64()
            rows = []
            for _ in range(nrows):
                nent = cur.u64()
                row = []
                for _ in range(nent):
                    coeff = int.from_bytes(cur.take(nb), "little")
                    if coeff >= spec.r:
                        raise SerializationError("matrix coefficient out of range")
                    row.append((coeff, cur.u64()))
                rows.append(row)
            mats.append(rows)
        return cls(spec, *header, *mats)
