"""QAP evaluation against phase-1 Lagrange coefficients, on the device.

Reference: phase2/src/polynomial.rs (eval, dot products over sparse rows)
and process_matrix (phase2/src/parameters.rs:96-104). All sparse rows of a
matrix are evaluated in one pass over the device: gather the referenced
coefficient points per non-zero (`index_select`), one batched GLV scalar-mul
by the matrix coefficients (K3 + K4 on the card for Fq coordinates), then an
inclusive Hillis–Steele segmented scan with the group law — ⌈log2 nnz⌉
full-width adds (K2) and selects — that reduces each variable's row without
data-dependent control flow.
"""

from __future__ import annotations

import torch

from ..curves.host import INFINITY, AffinePoint
from ..fields.limb import ints_to_limbs_batch
from ..ops.curve import CurveOps, PointVec, curve_ops
from ..ops.lanes import lanewise
from ..utils.device import resolve_device


def process_matrix(
    rows: list[list[tuple[int, int]]], num_vars: int
) -> list[list[tuple[int, int]]]:
    """Constraint-major -> variable-major transpose
    (parameters.rs:96-104): out[var] = [(coeff, constraint_idx), ...]."""
    out: list[list[tuple[int, int]]] = [[] for _ in range(num_vars)]
    for constraint_num, entries in enumerate(rows):
        for coeff, var_index in entries:
            out[var_index].append((coeff, constraint_num))
    return out


def _flatten_rows(rows: list[list[tuple[int, int]]]):
    """-> (coeffs, idx, seg_starts_flags, seg_end_positions, row_of_segment)."""
    coeffs, idx, flags, ends, rows_present = [], [], [], [], []
    for row_i, entries in enumerate(rows):
        if not entries:
            continue
        for k, (c, j) in enumerate(entries):
            coeffs.append(c)
            idx.append(j)
            flags.append(k == 0)
        ends.append(len(coeffs) - 1)
        rows_present.append(row_i)
    return coeffs, idx, flags, ends, rows_present


def segmented_rowsum(ops: CurveOps, points: PointVec, gidx, scalars, flags, ends) -> PointVec:
    """Row sums of sum_k scalars[k] * points[gidx[k]] over the segments that
    `flags` starts, read at `ends`: an inclusive segmented scan, Hillis–Steele
    doubling — at step d each position combines with the position d to its
    left unless a segment boundary was already absorbed. Identity =
    (infinity, flag False). All index and flag tensors on the points'
    device."""
    gathered = PointVec({k: v.index_select(-1, gidx) for k, v in points.items()})
    vals = lanewise(ops.scalar_mul, gathered, scalars)
    n = int(gidx.shape[0])
    inf = ops.infinity((n,), gidx.device)
    d = 1
    while d < n:
        shifted = PointVec({k: torch.cat([inf[k][..., :d], vals[k][..., :-d]], dim=-1) for k in vals})
        shifted_flags = torch.cat([torch.zeros(d, dtype=torch.bool, device=flags.device), flags[:-d]])
        vals = ops.select(flags, vals, lanewise(ops.add, shifted, vals))
        flags = flags | shifted_flags
        d <<= 1
    return PointVec({k: v.index_select(-1, ends) for k, v in vals.items()})


def _row_sums(ops: CurveOps, pts: PointVec, rows: list[list[tuple[int, int]]]):
    """(row sums on the device, the rows they belong to), or None when the
    matrix has no non-zero."""
    coeffs, idx, flags, ends, rows_present = _flatten_rows(rows)
    if not coeffs:
        return None
    dev = pts["x"].device
    as_index = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    scalars = ops.fr.tensor(ints_to_limbs_batch(coeffs, ops.fr.L).T, dev)
    sums = segmented_rowsum(ops, pts, as_index(idx), scalars, torch.tensor(flags, device=dev), as_index(ends))
    return sums, rows_present


def _scatter_rows(ops: CurveOps, sums, n_rows: int) -> list[AffinePoint]:
    out: list[AffinePoint] = [INFINITY] * n_rows
    if sums is not None:
        for row_i, p in zip(sums[1], ops.to_affine_host(sums[0])):
            out[row_i] = p
    return out


def dot_product_vec(
    ops: CurveOps, coeff_points: list[AffinePoint], rows: list[list[tuple[int, int]]], device=None
) -> list[AffinePoint]:
    """Per-row sparse dot products row_i = sum_k coeff * points[idx]
    (polynomial.rs:71-94), one device pass for the whole matrix."""
    if not any(rows):
        return [INFINITY] * len(rows)
    pts = ops.from_affine_host(coeff_points, resolve_device(device))
    return _scatter_rows(ops, _row_sums(ops, pts, rows), len(rows))


def eval_qap(
    curve_name: str,
    coeffs_g1: list[AffinePoint],
    coeffs_g2: list[AffinePoint],
    alpha_coeffs_g1: list[AffinePoint],
    beta_coeffs_g1: list[AffinePoint],
    at: list[list[tuple[int, int]]],
    bt: list[list[tuple[int, int]]],
    ct: list[list[tuple[int, int]]],
    num_inputs: int,
    device=None,
):
    """Returns (a_g1, b_g1, b_g2, gamma_abc_g1, l) — polynomial.rs:11-47.

    ext = At·beta_coeffs + Bt·alpha_coeffs + Ct·coeffs, split at num_inputs
    into gamma_abc_g1 (instance) and l (witness). Each coefficient vector
    goes to the device once; the three partials of ext are added there."""
    dev = resolve_device(device)
    g1, g2 = curve_ops(curve_name, "g1"), curve_ops(curve_name, "g2")
    n_rows = len(at)
    tau1 = g1.from_affine_host(coeffs_g1, dev)
    a_g1 = _scatter_rows(g1, _row_sums(g1, tau1, at), n_rows)
    b_g1 = _scatter_rows(g1, _row_sums(g1, tau1, bt), n_rows)
    b_g2 = dot_product_vec(g2, coeffs_g2, bt, dev)

    ext = g1.infinity((n_rows,), dev)
    for pts, rows in ((g1.from_affine_host(beta_coeffs_g1, dev), at),
                      (g1.from_affine_host(alpha_coeffs_g1, dev), bt), (tau1, ct)):
        part = _row_sums(g1, pts, rows)
        if part is not None:
            full = g1.infinity((n_rows,), dev)
            at_rows = torch.tensor(part[1], dtype=torch.int64, device=dev)
            for k in full:
                full[k][..., at_rows] = part[0][k]
            ext = lanewise(g1.add, ext, full)
    ext = g1.to_affine_host(ext)
    return a_g1, b_g1, b_g2, ext[:num_inputs], ext[num_inputs:]
