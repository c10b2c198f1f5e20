"""Buffer layout & batch iteration — replica of phase1/src/helpers/buffers.rs.

The +1/+2 batch-overlap trick (buffers.rs:48-72) is load-bearing: consecutive
batches share boundary elements so the random-linear-combination power checks
cover cross-batch ratios. Reproduced exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.enums import ContributionMode, ProvingSystem, UseCompression
from ..utils.errors import InvalidChunkError
from .parameters import Phase1Parameters


def iter_chunk(parameters: Phase1Parameters) -> list[tuple[int, int]]:
    """Absolute-index [start, end) batches over the accumulator range,
    consecutive batches overlapping by 1-2 elements (buffers.rs:22-73)."""
    upper_bound = (
        parameters.powers_g1_length
        if parameters.proving_system is ProvingSystem.GROTH16
        else parameters.powers_length
    )
    if parameters.contribution_mode is ContributionMode.CHUNKED:
        lo = parameters.chunk_index * parameters.chunk_size
        hi = min((parameters.chunk_index + 1) * parameters.chunk_size, upper_bound)
    else:
        lo, hi = 0, upper_bound

    step = parameters.batch_size - 1
    if step <= 0:
        raise InvalidChunkError("batch size must be >= 2")
    out: list[tuple[int, int]] = []
    i = lo
    while i < hi:
        first = i
        last = min(i + step, hi) - 1  # inclusive
        if first == last:
            if first >= hi - 1:
                if hi == lo + 1:
                    out.append((first, first + 1))
                # else: skip; previous batch was extended over this element
            else:
                out.append((first, first + 2))
        else:
            end = last + 1 if last >= hi - 1 else last + 2
            out.append((first, end))
        i += step
    return out


@dataclass(frozen=True)
class Section:
    """Byte range of one accumulator section plus its element geometry."""

    offset: int
    num_elements: int
    element_size: int

    @property
    def end(self) -> int:
        return self.offset + self.num_elements * self.element_size

    def slice_of(self, buf, start_el: int = 0, end_el: int | None = None):
        end_el = self.num_elements if end_el is None else end_el
        mv = memoryview(buf)
        return mv[self.offset + start_el * self.element_size : self.offset + end_el * self.element_size]


def split(
    parameters: Phase1Parameters, compressed: UseCompression
) -> dict[str, Section]:
    """Section table for a (possibly chunked) accumulator buffer, mirroring
    buffers.rs split/split_mut (:246-341). Keys: tau_g1, tau_g2, alpha_g1,
    beta_g1, beta_g2."""
    c = parameters.curve
    comp = compressed is UseCompression.YES
    g1 = c.g1_compressed_size if comp else c.g1_size
    g2 = c.g2_compressed_size if comp else c.g2_size
    off = parameters.hash_size
    out: dict[str, Section] = {}
    if parameters.proving_system is ProvingSystem.GROTH16:
        out["tau_g1"] = Section(off, parameters.g1_chunk_size, g1)
        off = out["tau_g1"].end
        out["tau_g2"] = Section(off, parameters.other_chunk_size, g2)
        off = out["tau_g2"].end
        out["alpha_g1"] = Section(off, parameters.other_chunk_size, g1)
        off = out["alpha_g1"].end
        out["beta_g1"] = Section(off, parameters.other_chunk_size, g1)
        off = out["beta_g1"].end
        out["beta_g2"] = Section(off, 1, g2)
    else:
        n = parameters.total_size_in_log2
        g2_chunk = n + 2 if parameters.chunk_index == 0 else 0
        alpha_chunk = 3 + 3 * n if parameters.chunk_index == 0 else 0
        out["tau_g1"] = Section(off, parameters.g1_chunk_size, g1)
        off = out["tau_g1"].end
        out["tau_g2"] = Section(off, g2_chunk, g2)
        off = out["tau_g2"].end
        out["alpha_g1"] = Section(off, alpha_chunk, g1)
        off = out["alpha_g1"].end
        out["beta_g1"] = Section(off, 0, g1)
        out["beta_g2"] = Section(off, 0, g2)
    return out


def split_at_chunk(
    parameters: Phase1Parameters, compressed: UseCompression
) -> dict[str, Section]:
    """Section table addressing one chunk's range inside a FULL-size buffer
    (buffers.rs:103-241). parameters must be chunk parameters."""
    c = parameters.curve
    comp = compressed is UseCompression.YES
    g1 = c.g1_compressed_size if comp else c.g1_size
    g2 = c.g2_compressed_size if comp else c.g2_size
    start_el = parameters.chunk_index * parameters.chunk_size
    out: dict[str, Section] = {}
    if parameters.proving_system is ProvingSystem.GROTH16:
        base_tau_g1 = parameters.hash_size
        base_tau_g2 = base_tau_g1 + g1 * parameters.powers_g1_length
        base_alpha = base_tau_g2 + g2 * parameters.powers_length
        base_beta_g1 = base_alpha + g1 * parameters.powers_length
        base_beta_g2 = base_beta_g1 + g1 * parameters.powers_length
        out["tau_g1"] = Section(
            base_tau_g1 + start_el * g1, parameters.g1_chunk_size, g1
        )
        out["tau_g2"] = Section(
            base_tau_g2 + start_el * g2, parameters.other_chunk_size, g2
        )
        out["alpha_g1"] = Section(
            base_alpha + start_el * g1, parameters.other_chunk_size, g1
        )
        out["beta_g1"] = Section(
            base_beta_g1 + start_el * g1, parameters.other_chunk_size, g1
        )
        out["beta_g2"] = Section(base_beta_g2, 1, g2)
    else:
        n = parameters.total_size_in_log2
        g2_chunk = n + 2 if parameters.chunk_index == 0 else 0
        alpha_chunk = 3 + 3 * n if parameters.chunk_index == 0 else 0
        base_tau_g1 = parameters.hash_size
        base_tau_g2 = base_tau_g1 + g1 * parameters.powers_length
        base_alpha = base_tau_g2 + g2 * g2_chunk
        out["tau_g1"] = Section(
            base_tau_g1 + start_el * g1, parameters.g1_chunk_size, g1
        )
        out["tau_g2"] = Section(base_tau_g2, g2_chunk, g2)
        out["alpha_g1"] = Section(base_alpha, alpha_chunk, g1)
        out["beta_g1"] = Section(base_alpha, 0, g1)
        out["beta_g2"] = Section(base_alpha, 0, g2)
    return out
