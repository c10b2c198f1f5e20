"""The pipelined loops and the inversion kernel on the card.

These tests need an NVIDIA GPU and nvcc: they are marked `gpu`, decide inside
the test whether a card is present, and skip without one. Run them on the
machine with the card:

    PYTHONPATH=. python -m pytest --noconftest tests/test_torch_pipeline_gpu.py -m gpu -q

- The inversion kernel (csrc/fq_sqrt.cu: fq_pow_launch at q - 2, the root
  of every batch inversion) against its plain version, widths 1 to 4097,
  0 among the inputs, on all five base fields; `FpOps.inv` on a CUDA
  tensor is one launch of it.
- A pipelined contribution and verification on the card write the bytes of
  the same calls at depth 1.
- No host wait on the start halves: the loops run under
  `torch.cuda.set_sync_debug_mode("error")`, which raises at any call that
  makes the host wait for the card (a read-back, a blocking copy), with
  the reads (`read_batch`: its checks raise where the reference raises)
  and the pipelines' finishes (the host halves) let through.
- The two-fault rejections raise the class they raise on the CPU.
"""

import contextlib
import random

import numpy as np
import pytest
import torch

from snark_setup_tpu_torch.ops.codec import BatchPointCodec, batch_codec
from snark_setup_tpu_torch.ops.cuda_sqrt import fq_inv_for, fq_pow_plain
from snark_setup_tpu_torch.phase1 import protocol
from snark_setup_tpu_torch.phase1.buffers import split
from snark_setup_tpu_torch.phase1.keys import PublicKey
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
from snark_setup_tpu_torch.phase1.protocol import Phase1
from snark_setup_tpu_torch.phase1.testing import generate_output, setup_verify, two_fault_response
from snark_setup_tpu_torch.phase2 import chunked
from snark_setup_tpu_torch.utils import pipeline
from snark_setup_tpu_torch.utils.enums import (
    CheckForCorrectness, ProvingSystem, SubgroupCheckMode, UseCompression,
)

CURVES = ["bls12_377", "bls12_381", "bw6_761", "mnt4_753", "mnt6_753"]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def inversion_inputs(fq, B: int, rng, dev) -> torch.Tensor:
    """(L, B) Montgomery planes: 0, 1, q - 1 in lanes 0-2 (as far as B
    goes), random elements elsewhere."""
    q = fq.modulus
    vals = [int.from_bytes(rng.bytes(q.bit_length() // 8 + 8), "little") % q for _ in range(B)]
    vals[: min(B, 3)] = [0, 1, q - 1][: min(B, 3)]
    return fq.tensor(fq.from_int(vals), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 33, 4097])
@pytest.mark.parametrize("curve", CURVES)
def test_inversion_kernel_equals_plain_version_on_the_card(curve, B):
    dev = _card()
    fq = batch_codec(curve, "g1", dev).fp
    q = fq.modulus
    a = inversion_inputs(fq, B, np.random.default_rng(B), dev)
    K = fq_inv_for(q)
    n = K.launches
    with torch.no_grad():
        got = fq.inv(a)  # FpOps.inv on a CUDA tensor: one launch
        torch.cuda.synchronize()
        assert K.launches == n + 1
        assert torch.equal(got, fq_pow_plain(fq, q - 2, a))
    vals = fq.to_int(a[:, : min(B, 8)])
    inv = fq.to_int(got[:, : min(B, 8)])
    assert all((v * w - 1) % q == 0 if v else w == 0 for v, w in zip(vals, inv))


@pytest.mark.gpu
def test_pipelined_contribution_and_verification_write_the_depth_1_bytes_on_the_card(monkeypatch):
    dev = _card()
    params = Phase1Parameters.new_full("bw6_761", ProvingSystem.GROTH16, 6, 16)
    runs = []
    for depths in ((protocol.PIPELINE_DEPTH, protocol.VERIFY_PIPELINE_DEPTH), (1, 1)):
        monkeypatch.setattr(protocol, "PIPELINE_DEPTH", depths[0])
        monkeypatch.setattr(protocol, "VERIFY_PIPELINE_DEPTH", depths[1])
        with pipeline.recording() as rec:
            inp, out, pub, _, digest = setup_verify(UseCompression.NO, CheckForCorrectness.NO, UseCompression.YES,
                                                    params, device=dev)
            new = generate_output(params, UseCompression.NO)
            Phase1.verification(inp, out, new, pub, digest, UseCompression.NO, UseCompression.YES,
                                UseCompression.NO, CheckForCorrectness.NO, CheckForCorrectness.FULL,
                                SubgroupCheckMode.AUTO, True, params, rlc_rng=random.Random(3), device=dev)
        assert [(r["name"], r["depth"], r["high_water"]) for r in rec] == [
            ("computation", depths[0], depths[0]), ("verification", depths[1], depths[1])]
        runs.append((bytes(out), bytes(new)))
    assert runs[0] == runs[1]


@contextlib.contextmanager
def no_host_wait():
    """Raise at any call that makes the host wait for the card, except
    inside `read_batch` and the pipelines' finishes."""
    def allowed(fn):
        def call(*args, **kwargs):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return call

    mp = pytest.MonkeyPatch()
    mp.setattr(BatchPointCodec, "read_batch", allowed(BatchPointCodec.read_batch))
    mp.setattr(pipeline.Pipeline, "flush", allowed(pipeline.Pipeline.flush))
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        mp.undo()


def run_loops(dev, curve: str, power: int, batch: int) -> dict:
    """The four pipelined loops once on `curve`: contribute (through
    `setup_verify`), verification, aggregate_verification and the streaming
    phase 2's `_batched_mul_inplace` over the response's tau_g1. Returns
    the pipelines' stats."""
    params = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, power, batch)
    with pipeline.recording() as rec:
        inp, out, pub, _, digest = setup_verify(UseCompression.NO, CheckForCorrectness.NO, UseCompression.YES,
                                                params, device=dev)
        new = generate_output(params, UseCompression.NO)
        Phase1.verification(inp, out, new, pub, digest, UseCompression.NO, UseCompression.YES, UseCompression.NO,
                            CheckForCorrectness.NO, CheckForCorrectness.FULL, SubgroupCheckMode.AUTO, True, params,
                            rlc_rng=random.Random(3), device=dev)
        Phase1.aggregate_verification(new, UseCompression.NO, CheckForCorrectness.FULL, params,
                                      rlc_rng=random.Random(4), device=dev)
        sec = split(params, UseCompression.YES)["tau_g1"]
        span = chunked._VecSpan(offset=sec.offset, count=sec.num_elements, el_size=sec.element_size)
        buf = bytearray(out)
        chunked._batched_mul_inplace(params.spec, buf, span, 5, batch, UseCompression.YES,
                                     CheckForCorrectness.ONLY_IN_GROUP, dev)
    torch.cuda.synchronize()
    return {r["name"]: r for r in rec}


@pytest.mark.gpu
@pytest.mark.parametrize("curve,power,batch", [("bw6_761", 13, 8192), ("bls12_377", 10, 1024)])
def test_start_halves_make_no_host_wait_on_the_card(curve, power, batch):
    """BW6-761 at batch 8192: the batched subgroup check (n > 4096) and the
    Pippenger MSMs, both groups on Fq; BLS12-377 at 1024: the Direct check,
    G2 over Fp2 on the stacked-product kernel. A warm-up run first: the
    kernels' first calls build and load them and copy constants."""
    dev = _card()
    with torch.no_grad():
        run_loops(dev, curve, power, batch)
        with no_host_wait():
            stats = run_loops(dev, curve, power, batch)
    assert {k: (v["depth"], v["completed"]) for k, v in stats.items() if k != "recode_section"} == {
        "computation": (4, True), "verification": (3, True), "aggregate_verification": (3, True),
        "mul_query": (4, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["verification", "aggregate_verification"])
def test_two_fault_rejection_on_the_card_raises_the_cpu_class(kind):
    dev = _card()
    t = two_fault_response(kind)
    params = Phase1Parameters.new_full("bls12_377", ProvingSystem.GROTH16, 2, 4)
    raised = []
    for where in (dev, "cpu"):
        with pytest.raises(Exception) as e:
            if kind == "verification":
                Phase1.verification(t["input"], t["output"], generate_output(params, UseCompression.NO),
                                    PublicKey.deserialize(params.spec, t["key"]), t["digest"],
                                    UseCompression.NO, UseCompression.YES, UseCompression.NO,
                                    CheckForCorrectness.NO, CheckForCorrectness.FULL, SubgroupCheckMode.AUTO,
                                    True, params, rlc_rng=random.Random(7), device=where)
            else:
                Phase1.aggregate_verification(t["output"], UseCompression.NO, CheckForCorrectness.FULL, params,
                                              rlc_rng=random.Random(7), device=where)
        raised.append(type(e.value).__name__)
    assert raised == ["PointAtInfinityError"] * 2
