"""MNT4-753 and MNT6-753 (a != 0: every scalar multiplication on the
windowed ladder over the complete addition, K5 rounds; G2 over Fp2 / Fp3) on
the card, beyond the contributions `chip_smoke.py` runs:

- phase-1 verification: a power-10 contribution through the phase-1 CLI,
  then `verify-and-transform-pok-and-correctness` (its new challenge against
  the host codec's re-encoding at sampled indices and the hash chain) and
  `verify-and-transform-ratios` accept, and a response with two tau_g1
  powers swapped is rejected by the power-pairs ratio check
  (`chip_smoke.py: contribute_phase, verify_phase`);
- phase 2 at domain 8 (TestCircuit, x^2) through the phase-2 CLIs:
  prepare -> new (2 chunks) -> contribute -> verify -> combine -> circuit
  test (`tests/torch_phase2_reference.py: cli_chain`), every file equal
  byte for byte to the same chain on the CPU (the plain versions).

These tests need an NVIDIA GPU and nvcc: they are marked `gpu`, decide inside
the test whether a card is present, and skip without one. Run them on the
machine with the card:

    python -m pytest --noconftest tests/test_torch_mnt_gpu.py -q -m gpu -s
"""

import time

import pytest
import torch
import torch_phase2_reference as R

from snark_setup_tpu_torch.cli import circuit_main, phase2_main, prepare_phase2_main
from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for
from snark_setup_tpu_torch.ops.curve import curve_ops

CURVES = ["mnt4_753", "mnt6_753"]
VERIFY_POWER = 10


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _k5(curve):
    return stacked_mul_for(curve_ops(curve, "g1").fq.modulus)


@pytest.mark.gpu
@pytest.mark.parametrize("curve", CURVES)
def test_mnt_verification_on_the_card(curve, tmp_path):
    import chip_smoke as S

    dev = _card()
    k5 = _k5(curve)
    launches, plain = k5.launches, k5.plain_calls
    t0 = time.perf_counter()
    with torch.no_grad():
        S.contribute_phase(dev, curve, VERIFY_POWER, S.BATCH, {}, picks=2, workdir=str(tmp_path))
        S.verify_phase(dev, curve, VERIFY_POWER, S.BATCH, str(tmp_path), ("swap",), {})
    S.emit({"phase": "mnt verification test", "curve": curve, "power": VERIFY_POWER,
            "seconds": time.perf_counter() - t0, "k5_launches": k5.launches - launches})
    assert k5.launches > launches and k5.plain_calls == plain


@pytest.mark.gpu
@pytest.mark.parametrize("curve", CURVES)
def test_mnt_phase2_on_the_card_equals_the_cpu(curve, tmp_path):
    import chip_smoke as S

    dev = _card()
    transcript = R.phase1_transcript(curve)
    k5 = _k5(curve)
    files, seconds = {}, {}
    for where in (dev.type, "cpu"):
        work = tmp_path / where
        work.mkdir()
        launches = k5.launches
        t0 = time.perf_counter()
        rcs = R.cli_chain(circuit_main, prepare_phase2_main, phase2_main, str(work), transcript,
                          extra=("--device", where), curve=curve)
        seconds[where] = time.perf_counter() - t0
        assert set(rcs.values()) == {0}, rcs
        assert (k5.launches > launches) == (where != "cpu")
        files[where] = {p.name: p.read_bytes() for p in work.iterdir()}
    S.emit({"phase": "mnt phase2 test", "curve": curve, "seconds": seconds, "files": len(files["cpu"])})
    assert sorted(files[dev.type]) == sorted(files["cpu"])
    assert {n for n, b in files[dev.type].items() if b != files["cpu"][n]} == set()
    assert files["cpu"]["combined.params"] and files["cpu"]["combined"]
