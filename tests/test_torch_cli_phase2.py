"""The port's phase-2 CLIs on `--device cpu` against the JAX package's:
`circuit_main create` -> `prepare_phase2_main` (power 4, phase2-size 8) ->
`phase2_main new` (2 chunks) -> `contribute` (one participant, every chunk,
the same seed file) -> `verify` -> `combine` -> `circuit_main test`, in the
flow of scripts/phase2_chunked.sh. Every file the chain writes is
byte-identical to the one the JAX package's CLI chain wrote from the same
phase-1 transcript and seeds (tests/torch_phase2_reference.py; tolerance 0),
and the hash chain is intact."""

import hashlib

import pytest
import torch
import torch_phase2_reference as R

from snark_setup_tpu_torch.cli import circuit_main, phase2_main, prepare_phase2_main

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    return R.reference(tmp_path_factory)


def test_cli_chain_files_equal_reference(ref, tmp_path):
    rcs = R.cli_chain(circuit_main, prepare_phase2_main, phase2_main, str(tmp_path), ref["transcript"],
                      extra=("--device", "cpu"))
    assert rcs == ref["jax"]["cli_rcs"]
    assert set(rcs.values()) == {0}
    files = {p.name: p.read_bytes() for p in tmp_path.iterdir()}
    assert sorted(files) == sorted(ref["jax"]["cli_files"])
    assert {n for n, b in files.items() if b != ref["jax"]["cli_files"][n]} == set()
    blake = lambda name: hashlib.blake2b(files[name], digest_size=64).digest()
    assert files["challenge.verified.hash"] == blake("challenge.full")
    for i in range(2):
        for name in (f"challenge.{i}", f"response_{i}", f"verified_{i}"):
            for suffix in (".hash", ".verified.hash"):
                if name + suffix in files:
                    assert files[name + suffix] == blake(name), name + suffix
    assert files["combined.params"] and files["combined"]


def test_cli_device_defaults_to_the_card(tmp_path):
    assert phase2_main.build_parser().parse_args(["new"]).device == "cuda"
    assert prepare_phase2_main.build_parser().parse_args(
        ["--phase2-fname", "a", "--response-fname", "b", "--power", "2"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    # without a card a command that computes fails before it writes
    rc = prepare_phase2_main.main(["--phase2-fname", str(tmp_path / "out"), "--response-fname",
                                   str(tmp_path / "missing"), "--power", "2"])
    assert rc == 1 and not (tmp_path / "out").exists()
    assert phase2_main.main(["--curve-kind", "bw6", "--chunk-size", "4", "new", "--challenge-fname",
                             str(tmp_path / "c")]) == 1
    assert circuit_main.main(["test", "--proving-key-path", str(tmp_path / "missing")]) == 1
    assert not list(tmp_path.iterdir())
