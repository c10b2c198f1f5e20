"""snark_setup_tpu_torch — the PyTorch/CUDA port of the trusted-setup
(powers-of-tau / Groth16 MPC) engine, for an NVIDIA Hopper card.

The package mirrors the layout of the JAX package beside it, module for
module, and shares no code with it: host-exact modules (fields, curves,
serialisation, transcript, parameters, keys) are copies pinned by equality
tests, the device arithmetic is plain PyTorch on 16-bit limb planes, and the
two hot kernels (GLV digit extraction, whole GLV ladder) are hand-written
CUDA C++ under ``ops/csrc``.

Layer map:
  fields/ curves/           — host math core (Python ints)
  serialize/ transcript/    — wire encodings, hash chain, deterministic rng
  phase1/                   — parameters, keys, buffer layout, protocol
  ops/                      — limb-plane field/curve/codec ops and kernels
  shard/                    — single-device runtime of the batch scalar-mul
  cli/                      — the ``phase1`` command line
  utils/                    — enums, errors, logging, device selection

Every entry point takes ``device=`` and defaults to ``cuda``; without a card
it raises unless ``device="cpu"`` is passed explicitly.
"""

__version__ = "0.1.0"
