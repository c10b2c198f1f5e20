"""Portable (dependency-light) phase-2 contributor.

TPU-native twin of the reference's wasm/browser contributor
(phase2/src/lib.rs:15-66): a participant-side `contribute` that needs NO
JAX and NO accelerator — only the pure-Python host field/curve stack (plus
numpy for the ChaCha bulk path) — so it runs anywhere CPython does (a
laptop, a container, Pyodide in a browser). The coordinator-side machinery
(verification, aggregation) stays on the TPU stack; contributions produced
here are byte-compatible with it.
"""

from .contributor import contribute_challenge

__all__ = ["contribute_challenge"]
