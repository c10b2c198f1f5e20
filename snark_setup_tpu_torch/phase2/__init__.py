"""Phase 2 — Groth16 specialization MPC over the delta trapdoor.

Mirrors the reference `phase2` crate (phase2/src/*): MPCParameters over an
ark-groth16-layout ProvingKey, a per-contribution signature-of-knowledge
transcript, QAP evaluation against phase-1 Lagrange coefficients, and the
chunked split of the h / l queries. The compute hot paths — Lagrange IFFT,
QAP sparse dot products, delta^-1 batch multiplication, RLC ratio-check
MSMs, the query vectors' (de)serialization — run on the chosen device
(default: the card).

Exports resolve lazily (PEP 562) so the host-only participant module
(keypair) imports without the device modules.
"""

_EXPORTS = {
    "Keypair": "keypair",
    "Phase2PublicKey": "keypair",
    "hash_cs_pub_keys": "keypair",
    "Groth16Params": "lagrange",
    "Matrices": "load_circuit",
    "MPCParameters": "parameters",
    "ProvingKey": "parameters",
    "VerifyingKey": "parameters",
    "verify_transcript": "parameters",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(name)
