from .chacha import ChaChaRng
from .hashing import (
    blank_hash,
    calculate_hash,
    compute_g2_s,
    derive_rng_from_seed,
    get_rng,
    hash_to_g2,
    reduced_hash,
    beacon_randomness_sha256_work,
)
from .arkrand import ArkRng

__all__ = [
    "ChaChaRng",
    "ArkRng",
    "blank_hash",
    "calculate_hash",
    "compute_g2_s",
    "derive_rng_from_seed",
    "get_rng",
    "hash_to_g2",
    "reduced_hash",
    "beacon_randomness_sha256_work",
]
