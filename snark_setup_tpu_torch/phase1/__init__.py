from .parameters import Phase1Parameters
from .keys import PublicKey, PrivateKey, key_generation
from .protocol import Phase1

__all__ = ["Phase1Parameters", "PublicKey", "PrivateKey", "key_generation", "Phase1"]
