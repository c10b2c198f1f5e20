from .host import Fp, Fp2, Fp3, FieldSpec, tonelli_shanks_sqrt
from .limb import LimbSpec, int_to_limbs, limbs_to_int

__all__ = [
    "Fp",
    "Fp2",
    "Fp3",
    "FieldSpec",
    "tonelli_shanks_sqrt",
    "LimbSpec",
    "int_to_limbs",
    "limbs_to_int",
]
