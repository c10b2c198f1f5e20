"""Device ops: multi-limb Montgomery field arithmetic, curve group law,
GLV scalar multiplication and the batched point codec — the hot loops of the
ceremony, as plain PyTorch on limb planes plus the CUDA kernels.

    fp.py          — vectorised limb arithmetic (plain PyTorch)
    ext.py         — Fq / Fp2 / Fp3 field-ops protocol the curve code is written against
    hostmath.py    — host-side extension-field power for constant set-up
    glv.py         — GLV parameter derivation and decomposition
    curve.py       — complete projective group law and batch scalar-mul
    codec.py       — batched point (de)serialisation
    cuda_mul.py    — stacked Montgomery-product kernel wrapper + its plain version
    cuda_routes.py — the stacked product's opt-in routes (K6-K8) + the route dispatcher
    toeplitz.py    — the routes' host constants (Toeplitz REDC matrices, f32 bounds) and switches
    cuda_glv.py    — GLV digits kernel wrapper + its plain version
    cuda_ladder.py — whole-ladder kernel wrapper + its plain version
    build.py       — nvcc build + ctypes load of csrc/*.cu
    convert.py     — limb planes between numpy (reference layout) and torch
"""

from .fp import FpOps
from .curve import CurveOps

__all__ = ["FpOps", "CurveOps"]
