"""The decompression square root over Fq in one launch: CUDA kernel wrapper
and its plain PyTorch version.

`FqSqrt.__call__(a)` takes canonical Fq elements in Montgomery form,
(L, *batch) int32 16-bit limb planes, and returns `(root, ok)`: the root
(L, *batch) and a (*batch,) bool mask, true where `a` is a square or 0.
They are those of ops/codec.py: ExtSqrt.sqrt on a degree-1 field — for
q = 3 mod 4 (2-adicity e = 1) the root a^((q + 1) / 4), else the
branch-free Tonelli-Shanks with q - 1 = 2^e s and c = z^s for the field's
non-residue z — bit for bit: every product of both versions is canonical.

A CUDA tensor launches ``csrc/fq_sqrt.cu`` (the whole chain, one team of
threads a lane) or raises; a CPU tensor runs `fq_sqrt_plain`, the chain on
the plain Montgomery product (`stacked_mul_plain` at S = G = 1). The
exponent's bits, e and c reach the kernel by value (`sqrt_params`).

Replaces the one-product launches of the stacked-product kernel that the
square root's chains made (reference: ops/pallas_field.py:498 through
ops/codec_jax.py: ExtSqrt.sqrt).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_group import team_consts
from .cuda_mul import stacked_mul_plain
from .fp import FpOps, fp_ops


def sqrt_schedule(q: int, z: int) -> tuple[int, int, int]:
    """(e, exponent, c) of the square root in F_q with non-residue z:
    q - 1 = 2^e s with s odd; the exponent is (q + 1) / 4 where e == 1,
    else (s - 1) / 2; c = z^s in standard form (unused where e == 1)."""
    s, e = q - 1, 0
    while s % 2 == 0:
        s //= 2
        e += 1
    exponent = (q + 1) // 4 if e == 1 else (s - 1) // 2
    if exponent <= 0:
        raise ValueError("the square root's exponent must be positive")
    return e, exponent, pow(z, s, q)


def sqrt_params(fq: FpOps, z: int) -> np.ndarray:
    """The words the kernel's SqrtParams are packed from (uint32): the
    exponent's bit length, e, the exponent (NL words), c in Montgomery form
    (NL words), then csrc/field_team.cuh's TeamConsts (`team_consts`)."""
    NL, q = fq.L // 2, fq.modulus
    e, exponent, c = sqrt_schedule(q, z)
    c_mont = c * fq.spec.mont_r % q

    def words(v: int) -> list[int]:
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(NL)]

    head = [exponent.bit_length(), e] + words(exponent) + words(c_mont)
    return np.concatenate([np.array(head, np.uint32), team_consts(fq)])


def fq_sqrt_plain(fq: FpOps, z: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ExtSqrt.sqrt's chain on the plain Montgomery
    product. a: (L, *batch) int32 -> (root (L, *batch), ok (*batch,))."""
    e, exponent, c = sqrt_schedule(fq.modulus, z)
    shape = a.shape
    a = a.reshape(fq.L, -1)

    def mul(x, y):
        return stacked_mul_plain(fq, x[:, None], y[:, None], ((1,),))[:, 0]

    acc = a
    for bit in bin(exponent)[3:]:
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, a)
    if e == 1:
        r = acc
    else:
        r = mul(a, acc)
        t = mul(r, acc)
        cm = fq.const_of(("sqrt_c", fq.modulus, z), fq.from_int([c]), a).expand_as(a)
        one = fq.ones(a.shape[1:], a.device)
        for i in range(e, 1, -1):
            b = t
            for _ in range(i - 2):
                b = mul(b, b)
            flip = ~fq.eq(b, one)
            r = fq.select(flip, mul(r, cm), r)
            cm = mul(cm, cm)
            t = fq.select(flip, mul(t, cm), t)
    ok = fq.eq(mul(r, r), a) | fq.is_zero(a)
    return r.reshape(shape), ok.reshape(shape[1:])


class FqSqrt:
    """The square-root kernel's wrapper for one modulus and non-residue:
    its by-value parameter words, the launch count `launches`, `plain_calls`
    where the plain version runs instead, and `events`, when set to a list,
    a (start, end) CUDA event pair per launch."""

    def __init__(self, fq: FpOps, z: int):
        if 2 * fq.modulus >= fq.spec.mont_r_pow:
            raise ValueError("modulus too close to R for the team layer")
        self.fq, self.z = fq, z
        self.L, self.NL = fq.L, fq.L // 2
        self.e, self.exponent, _ = sqrt_schedule(fq.modulus, z)
        self._params = sqrt_params(fq, z)
        self._fn = None
        self.team: int | None = None
        self.launches = 0
        self.plain_calls = 0
        self.events: list | None = None

    def products(self) -> int:
        """Montgomery products one lane's chain takes (the kernel's and the
        plain version's): the exponent's squarings and products, the
        Tonelli-Shanks loop's, and the final check's square."""
        n = self.exponent.bit_length() - 1 + bin(self.exponent).count("1") - 1
        if self.e > 1:
            n += 2 + sum(i - 2 + 3 for i in range(self.e, 1, -1))
        return n + 1

    def __call__(self, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if a.dtype != torch.int32 or a.ndim < 1 or a.shape[0] != self.L:
            raise ValueError(f"square-root operand must be int32 ({self.L}, *batch), "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device.type == "cpu":
            self.plain_calls += 1
            return fq_sqrt_plain(self.fq, self.z, a)
        if a.device.type != "cuda":
            raise ValueError(f"unsupported device {a.device}")
        return self._launch(a)

    def _launch_fn(self):
        if self._fn is None:
            from .build import TARGETS, load

            target = f"fq_sqrt_nl{self.NL}"
            if target not in TARGETS:
                raise NotImplementedError(f"no square-root kernel is instantiated for {self.L} limbs")
            lib = load(target)
            if lib.fq_sqrt_nl() != self.NL:
                raise RuntimeError(f"{target} was built for another limb count")
            self.team = lib.fq_sqrt_team()
            fn = lib.fq_sqrt_launch
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launch(self, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dev = a.device
        shape = a.shape
        a = a.reshape(self.L, -1).contiguous()
        B = a.shape[1]
        root = torch.empty_like(a)
        ok = torch.empty(B, dtype=torch.int32, device=dev)
        if B:
            fn = self._launch_fn()
            stream = torch.cuda.current_stream(dev)
            with torch.cuda.device(dev):
                if self.events is not None:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                err = fn(a.data_ptr(), root.data_ptr(), ok.data_ptr(), B, self._params.ctypes.data,
                         stream.cuda_stream)
            if err != 0:
                raise RuntimeError(f"fq_sqrt kernel launch failed: CUDA error {err}")
            self.launches += 1
            if self.events is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                self.events.append((start, end))
        return root.reshape(shape), ok.bool().reshape(shape[1:])


@functools.lru_cache(maxsize=None)
def fq_sqrt_for(modulus: int, z: int) -> FqSqrt:
    """The one square-root wrapper (and launch count) of a modulus and
    non-residue."""
    return FqSqrt(fp_ops(modulus), z)
