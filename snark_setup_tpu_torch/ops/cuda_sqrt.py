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

The same library's second entry point raises elements to a public exponent
passed by value (`FqPow`, `pow_params`; plain version `fq_pow_plain`):
`fq_inv_for(q)` is a^(q - 2), the Fermat inversion that ops/fp.py:
FpOps.inv launches on a CUDA tensor for the root of every batch
inversion.
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


def pow_params(fq: FpOps, exponent: int) -> np.ndarray:
    """The words the power kernel's PowParams are packed from (uint32): the
    exponent's bit length, the exponent (NL words), then TeamConsts."""
    NL = fq.L // 2
    if not 0 < exponent < 1 << (32 * NL):
        raise ValueError("the exponent must be positive and fit the limbs")
    head = [exponent.bit_length()] + [(exponent >> (32 * i)) & 0xFFFFFFFF for i in range(NL)]
    return np.concatenate([np.array(head, np.uint32), team_consts(fq)])


def _pow_chain(mul, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent by `mul`, the kernels' schedule: most significant bit
    first, a squaring per bit and a product by `a` per set bit."""
    acc = a
    for bit in bin(exponent)[3:]:
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


def _plain_mul(fq: FpOps):
    return lambda x, y: stacked_mul_plain(fq, x[:, None], y[:, None], ((1,),))[:, 0]


def fq_pow_plain(fq: FpOps, exponent: int, a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the power kernel: the chain on the plain
    Montgomery product. a: (L, *batch) int32, Montgomery form, canonical."""
    shape = a.shape
    return _pow_chain(_plain_mul(fq), a.reshape(fq.L, -1), exponent).reshape(shape)


def fq_sqrt_plain(fq: FpOps, z: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ExtSqrt.sqrt's chain on the plain Montgomery
    product. a: (L, *batch) int32 -> (root (L, *batch), ok (*batch,))."""
    e, exponent, c = sqrt_schedule(fq.modulus, z)
    shape = a.shape
    a = a.reshape(fq.L, -1)

    mul = _plain_mul(fq)
    acc = _pow_chain(mul, a, exponent)
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


class _ChainKernel:
    """A wrapper of one entry point of the library csrc/fq_sqrt.cu builds
    per limb count (`ENTRY`, taking `ARGS` device pointers, B, the HOST
    pointer to the by-value parameter words and the stream): the launch
    count `launches`, `plain_calls` where the plain version runs instead,
    and `events`, when set to a list, a (start, end) CUDA event pair per
    launch. A CUDA tensor launches the kernel or raises; a CPU tensor runs
    `plain`."""

    ENTRY = ""
    ARGS = 0

    def __init__(self, fq: FpOps, params: np.ndarray):
        if 2 * fq.modulus >= fq.spec.mont_r_pow:
            raise ValueError("modulus too close to R for the team layer")
        self.fq = fq
        self.L, self.NL = fq.L, fq.L // 2
        self._params = params
        self._fn = None
        self.team: int | None = None
        self.launches = 0
        self.plain_calls = 0
        self.events: list | None = None

    def __call__(self, a: torch.Tensor):
        if a.dtype != torch.int32 or a.ndim < 1 or a.shape[0] != self.L:
            raise ValueError(f"{self.ENTRY} operand must be int32 ({self.L}, *batch), "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device.type == "cpu":
            self.plain_calls += 1
            return self.plain(a)
        if a.device.type != "cuda":
            raise ValueError(f"unsupported device {a.device}")
        return self._launch(a)

    def _launch_fn(self):
        if self._fn is None:
            from .build import TARGETS, load

            target = f"fq_sqrt_nl{self.NL}"
            if target not in TARGETS:
                raise NotImplementedError(f"no {self.ENTRY} kernel is instantiated for {self.L} limbs")
            lib = load(target)
            if lib.fq_sqrt_nl() != self.NL:
                raise RuntimeError(f"{target} was built for another limb count")
            self.team = lib.fq_sqrt_team()
            fn = getattr(lib, f"{self.ENTRY}_launch")
            fn.argtypes = [ctypes.c_void_p] * self.ARGS + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _run(self, B: int, *ptrs: int) -> None:
        """One launch over B lanes on the current stream."""
        dev = torch.device("cuda", torch.cuda.current_device())
        fn = self._launch_fn()
        stream = torch.cuda.current_stream(dev)
        if self.events is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        err = fn(*ptrs, B, self._params.ctypes.data, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.ENTRY} kernel launch failed: CUDA error {err}")
        self.launches += 1
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self.events.append((start, end))


class FqSqrt(_ChainKernel):
    """The square-root kernel's wrapper for one modulus and non-residue."""

    ENTRY, ARGS = "fq_sqrt", 3

    def __init__(self, fq: FpOps, z: int):
        super().__init__(fq, sqrt_params(fq, z))
        self.z = z
        self.e, self.exponent, _ = sqrt_schedule(fq.modulus, z)

    def products(self) -> int:
        """Montgomery products one lane's chain takes (the kernel's and the
        plain version's): the exponent's squarings and products, the
        Tonelli-Shanks loop's, and the final check's square."""
        n = self.exponent.bit_length() - 1 + bin(self.exponent).count("1") - 1
        if self.e > 1:
            n += 2 + sum(i - 2 + 3 for i in range(self.e, 1, -1))
        return n + 1

    def plain(self, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return fq_sqrt_plain(self.fq, self.z, a)

    def _launch(self, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        shape = a.shape
        a = a.reshape(self.L, -1).contiguous()
        B = a.shape[1]
        root = torch.empty_like(a)
        ok = torch.empty(B, dtype=torch.int32, device=a.device)
        if B:
            with torch.cuda.device(a.device):
                self._run(B, a.data_ptr(), root.data_ptr(), ok.data_ptr())
        return root.reshape(shape), ok.bool().reshape(shape[1:])


@functools.lru_cache(maxsize=None)
def fq_sqrt_for(modulus: int, z: int) -> FqSqrt:
    """The one square-root wrapper (and launch count) of a modulus and
    non-residue."""
    return FqSqrt(fp_ops(modulus), z)


class FqPow(_ChainKernel):
    """The power kernel's wrapper (the second entry point of
    csrc/fq_sqrt.cu) for one modulus and public exponent."""

    ENTRY, ARGS = "fq_pow", 2

    def __init__(self, fq: FpOps, exponent: int):
        super().__init__(fq, pow_params(fq, exponent))
        self.exponent = exponent

    def products(self) -> int:
        """Montgomery products one lane's chain takes."""
        return self.exponent.bit_length() - 1 + bin(self.exponent).count("1") - 1

    def plain(self, a: torch.Tensor) -> torch.Tensor:
        return fq_pow_plain(self.fq, self.exponent, a)

    def _launch(self, a: torch.Tensor) -> torch.Tensor:
        shape = a.shape
        a = a.reshape(self.L, -1).contiguous()
        out = torch.empty_like(a)
        if a.shape[1]:
            with torch.cuda.device(a.device):
                self._run(a.shape[1], a.data_ptr(), out.data_ptr())
        return out.reshape(shape)


@functools.lru_cache(maxsize=None)
def fq_inv_for(modulus: int) -> FqPow:
    """The one inversion wrapper (and launch count) of a modulus: a^(q - 2),
    Montgomery form in and out, 0 for 0."""
    return FqPow(fp_ops(modulus), modulus - 2)
