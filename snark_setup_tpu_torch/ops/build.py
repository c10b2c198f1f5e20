"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` exposes a plain C interface and is compiled
with ``nvcc`` for ``sm_90a`` into a shared library, then loaded with
``ctypes`` — seconds per source, against minutes for a source that includes
PyTorch's headers. Libraries are built at first use, from the sources in this
checkout only, into ``build/snark_setup_tpu_torch/`` beside the package,
under a name keyed on a hash of
every file in ``csrc/`` and the flags: an edited source never loads a stale
library. A failed build or load raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# library name -> (source file, extra defines). The ladder, the group
# operations, the stacked products (K5 and the opt-in routes' K6, K7,
# K8) and the square root are instantiated once per limb count
# (NL 32-bit limbs = L/2: 12 for BLS12-377/381's Fq, 24 for BW6-761's and
# the MNT curves'): separate libraries build in parallel and keep each
# compilation unit small. The digits kernel is instantiated once per curve
# with a GLV endomorphism, its shapes compile-time (ops/cuda_glv.py:
# digits_geometry; both groups of a curve share them, and the wrapper checks
# them against the library's).
TARGETS = {
    "glv_digits_bls12_377": ("glv_digits.cu", ["-DDIG_LS=16", "-DDIG_LC=9", "-DDIG_LT=20", "-DDIG_LH=10",
                                               "-DDIG_NWIN=33", "-DDIG_MU=18", "-DDIG_CO=8"]),
    "glv_digits_bls12_381": ("glv_digits.cu", ["-DDIG_LS=16", "-DDIG_LC=10", "-DDIG_LT=21", "-DDIG_LH=10",
                                               "-DDIG_NWIN=33", "-DDIG_MU=19", "-DDIG_CO=8"]),
    "glv_digits_bw6": ("glv_digits.cu", ["-DDIG_LS=24", "-DDIG_LC=13", "-DDIG_LT=28", "-DDIG_LH=13",
                                        "-DDIG_NWIN=48", "-DDIG_MU=26", "-DDIG_CO=12"]),
    "glv_ladder_nl12": ("glv_ladder.cu", ["-DNL=12"]),
    "glv_ladder_nl24": ("glv_ladder.cu", ["-DNL=24"]),
    "group_ops_nl12": ("group_ops.cu", ["-DNL=12"]),
    "group_ops_nl24": ("group_ops.cu", ["-DNL=24"]),
    "stacked_mul_nl12": ("stacked_mul.cu", ["-DNL=12"]),
    "stacked_mul_nl24": ("stacked_mul.cu", ["-DNL=24"]),
    "stacked_cols_nl12": ("stacked_cols.cu", ["-DNL=12"]),
    "stacked_cols_nl24": ("stacked_cols.cu", ["-DNL=24"]),
    "stacked_mul_v3_nl12": ("stacked_mul_v3.cu", ["-DNL=12"]),
    "stacked_mul_v3_nl24": ("stacked_mul_v3.cu", ["-DNL=24"]),
    "stacked_mul_v2_nl12": ("stacked_mul_v2.cu", ["-DNL=12"]),
    "stacked_mul_v2_nl24": ("stacked_mul_v2.cu", ["-DNL=24"]),
    "fq_sqrt_nl12": ("fq_sqrt.cu", ["-DNL=12"]),
    "fq_sqrt_nl24": ("fq_sqrt.cu", ["-DNL=24"]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}
"""nvcc's output per target built by this process (`-Xptxas -v` figures)."""


def build_dir() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.join(repo, "build", "snark_setup_tpu_torch")
    os.makedirs(root, exist_ok=True)
    return root


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the CUDA kernels")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _lib_path(target: str) -> str:
    _, defines = TARGETS[target]
    tag = hashlib.sha256((_sources_hash() + " ".join(defines)).encode()).hexdigest()[:12]
    return os.path.join(build_dir(), f"lib{target}_{tag}.so")


def _start_build(target: str, nvcc: str):
    src, defines = TARGETS[target]
    out = _lib_path(target)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, *defines, "-I", CSRC, "-o", tmp, os.path.join(CSRC, src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp, out


def build(targets=None) -> dict[str, str]:
    """Build every missing library of `targets` (default: all), one nvcc
    process per target, all started together. Returns {target: path}."""
    targets = list(TARGETS) if targets is None else list(targets)
    with _lock:
        missing = [t for t in targets if not os.path.exists(_lib_path(t))]
        if missing:
            nvcc = find_nvcc()
            jobs = {t: _start_build(t, nvcc) for t in missing}
            failures = []
            for t, (proc, cmd, tmp, out) in jobs.items():
                log, _ = proc.communicate()
                build_logs[t] = log
                if proc.returncode != 0:
                    failures.append(f"{' '.join(cmd)}\n{log}")
                    if os.path.exists(tmp):
                        os.remove(tmp)
                else:
                    os.replace(tmp, out)
            if failures:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return {t: _lib_path(t) for t in targets}


def load(target: str) -> ctypes.CDLL:
    """The loaded library for `target`, building it first if needed."""
    lib = _loaded.get(target)
    if lib is None:
        path = build()[target]  # all targets at once: the nvcc runs overlap
        lib = ctypes.CDLL(path)
        _loaded[target] = lib
    return lib
