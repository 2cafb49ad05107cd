"""Build and load the hand-written CUDA kernels (csrc/*.cu) at first use.

``nvcc`` compiles every source under csrc/ into one shared library with a
plain C interface, bound here with ctypes. The library goes to
``build/nextgen_uia_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and the compiler flags, so an edited source rebuilds
and an unchanged one loads the existing file. Nothing is built when a
module is imported: ``library()`` is called by the wrappers the first time
they launch a kernel on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nextgen_uia_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes; every entry returns cudaGetLastError() as an int
SIGNATURES = {
    # x, x_dtype, gamma, beta, out, out_dtype, rows, cols, eps, stream
    "nx_layernorm": [P, I, P, P, P, I, I, I, F, P],
    # a, w, dtype, bias, res, res_dtype, out, out_dtype, act, M, N, K, stream
    "nx_gemm": [P, P, I, P, P, I, P, I, I, I, I, I, P],
    # qkv, key_bias, out, dtype, B, N, H, dh, n_real, scale, stream
    "nx_attention": [P, P, P, I, I, I, I, I, I, F, P],
    # s, freq, kernels, bias, out, dtype, B, H, W, C, stream
    "nx_mona_spatial": [P, P, P, P, P, I, I, I, I, I, P],
}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnextgen_uia_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu unless the hashed library exists. Returns (path,
    seconds spent compiling, 0.0 when it was already built). The compiler's
    output, register and shared-memory use included, goes to build.log."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nx_error_string.argtypes = [ctypes.c_int]
    lib.nx_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = library().nx_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
