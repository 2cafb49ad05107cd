"""Build and load the hand-written CUDA kernels (csrc/*.cu) at first use.

``nvcc`` compiles every source under csrc/ into an object of its own, all
sources at once in parallel, and links them into one shared library with a
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nextgen_uia_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {"gelu": 1, "quick_gelu": 2}

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes; every entry returns cudaGetLastError() as an int
SIGNATURES = {
    # a, w, dtype, bias, res, res_dtype, out, out_dtype, act, M, N, K, stream
    "nx_gemm": [P, P, I, P, P, I, P, I, I, I, I, I, P],
    # x, ga, ba, wqkv_t, bqkv, wo_t, bo, gb, bb, w1_t, b1, w2_t, b2, key_bias, qkv, cat, y32,
    # s32, z2, h, out, dtype, B, N, H, dh, hidden, act, causal, postnorm, scale, eps, stream
    "nx_block_fwd": [P] * 21 + [I] * 9 + [F, F, P],
    # s, freq, kernels, bias, out, dtype, B, H, W, C, stream
    "nx_mona_spatial": [P, P, P, P, P, I, I, I, I, I, P],
    # x, kernels, out, dtype, B, H, W, C, stream
    "nx_dwconv7": [P, P, P, I, I, I, I, I, P],
    # x, kernels, g, dx, dk, dtype, B, H, W, C, stream
    "nx_dwconv7_bwd": [P, P, P, P, P, I, I, I, I, I, P],
    # s, freq, kernels, g, ds, dk, dfreq_part, dbias, dtype, B, H, W, C, stream
    "nx_mona_spatial_bwd": [P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    # x, gamma, beta, w_qkv, b_qkv, z, q, k, v, dtype, B, N, H, dh, eps, stream
    "nx_ln_qkv_fwd": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
    # x, w_qkv_t ([3D, D]), b_qkv, q, k, v, dtype, B, N, H, dh, stream
    "nx_qkv_rawx_fwd": [P, P, P, P, P, P, I, I, I, I, I, P],
    # w_qkv, dq, dk, dv, dx, dtype, B, N, H, dh, stream
    "nx_qkv_rawx_bwd": [P, P, P, P, P, I, I, I, I, I, P],
    # x, gamma, w_qkv, dq, dk, dv, dz, dx, dtype, B, N, H, dh, eps, stream
    "nx_ln_qkv_bwd": [P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
    # q, k, v, x, key_bias, wo_t, bo, cat, out, dtype, B, N, H, dh, sb, sh, sn, csb, csh, csn,
    # scale, stream
    "nx_attn_o_fwd": [P] * 9 + [I] * 11 + [F, P],
    # q, k, v, x, key_bias, wo_t, bo, gamma, beta, cat, y32, out, dtype, B, N, H, dh, sb, sh,
    # sn, scale, eps, stream
    "nx_attn_o_postln_fwd": [P] * 12 + [I] * 8 + [F, F, P],
    # q, k, v, key_bias, wo, g, o, doh, lse, delta, dq, dk, dv, dtype, B, N, H, dh, sb, sh, sn,
    # scale, stream
    "nx_attn_o_bwd": [P] * 13 + [I] * 8 + [F, P],
    # x, gamma, beta, w1_t, b1, w2_t, b2, z, h, out, dtype, M, D, hidden, act, eps, stream
    "nx_ln_mlp_fwd": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
    # x, gamma, beta, w1_t, b1, w1, w2, g, z, a, dpre, dz, dx, dtype, M, D, hidden, act,
    # eps, stream
    "nx_ln_mlp_bwd": [P] * 13 + [I] * 5 + [F, P],
    # q, k, v, o, bias, lse, dtype, B, H, N, dh, sb, sh, sn, osb, osh, osn, causal, scale,
    # stream
    "nx_flash_attention": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, F, P],
    # q, k, v, o, g, lse, bias, dq, dk, dv, dbias, delta, dtype, B, H, N, dh, sb, sh, sn,
    # osb, osh, osn, causal, scale, stream
    "nx_flash_attention_bwd": [P] * 12 + [I] * 12 + [F, P],
    # x, w1_t, b1, w2_t, b2, gamma, beta, h, y32, out, dtype, M, D, hidden, act, eps, stream
    "nx_postnorm_mlp_ln_fwd": [P] * 10 + [I] * 5 + [F, P],
    # x, w1_t, b1, w2_t, b2, h, out, dtype, M, D, hidden, act, stream
    "nx_mlp_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, P],
    # x, w1_t, b1, w1, w2, g, a, dpre, dx, dtype, M, D, hidden, act, stream
    "nx_mlp_bwd": [P] * 9 + [I] * 5 + [P],
    # x, mask, prm, uw, uw_t, wd_t, out, stats, zd, zcat, gd, y2, img, z1, dtype, B, N, D, h,
    # w, has_noise, strips, stream
    "nx_mona_fused_fwd": [P] * 14 + [I] * 8 + [P],
    # x, mask, prm, uw, wd, g, stats, zd, zcat, gd, y2, img, z1, dx, dgd, dzd, dzd_t, dz1,
    # part_img, part_row, part_up, part_down, grads, dtype, B, N, D, h, w, has_freq,
    # has_noise, strips, splits, rows_per, stream
    "nx_mona_fused_bwd": [P] * 23 + [I] * 11 + [P],
    # x, wqkv_t, bqkv, wo_t, bo, key_bias, qkv, cat, out, dtype, B, N, H, dh, causal, scale,
    # stream
    "nx_fused_attn_fwd": [P] * 9 + [I] * 6 + [F, P],
    # x, wqkv_t, bqkv, wqkv, wo, key_bias, g, qkv, od, lse, delta, dqkv, dx, dtype, B, N, H, dh,
    # causal, scale, stream
    "nx_fused_attn_bwd": [P] * 13 + [I] * 6 + [F, P],
    # img, lut, out, B, HW, stream
    "nx_lut_apply": [P, P, P, I, I, P],
    # img, hist, B, HW, stream
    "nx_hist256": [P, P, I, I, P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ["-shared"]).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnextgen_uia_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu unless the hashed library exists: one ``nvcc -c``
    per source, all started together, then one link. Returns (path, seconds
    spent compiling and linking, 0.0 when it was already built). The
    compiler's output, register and shared-memory use included, goes to
    build.log."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = nvcc_path(), f"{out.stem}.{os.getpid()}"
    sources = [s for s in _sources() if s.suffix == ".cu"]
    objects = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
    t0 = time.perf_counter()
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                        for s, o in zip(sources, objects))]
    log, failed = [], []
    for cmd, proc in jobs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objects)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for o in objects:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(f[-4000:] for f in failed))
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


def ptr(t: torch.Tensor | None, what: str = "operand") -> int | None:
    """A contiguous tensor's address for a C entry (16-byte aligned, as the
    kernels' vector loads need); None passes through as a null pointer."""
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} is not 16-byte aligned")
    return t.data_ptr()


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream
