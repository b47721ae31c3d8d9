"""Build and bind the hand-written CUDA kernels (ops/csrc/*.cu).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface under ``sezkp_tpu_torch/_build/`` and loaded
with ``ctypes``. Nothing happens at import: the first kernel launch calls
:func:`lib`, which builds (one ``nvcc`` per source, started together, then a
link) and loads. The library's name carries a hash of the sources, so an
edited kernel is never served from a stale build.

Each C function launches on the stream it is given, allocates nothing, does
not synchronise, and returns the ``cudaError_t`` of its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "_build")
)
_SOURCES = (
    "blake3_compress.cu", "blake3_chain.cu", "ntt_phases.cu", "ntt_small.cu",
    "i8_gemm.cu", "gl_digits.cu", "digit_dft.cu",
)
_HEADERS = ("blake3_round.cuh", "goldilocks.cuh", "ntt_smem.cuh", "i8_mma.cuh")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None
# seconds spent in nvcc by this process (0.0 when the library was already built)
build_seconds = 0.0


def _find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of sezkp_tpu_torch are built from "
        "source at first use and need the CUDA toolkit"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this source revision has not been built yet;
    return the library path. Raises on any compiler failure."""
    global build_seconds
    import time

    path = os.path.join(_BUILD_DIR, f"libsezkp_kernels_{_source_hash()}.so")
    if os.path.exists(path):
        return path
    nvcc = _find_nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    t0 = time.time()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in _SOURCES:
        obj = os.path.join(_BUILD_DIR, f"{src}.{tag}.o")
        objs.append(obj)
        procs.append(
            subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-I", _CSRC, "-c",
                 os.path.join(_CSRC, src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    logs = []
    failed = False
    for src, p in zip(_SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"--- nvcc {src} (rc {p.returncode})\n{out.decode(errors='replace')}")
        failed |= p.returncode != 0
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(logs))
    tmp = path + f".{tag}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True
    )
    if link.returncode != 0:
        raise RuntimeError("CUDA kernel link failed\n" + link.stdout + link.stderr)
    os.replace(tmp, path)
    for o in objs:
        os.remove(o)
    build_seconds += time.time() - t0
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    L = ctypes.CDLL(build())
    vp, ll, i, ull = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong
    L.sezkp_blake3_compress.argtypes = [vp, vp, ll, i, i, i, vp]
    L.sezkp_blake3_chain.argtypes = [vp, vp, ll, i, i, vp]
    L.sezkp_ntt_phase_axis.argtypes = [vp, vp, i, ll, i, vp, vp, ll, ull, vp]
    L.sezkp_ntt_phase_batched.argtypes = [vp, vp, i, i, i, vp, vp, vp, vp]
    L.sezkp_ntt_phase_last.argtypes = [vp, vp, i, i, i, vp, ull, vp]
    L.sezkp_ntt_small_cols.argtypes = [vp, vp, i, i, vp, vp, vp]
    L.sezkp_ntt_small_rows.argtypes = [vp, vp, i, i, vp, ull, vp]
    L.sezkp_i8_gemm.argtypes = [vp, vp, vp, i, i, ll, i, i, i, vp]
    L.sezkp_gl_digits.argtypes = [vp, vp, ll, ll, ll, vp]
    L.sezkp_digit_dft.argtypes = [vp, vp, vp, vp, i, ll, i, vp]
    L.sezkp_digit_dft_last.argtypes = [vp, vp, vp, i, i, i, vp]
    for fn in (
        L.sezkp_blake3_compress, L.sezkp_blake3_chain, L.sezkp_ntt_phase_axis,
        L.sezkp_ntt_phase_batched, L.sezkp_ntt_phase_last,
        L.sezkp_ntt_small_cols, L.sezkp_ntt_small_rows,
        L.sezkp_i8_gemm, L.sezkp_gl_digits, L.sezkp_digit_dft, L.sezkp_digit_dft_last,
    ):
        fn.restype = ctypes.c_int
    _lib = L
    return L


def check(rc: int, what: str) -> None:
    """Raise if a launch was refused (the C functions return cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {rc}")


def resolve_device(device):
    """None -> the CUDA card (raises without one); anything else as given."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sezkp_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
