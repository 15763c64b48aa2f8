"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface under ``_build/``, then
loaded with ``ctypes``.  No source includes PyTorch's headers, so a
build takes seconds.  Libraries are named by a digest of their source
and flags, so an edited source is never served from a stale build.

Each C entry point takes ``void*`` pointers, ``int`` sizes and the CUDA
stream, and returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code.  A missing ``nvcc`` or a failed build raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/spill report) per kernel source built by
# this process, for the smoke run to print.
build_logs: dict[str, str] = {}


def kernel_sources() -> list[str]:
    """Names of every kernel source under ``csrc/`` (without ``.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "port's CUDA kernels cannot be built"
    )


def _compile(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    build_logs[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def build_all() -> None:
    """Compile every kernel source at once, one nvcc process per source."""
    names = kernel_sources()
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        paths = list(ex.map(_compile, names))
    with _lock:
        for name, path in zip(names, paths):
            if name not in _libs:
                _libs[name] = ctypes.CDLL(path)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_compile(name))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
