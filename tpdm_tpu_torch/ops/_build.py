"""Build and bind the hand-written CUDA kernels under ``tpdm_tpu_torch/csrc``.

The sources are compiled by ``nvcc`` into one shared library with a plain C
interface and loaded through ``ctypes`` (no PyTorch headers, so a build takes
seconds). The library goes to ``build/tpdm_tpu_torch/`` at the repository
root, named by a hash of the sources and flags, on first use: a checkout
builds everything it runs, and a changed source never loads a stale library.

Nothing here runs at import time, and nothing falls back: without ``nvcc``
the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpdm_tpu_torch"
SOURCES = ("flash_attn_fwd.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into build.log
)
DEFAULT_CUDA_HOME = "/usr/local/cuda"
# C entry points: (q, k, v, o, bh, n_q, n_kv, kv_len, stream) -> cudaError_t
ATTENTION_ENTRIES = ("tpdm_flash_attention_d64", "tpdm_flash_attention_d512")


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME/bin`` or
    ``DEFAULT_CUDA_HOME/bin``. Raises RuntimeError if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc, the CUDA compiler, was not found on PATH, in $CUDA_HOME/bin "
        f"or in {DEFAULT_CUDA_HOME}/bin: the tpdm_tpu_torch attention kernels "
        "cannot be built. They need the CUDA toolkit and an sm_90a (Hopper) "
        "card."
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this version of the sources has no library yet.

    Returns the library's path. The compiler's output (ptxas register and
    shared-memory report) is kept beside it as ``build.log``.
    """
    nvcc = find_nvcc()
    lib_path = BUILD_DIR / f"libtpdm_kernels_{_source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / "build.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    for name in ATTENTION_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.tpdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpdm_cuda_error_string.restype = ctypes.c_char_p
    return lib
