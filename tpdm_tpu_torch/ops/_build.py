"""Build and bind the hand-written CUDA kernels under ``tpdm_tpu_torch/csrc``.

Each source is compiled by its own ``nvcc``, all started together, and the
objects are linked into one shared library with a plain C interface, loaded
through ``ctypes`` (no PyTorch headers, so a build takes seconds). The
library goes to ``build/tpdm_tpu_torch/`` at the repository root, named by a
hash of the sources, headers and flags, on first use: a checkout builds
everything it runs, and a changed source never loads a stale library.

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

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpdm_tpu_torch"
SOURCES = ("attn_d512_sm90.cu", "attn_sm90.cu", "attn_bwd_sm90.cu", "gemm_sm90.cu",
           "attn_studies_sm90.cu")
HEADERS = ("sm90.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into build.log
)
DEFAULT_CUDA_HOME = "/usr/local/cuda"
# C entry points, each returning a cudaError_t: every pointer and the stream
# are void*, every size an int.
#   (q, k, v, o, bh, n_q, n_kv, kv_len, stream); the stats entries take m, l
#   after o, the padded d-64 entries the true head_dim before the stream
#   tpdm_flash_attention_bwd_d64 (q, k, v, do, lse, delta, dq, dk, dv, bh,
#   n_q, n_kv, kv_len, head_dim, stream), K1's backward
#   tpdm_int8_gemm (a, b, out, x_scale, w_scale, bias, m, n, k, stream), the
#   int32 epilogue when x_scale is null; tpdm_bf16_gemm (a, b, out, m, n, k,
#   stream)
#   the studies' kernels (attn_studies_sm90.cu): q, k, v, o (K7 adds rb,
#   K8 sq, sk, scores), a pointer to the views' int64 strides, then sizes
#   and flags (b, h, n_q, n_kv[, kv_len], v_cols, ...), stream;
#   tpdm_attention_studies_routes (q, k, v, o, strides, b, h, n_q, n_kv,
#   int8) returns the studies' load routes without launching;
#   tpdm_attention_studies_layouts (kind) the orientations K7 and K9 are
#   instantiated for;
#   tpdm_sm90_helper_check (which, a, b, out, stream) runs sm90.cuh's
#   64-byte-swizzled s8 and transposed-A products alone
_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
ENTRIES = {
    "tpdm_flash_attention_d64": [_P] * 4 + [_I] * 4 + [_P],
    "tpdm_flash_attention_d64_padded": [_P] * 4 + [_I] * 5 + [_P],
    "tpdm_flash_attention_d40": [_P] * 4 + [_I] * 4 + [_P],
    "tpdm_flash_attention_d80": [_P] * 4 + [_I] * 4 + [_P],
    "tpdm_flash_attention_d128": [_P] * 4 + [_I] * 4 + [_P],
    "tpdm_flash_attention_d160": [_P] * 4 + [_I] * 4 + [_P],
    "tpdm_flash_attention_d512": [_P] * 4 + [_I] * 4 + [_P],
    "tpdm_flash_attention_stats_d64": [_P] * 6 + [_I] * 4 + [_P],
    "tpdm_flash_attention_stats_d64_padded": [_P] * 6 + [_I] * 5 + [_P],
    "tpdm_flash_attention_bwd_d64": [_P] * 9 + [_I] * 5 + [_P],
    "tpdm_int8_gemm": [_P] * 6 + [_I] * 3 + [_P],
    "tpdm_bf16_gemm": [_P] * 3 + [_I] * 3 + [_P],
    "tpdm_attention_strided_d64": [_P] * 4 + [_S] + [_I] * 8 + [_P],
    "tpdm_attention_maxfree_d64": [_P] * 5 + [_S] + [_I] * 7 + [_P],
    "tpdm_attention_int8qk_d64": [_P] * 7 + [_S] + [_I] * 7 + [_P],
    "tpdm_attention_probe_d64": [_P] * 4 + [_S] + [_I] * 7 + [_P],
    "tpdm_attention_studies_routes": [_P] * 4 + [_S] + [_I] * 5,
    "tpdm_attention_studies_layouts": [_I],
    "tpdm_sm90_helper_check": [_I] + [_P] * 4,
}


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
        f"or in {DEFAULT_CUDA_HOME}/bin: the tpdm_tpu_torch kernels "
        "cannot be built. They need the CUDA toolkit and an sm_90a (Hopper) "
        "card."
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this version of the sources has no library yet.

    Returns the library's path. The compilers' output (ptxas register and
    shared-memory report) is kept beside it as ``build.log``.
    """
    nvcc = find_nvcc()
    lib_path = BUILD_DIR / f"libtpdm_kernels_{_source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC_DIR / s)]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        outs = [p.communicate() for p in procs]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]
        log = [" ".join(c) + "\n" + out + err for c, (out, err) in zip(cmds, outs)]
        failed = [(c, p.returncode, err) for c, p, (_, err) in zip(cmds, procs, outs)
                  if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append((link, proc.returncode, proc.stderr))
        (BUILD_DIR / "build.log").write_text("".join(log))
        if failed:
            cmd, rc, err = failed[0]
            raise RuntimeError(f"nvcc failed (exit {rc}) on {cmd[-1]}:\n{err[-4000:]}")
        os.replace(os.path.join(tmp, "lib.so"), lib_path)
    return lib_path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def refuse_grad(name: str, item: str, *operands) -> None:
    """Raise if autograd would need a gradient through a kernel launch that
    has no backward.

    The kernels write into tensors that ctypes knows only as pointers, so
    their outputs carry no ``grad_fn``: a backward through one would drop
    the gradient silently. K1 at head dims up to 64 and K2 have backwards
    (``ops/attention.py``); the others raise here, naming ``item``, the
    queue item that brings theirs: run them under ``torch.no_grad()`` or on
    operands that do not require grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{name}: an operand requires grad, and this CUDA kernel has no backward "
            f"({item}); run it under torch.no_grad()")
