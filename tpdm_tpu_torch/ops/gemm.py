"""Matrix products of the quantised dense layers.

Two hand-written Hopper kernels, K4 (int8) and K5 (bf16), both
instantiations of the persistent wgmma + TMA kernel of
``csrc/gemm_sm90.cu``, and their plain PyTorch versions,
``int8_gemm_reference`` and ``bf16_gemm_reference``. The wrappers dispatch
on the tensor's device: a CUDA tensor launches the kernel (or the wrapper
raises on what the kernel does not take), a CPU tensor runs the plain
version. There is no flag that picks the plain version on CUDA.

Both take the second operand as ``b_t`` (N, K), ``nn.Linear``'s (out, in)
weight, and compute ``a @ b_t.T``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpdm_tpu_torch.ops import _build

# the kernels count their 128 x 256 output tiles in 32-bit ints
_MAX_TILES = 2**31 - 1


def int8_gemm_reference(
    a: torch.Tensor,
    b_t: torch.Tensor,
    x_scale: Optional[torch.Tensor] = None,
    w_scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain ``int8_gemm``: the exact int32 product of int8 a (M, K) and
    b_t (N, K), and with the scales its dequantised form.

    The product is exact on both devices: on the CPU ``torch.matmul`` of the
    int32 casts; on CUDA, which has no integer matmul outside a library, an
    fp64 product cast to int32, exact because |acc| <= 127² K < 2^53 for any
    K below 5e11. With x_scale (M,) and w_scale (N,) fp32 it returns
    ``(float(acc) * x_scale[row]) * w_scale[col] (+ bias[col])`` in fp32,
    as ``tpdm_tpu/ops/quant.py:int8_dynamic_matmul`` orders it, cast to
    ``out_dtype``.
    """
    if a.device.type == "cpu":
        acc = torch.matmul(a.to(torch.int32), b_t.to(torch.int32).T)
    else:
        acc = torch.matmul(a.double(), b_t.double().T).to(torch.int32)
    if x_scale is None:
        return acc
    y = acc.float() * x_scale[:, None] * w_scale[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def bf16_gemm_reference(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Plain ``bf16_gemm``: the fp32 product of a (M, K) and b_t (N, K),
    rounded once to a's dtype."""
    return torch.matmul(a.float(), b_t.float().T).to(a.dtype)


def _check_operands(name: str, a, b_t, dtype: torch.dtype, k_multiple: int):
    """Validate CUDA operands of a GEMM kernel; returns (M, N, K)."""
    _build.refuse_grad(name, a, b_t)
    for label, t in (("a", a), ("b_t", b_t)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {label} is on {t.device}, expected cuda")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, the kernel takes {dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name}: {label} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    if b_t.device != a.device:
        raise ValueError(f"{name}: a and b_t must be on one device")
    (m, k), (n, k_b) = a.shape, b_t.shape
    if k != k_b:
        raise ValueError(f"{name}: a {tuple(a.shape)} and b_t {tuple(b_t.shape)} differ in K")
    if k == 0 or k % k_multiple:
        raise ValueError(f"{name}: K = {k} is not a positive multiple of {k_multiple}")
    if m == 0 or n == 0:
        raise ValueError(f"{name}: empty product {m} x {n}")
    if -(-m // 128) * -(-n // 256) > _MAX_TILES:
        raise ValueError(f"{name}: {m} x {n} is more than {_MAX_TILES} output tiles")
    return m, n, k


def _check_vector(name: str, label: str, v, n: int, device, dtype) -> None:
    if v.device != device or v.dtype != dtype or v.shape != (n,) or not v.is_contiguous():
        raise ValueError(
            f"{name}: {label} must be a contiguous ({n},) {dtype} tensor on {device}, "
            f"got {tuple(v.shape)} {v.dtype} on {v.device}"
        )


def _raise_on_error(lib, entry: str, err: int) -> None:
    if err != 0:
        msg = lib.tpdm_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")


def int8_gemm(
    a: torch.Tensor,
    b_t: torch.Tensor,
    x_scale: Optional[torch.Tensor] = None,
    w_scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K4: int8 a (M, K) times int8 b_t (N, K) with an int32 accumulator.

    Replaces ``experiments/attn_round3.py:_mm_kernel_i8``, the int8 x int8
    -> int32 product inside ``tpdm_tpu/ops/quant.py:int8_dynamic_matmul``.
    Without scales it returns the raw int32 accumulator (M, N). With
    x_scale (M,) and w_scale (N,) fp32 and an optional bias (N,) the
    kernel's epilogue returns the dequantised product, formed exactly as
    ``int8_gemm_reference`` forms it. On the H100 the path's shapes are
    compute bound: the s8 instantiation of the persistent wgmma kernel fed
    by TMA (``wgmma`` m64n256k32 with an int32 accumulator;
    ``csrc/gemm_sm90.cu`` holds the design note).

    CUDA: contiguous, 16-byte aligned int8 operands with K a multiple of 32,
    a bf16 bias and a bf16 output (the bf16 model's), no scale or bias
    requiring grad while grad mode is on, or it raises. CPU:
    the plain version ``int8_gemm_reference``, in any ``out_dtype``.
    """
    if a.device.type == "cpu":
        return int8_gemm_reference(a, b_t, x_scale, w_scale, bias, out_dtype)
    name = "int8_gemm"
    _build.refuse_grad(name, x_scale, w_scale, bias)
    m, n, k = _check_operands(name, a, b_t, torch.int8, 32)
    if (x_scale is None) != (w_scale is None):
        raise ValueError(f"{name}: pass both x_scale and w_scale, or neither")
    if x_scale is None:
        if bias is not None:
            raise ValueError(f"{name}: a bias needs the dequant epilogue (x_scale, w_scale)")
        out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    else:
        if out_dtype != torch.bfloat16:
            raise TypeError(f"{name}: out_dtype {out_dtype}, the kernel writes bfloat16")
        _check_vector(name, "x_scale", x_scale, m, a.device, torch.float32)
        _check_vector(name, "w_scale", w_scale, n, a.device, torch.float32)
        if bias is not None:
            _check_vector(name, "bias", bias, n, a.device, torch.bfloat16)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        err = lib.tpdm_int8_gemm(
            a.data_ptr(), b_t.data_ptr(), out.data_ptr(), ptr(x_scale), ptr(w_scale),
            ptr(bias), m, n, k, torch.cuda.current_stream(a.device).cuda_stream,
        )
    _raise_on_error(lib, "tpdm_int8_gemm", err)
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def bf16_gemm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """K5: bf16 a (M, K) times bf16 b_t (N, K), fp32 accumulator, bf16 out.

    Replaces ``experiments/attn_round3.py:_mm_kernel``: the product of
    ``tpdm_tpu/ops/quant.py:w4_matmul`` (and ``w8_matmul``) once the weight
    is dequantised. The bf16 instantiation of the persistent wgmma kernel
    fed by TMA (``csrc/gemm_sm90.cu`` holds the design note).

    CUDA: contiguous, 16-byte aligned bf16 operands with K a multiple of 16,
    neither requiring grad while grad mode is on, or it raises. CPU: the plain version ``bf16_gemm_reference``.
    """
    if a.device.type == "cpu":
        return bf16_gemm_reference(a, b_t)
    m, n, k = _check_operands("bf16_gemm", a, b_t, torch.bfloat16, 16)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        err = lib.tpdm_bf16_gemm(a.data_ptr(), b_t.data_ptr(), out.data_ptr(), m, n, k,
                                 torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on_error(lib, "tpdm_bf16_gemm", err)
    bf16_gemm.launches += 1
    return out


bf16_gemm.launches = 0
