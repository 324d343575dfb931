"""Ops of the port: attention and GEMM kernels and their plain versions,
quantised dense layers, Beta math, the flow Euler, Heun and AB2 steps."""

from tpdm_tpu_torch.ops.attention import (
    attention_reference,
    attention_reference_stats,
    flash_attention,
    flash_attention_streaming,
    flash_attention_with_stats,
    joint_attention,
    merge_attention_shards,
)
from tpdm_tpu_torch.ops.flow_euler import flow_euler_step
from tpdm_tpu_torch.ops.flow_solver import flow_ab2_step, flow_heun_combine
from tpdm_tpu_torch.ops.gemm import (
    bf16_gemm,
    bf16_gemm_reference,
    int8_gemm,
    int8_gemm_reference,
)
