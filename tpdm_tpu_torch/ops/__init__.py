"""Ops of the port: attention kernels and their plain versions, Beta math,
the flow Euler step."""

from tpdm_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
    flash_attention_streaming,
    joint_attention,
)
