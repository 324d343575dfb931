"""Ops of the port: attention kernels and their plain versions, Beta math,
the flow Euler step."""

from tpdm_tpu_torch.ops.attention import (
    attention_reference,
    attention_reference_stats,
    flash_attention,
    flash_attention_streaming,
    flash_attention_with_stats,
    joint_attention,
    merge_attention_shards,
)
