"""Sequence parallelism of the port: the seq process group and ring
attention over it."""

from tpdm_tpu_torch.parallel.mesh import SeqGroup, process_count, process_index, seq_group
from tpdm_tpu_torch.parallel.sp_attention import make_ring_attention
