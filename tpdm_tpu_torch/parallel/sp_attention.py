"""Sequence-parallel (ring) attention over a ``torch.distributed`` group.

Counterpart of ``tpdm_tpu/parallel/sp_attention.py``'s forward. The token
axis is sharded over the ranks of a ``SeqGroup``: queries stay where they
are, the kv shards travel around the ring (each rank sends its current
shard to rank r+1 and receives rank r-1's with one
``dist.batch_isend_irecv``), and each step's partial softmax, from kernel
K3 (``ops/attention.py:flash_attention_with_stats``), is merged exactly
through its (m, l) statistics.

The transfer of the next shard is posted before the current shard's K3
call and waited on after it, so on the card the NCCL copy runs beside the
kernel; the received buffers are read only after the wait, which orders
the current stream after the NCCL stream.

Pad rows. The JAX ring takes exact-zero pad rows and corrects the
statistics afterwards (each pad column adds exp2(0 - m) to l, which it
subtracts). Here each shard's count of valid rows is known on every rank,
so the step masks the pad inside K3 through ``kv_len``: exact for any
scores, including rows whose valid scores are all strongly negative, where
the subtraction cancels. A shard that holds only pad launches nothing: it
would contribute m = -1e30 and l = 0, which leave the merge unchanged
(the JAX ring's dead-shard guard).

Forward only. ``_ring_backward`` (the JAX package's backward ring) comes
with the trainers that differentiate through the backbone (ROADMAP queue
1, item 9(e)).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpdm_tpu_torch.ops.attention import flash_attention_with_stats
from tpdm_tpu_torch.parallel.mesh import SeqGroup

_NEG = -1e30


def shard_valid_counts(n_local: int, world: int, n_valid: int) -> list:
    """Valid rows of each of ``world`` shards of ``n_local`` rows when the
    first ``n_valid`` rows of the whole axis are valid and the rest pad."""
    return [max(0, min(n_local, n_valid - i * n_local)) for i in range(world)]


def _rotate(tensors: Sequence[torch.Tensor], group: SeqGroup):
    """Post the send of each tensor to rank r+1 and the receive of rank
    r-1's into new buffers; returns (buffers, works to wait on)."""
    size, rank = group.size, group.rank
    nxt, prv = group.global_rank((rank + 1) % size), group.global_rank((rank - 1) % size)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group.group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group.group) for t in recv]
    return recv, dist.batch_isend_irecv(ops)


def _ring_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: SeqGroup,
    shard_valid: Sequence[int],
    local_kv: Sequence[Tuple[torch.Tensor, torch.Tensor, Optional[int]]] = (),
):
    """Rotate kv once around the group, merging each step online.

    q: this rank's queries (b, h, n_q, d); k, v: this rank's kv shard
    (b, h, n_local, d), the same n_local on every rank. shard_valid[i]: the
    valid rows at the head of group rank i's shard. local_kv: (k, v, kv_len)
    held by this rank alone, merged once and not rotated (the text tokens
    of the MMDiT's joint attention). Returns (o, m, l), m and l the global
    exp2-domain statistics.
    """
    size, rank = group.size, group.rank
    b, h, n_q, d = q.shape
    num = torch.zeros((b, h, n_q, d), dtype=torch.float32, device=q.device)
    l_tot = torch.zeros((b, h, n_q), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, n_q), _NEG, dtype=torch.float32, device=q.device)

    def merge(o_i, m_i, l_i):
        nonlocal m
        m_new = torch.maximum(m, m_i)
        alpha = torch.exp2(m - m_new)
        beta = torch.exp2(m_i - m_new) * l_i
        # in place: num is the one (b, h, n_q, d) fp32 buffer of the merge
        num.mul_(alpha[..., None]).add_(o_i.float() * beta[..., None])
        l_tot.mul_(alpha).add_(beta)
        m = m_new

    k_cur, v_cur = k, v
    for step in range(size):
        works = []
        if step + 1 < size:
            (k_next, v_next), works = _rotate((k_cur, v_cur), group)
        if step == 0:
            for k_x, v_x, kv_len in local_kv:
                merge(*flash_attention_with_stats(q, k_x, v_x, kv_len))
        valid = shard_valid[(rank - step) % size]
        if valid > 0:
            n_kv = k_cur.shape[2]
            merge(*flash_attention_with_stats(q, k_cur, v_cur, valid if valid < n_kv else None))
        if step + 1 < size:
            for work in works:
                work.wait()
            k_cur, v_cur = k_next, v_next
    return (num / l_tot[..., None]).to(q.dtype), m, l_tot


def make_ring_attention(
    group: SeqGroup,
    kv_len: Optional[int] = None,
    differentiable: bool = False,
):
    """Attention with the token axis sharded over ``group``.

    As ``tpdm_tpu/parallel/sp_attention.py:make_ring_attention`` (forward):
    the returned ``ring_attention(q, k, v)`` takes this rank's shards
    (b, h, n_local, d), the same n_local on every rank and rank r holding
    rows [r * n_local, (r + 1) * n_local) of the whole axis, and returns
    this rank's shard of the output. kv_len: the number of valid kv rows
    of the whole axis; the rows from kv_len on are pad, masked (their
    content does not matter). Every rank calls it together.

    The JAX version's ``batch_axes`` (batch sharded beside the tokens) is
    not ported; ``differentiable=True`` raises.
    """
    if differentiable:
        raise NotImplementedError(
            "the backward ring (_ring_backward) is not ported to tpdm_tpu_torch yet "
            "(ROADMAP queue 1, item 9(e))"
        )

    def ring_attention(q, k, v):
        n_local = k.shape[2]
        n_valid = n_local * group.size if kv_len is None else kv_len
        o, _, _ = _ring_forward(q, k, v, group, shard_valid_counts(n_local, group.size, n_valid))
        return o

    return ring_attention
