"""The "seq" process group: the counterpart of the JAX package's "seq" mesh
axis (``tpdm_tpu/parallel/mesh.py``), over which the joint-token axis of
the MMDiT is sharded.

One process per rank. On the card each rank runs on ``cuda:r`` for global
rank r and the group talks NCCL; on the CPU (the tests) it talks gloo. A
CUDA device without a card raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class SeqGroup:
    """A process group whose ranks share one token axis, and this rank's
    device. Hashes by identity, so a config holding it stays hashable."""

    group: dist.ProcessGroup
    device: torch.device

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    def global_rank(self, group_rank: int) -> int:
        """The default group's rank of this group's rank ``group_rank``
        (torch.distributed's point-to-point calls and ``src`` take these)."""
        return dist.get_global_rank(self.group, group_rank)


def seq_group(
    device: str = "cuda",
    *,
    group: Optional[dist.ProcessGroup] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
) -> SeqGroup:
    """Start or accept the seq process group; every rank calls it together.

    Args:
        device: "cuda" (NCCL, rank r on ``cuda:r``; raises without that
            card) or "cpu" (gloo).
        group: an existing group to use, e.g. a sub-group. None starts the
            default group from ``init_method`` (``tcp://host:port`` or
            ``file://path``), ``rank`` and ``world_size``, unless it is
            already started, and uses it.

    Ends with one all-reduce over the group, so a group that cannot talk
    fails here and not inside the first attention call.
    """
    if device == "cuda":
        backend = "nccl"
        r = dist.get_rank() if dist.is_initialized() else rank
        if r is None:
            raise ValueError("seq_group: pass rank (and world_size, init_method) to start the group")
        if not torch.cuda.is_available() or torch.cuda.device_count() <= r:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(
                f"seq_group: rank {r} runs on cuda:{r}, but this machine has {n} CUDA "
                "device(s); pass device='cpu' for a gloo group on the CPU"
            )
        dev = torch.device("cuda", r)
        torch.cuda.set_device(dev)
    elif device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        raise ValueError(f"seq_group: device must be 'cuda' or 'cpu', got {device!r}")

    if group is None:
        if not dist.is_initialized():
            if rank is None or world_size is None or init_method is None:
                raise ValueError("seq_group: starting a group needs rank, world_size and init_method")
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=world_size)
        group = dist.group.WORLD
    if backend not in dist.get_backend(group):
        raise ValueError(
            f"seq_group: a {device} group needs {backend}, the group uses {dist.get_backend(group)}"
        )
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe, group=group)
    if probe.item() != dist.get_world_size(group):
        raise RuntimeError(f"seq_group: all-reduce gave {probe.item()}, not the group's size")
    return SeqGroup(group, dev)


def process_index() -> int:
    """This process's rank in the default group; 0 when torch.distributed
    is not initialised (the counterpart of ``jax.process_index()``)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The default group's size; 1 when torch.distributed is not initialised
    (the counterpart of ``jax.process_count()``)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
