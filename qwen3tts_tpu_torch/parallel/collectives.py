"""The collectives of the tensor-parallel model, counted.

The JAX package lays its parameters out under ``NamedSharding`` and XLA
inserts the psums and all-gathers itself (``qwen3tts_tpu/parallel/
sharding.py``).  PyTorch places none, so the sharded layers call these two
by hand, over the process group of the mesh's ``tp`` axis
(``parallel/sharding.py:Mesh.tp_group``).  A layer given no group (``None``)
runs unsharded and calls nothing here.

Each call adds one to its function's ``calls`` (``all_reduce.calls``,
``all_gather.calls``), as the kernel wrappers count their launches: a call
made while the current CUDA stream captures a graph runs nothing then (the
graph's replays do) and is not counted.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist


def size(group: Optional[dist.ProcessGroup]) -> int:
    """Ranks in ``group``; 1 for ``None`` (no tensor parallelism)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Optional[dist.ProcessGroup]) -> int:
    """This process's rank within ``group``; 0 for ``None``."""
    return 0 if group is None else dist.get_rank(group)


def _count(fn, x: torch.Tensor) -> None:
    if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        fn.calls += 1


def all_reduce(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Sum the contiguous ``x`` over ``group``, in place.  Returns ``x``."""
    dist.all_reduce(x, group=group)
    _count(all_reduce, x)
    return x


def all_gather(x: torch.Tensor, group: dist.ProcessGroup, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x, group=group)
    _count(all_gather, x)
    return torch.cat(parts, dim=dim)


def counts() -> Dict[str, int]:
    return {"all_reduce": all_reduce.calls, "all_gather": all_gather.calls}


def reset_counts() -> None:
    all_reduce.calls = 0
    all_gather.calls = 0


all_reduce.calls = 0
all_gather.calls = 0
