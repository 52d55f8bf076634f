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

Training runs the same layers under autograd, which does not see an
in-place ``dist.all_reduce``.  Three functions carry the gradients, as
Megatron-LM places them:

- ``reduce_from_tp``: the sum over the group (the o- and down-projections'
  partial sums); its backward is the identity;
- ``copy_to_tp``: the identity, on the input of every column-parallel
  product (``qkv_proj``, ``gateup_proj``, ``codec_head``); its backward sums
  the ranks' partial gradients, so that the norms and the residual stream
  before it see the whole gradient;
- ``gather_from_tp``: the all-gather; its backward keeps the rank's slice.

(``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
as well, which gives ``tp`` times the gradient after a row-parallel
product.)  Their forward collectives count in ``calls`` as above; a
collective made on the backward pass, or on a gradient after it
(``all_reduce_grads``), counts in ``all_reduce.backward_calls``
(``backward_counts``), so a serving step's count stays what it was.  The
layers take these functions only with a group and grad enabled: under
``torch.inference_mode()``, where serving runs, they call the two above.
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


def all_reduce_grads(grads, group: dist.ProcessGroup) -> None:
    """Sum every tensor of ``grads`` over ``group``, in place, in one
    collective over their concatenation.  Counted as a backward
    collective."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    _count_backward(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off: off + g.numel()].view_as(g))
        off += g.numel()


def carries_grads(group: Optional[dist.ProcessGroup]) -> bool:
    """Whether a layer given ``group`` takes the functions below: a tp group
    with grad enabled (never under ``torch.inference_mode()``)."""
    return group is not None and torch.is_grad_enabled()


def _count_backward(x: torch.Tensor) -> None:
    if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        all_reduce.backward_calls += 1


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        _count_backward(grad)
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.local, ctx.rank = dim, x.shape[dim], rank(group)
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.local, ctx.local).contiguous(), None, None


def reduce_from_tp(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor); the gradient passes
    through unchanged."""
    return _ReduceFromTP.apply(x, group)


def copy_to_tp(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group``."""
    return _CopyToTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group: dist.ProcessGroup, dim: int = -1) -> torch.Tensor:
    """``all_gather`` of ``x`` along ``dim``; the gradient of the result
    gives back this rank's slice."""
    return _GatherFromTP.apply(x, group, dim % x.dim())


def counts() -> Dict[str, int]:
    return {"all_reduce": all_reduce.calls, "all_gather": all_gather.calls}


def backward_counts() -> Dict[str, int]:
    return {"all_reduce": all_reduce.backward_calls}


def reset_counts() -> None:
    all_reduce.calls = 0
    all_gather.calls = 0
    all_reduce.backward_calls = 0


reset_counts()
