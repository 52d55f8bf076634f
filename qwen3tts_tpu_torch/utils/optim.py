"""The optax pieces the port's two trainers use, on trees of tensors.

``parallel/sharding.py:make_train_step`` takes ``optax.adamw(lr)`` and
``tools/train_asr.py:train`` takes ``optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(...)))``.  These give optax's numbers:

- ``adamw``: b1 0.9, b2 0.999, eps 1e-8 outside the square root, weight
  decay 1e-4 on every leaf, the update ``-lr * (m_hat / (sqrt(v_hat) +
  eps) + wd * p)``.  ``torch.optim.AdamW`` differs twice: its decay
  defaults to 1e-2, and it skips a leaf whose ``.grad`` is None, where
  optax decays a leaf the loss never reads (its gradient is zero): here
  every leaf of ``params`` takes a gradient, zeros where it has none.
- ``clip_by_global_norm``: ``t / norm * max_norm`` when ``norm >=
  max_norm`` (``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm /
  (norm + 1e-6)``).
- ``warmup_cosine_decay_schedule``: optax's float32 arithmetic, step by step.

A tree is a dict (or list) of tensors; leaves are visited in JAX's order
(dict keys sorted, depth first).  The updates are in place: ``params`` and
the state's moments are written, as JAX donates them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

Tree = Union[Dict, List, torch.Tensor]
Schedule = Callable[[int], float]


def named_leaves(tree: Tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(``/``-joined path, tensor) of every leaf, in JAX's flattening order."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    return [leaf for k, v in items
            for leaf in named_leaves(v, f"{prefix}/{k}" if prefix else str(k))]


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in JAX's flattening order."""
    return [t for _, t in named_leaves(tree)]


def zeros_like(tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (a 0-d tensor)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: every leaf becomes
    ``g / norm * max_norm`` unless ``norm < max_norm``.  Returns the norm.
    Decided on the device (no host sync)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax's schedule of the same name: a linear warm-up from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (the warm-up included).
    ``schedule(count)`` is a Python float of optax's float32 value."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine part needs positive steps, got "
                         f"{decay_steps - warmup_steps}")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def linear(count: int) -> np.float32:
        if warmup_steps <= 0:
            return f32(init_value)
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int) -> np.float32:
        c = f32(min(count, cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        return f32(peak_value) * (f32(1 - alpha) * decay ** f32(exponent) + f32(alpha))

    def schedule(count: int) -> float:
        count = int(count)
        return float(linear(count) if count < warmup_steps else cosine(count - warmup_steps))

    return schedule


class AdamW:
    """``optax.adamw(learning_rate)``: ``init(params)`` makes the state,
    ``step(params, grads, state)`` updates ``params`` and ``state`` in
    place.  ``learning_rate`` is a float or a schedule of the step count
    (0 at the first step)."""

    def __init__(self, learning_rate: Union[float, Schedule], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: Tree) -> Dict:
        return {"count": 0, "mu": zeros_like(params), "nu": zeros_like(params)}

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(np.float32(lr))

    def step(self, params: Tree, grads: List[Optional[torch.Tensor]], state: Dict) -> Dict:
        """One update.  ``grads`` follows ``leaves(params)``; a None is a
        leaf the loss does not read (zero gradient: it is only decayed)."""
        ps, mus, nus = leaves(params), leaves(state["mu"]), leaves(state["nu"])
        if len(grads) != len(ps):
            raise ValueError(f"{len(grads)} gradients for {len(ps)} leaves")
        lr = self.lr(state["count"])
        count = state["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        with torch.no_grad():
            for p, g, mu, nu in zip(ps, grads, mus, nus):
                if g is None:
                    mu.mul_(self.b1)
                    nu.mul_(self.b2)
                else:
                    mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
                    nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                update = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
                update.add_(p, alpha=self.weight_decay)
                p.add_(update, alpha=-lr)
        state["count"] = count
        return state


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its defaults (``AdamW``)."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)
