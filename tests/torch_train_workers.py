"""Rank functions for tests/test_torch_train.py.

``launch`` pickles the function it runs by module and name, and its spawned
ranks import that module: these live apart from the test file, which
imports JAX, and import only torch, numpy and the port.
"""
import hashlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from qwen3tts_tpu_torch.parallel import collectives
from qwen3tts_tpu_torch.parallel.sharding import (
    _host,
    _shardable_cfg,
    _talker_nll,
    gather_params,
    make_train_step,
    shard_params,
    talker_param_specs,
)
from qwen3tts_tpu_torch.utils import optim


def _digest(tree) -> str:
    h = hashlib.sha256()
    for name, t in optim.named_leaves(tree):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def train_steps(mesh, params, batch, lr: float, steps: int):
    """``steps`` of ``make_train_step`` on the tiny shardable config's
    talker (``params``: numpy, the JAX initialiser's) over ``mesh``.
    Returns on rank 0: the losses, the gathered params after the last step
    (numpy), the collectives of each step (forward and backward), whether
    every rank's gathered params had the same bits after each step, and
    the collectives of one forward under ``torch.inference_mode()`` and
    with grad enabled, and the rank's imported JAX modules."""
    tk = _shardable_cfg().talker
    specs = talker_param_specs(tk)
    local = shard_params(_host(params, torch.float32), mesh, specs)
    init_opt, train_step = make_train_step(tk, mesh, learning_rate=lr)
    opt_state = init_opt(local)
    losses, per_step, same_bits = [], [], []
    world = dist.get_world_size()
    for _ in range(steps):
        collectives.reset_counts()
        local, opt_state, loss = train_step(local, opt_state, *batch)
        per_step.append({"forward": collectives.counts(),
                         "backward": collectives.backward_counts()})
        losses.append(float(loss))
        digests = [None] * world
        dist.all_gather_object(digests, _digest(gather_params(local, mesh, specs)))
        same_bits.append(len(set(digests)) == 1)
    embeds, targets, pad = (torch.tensor(np.asarray(x)) for x in batch)
    forward = {}
    for mode, ctx in (("inference", torch.inference_mode()), ("grad", torch.enable_grad())):
        collectives.reset_counts()
        with ctx:
            _talker_nll(local, tk, embeds, targets, pad, mesh.tp_group)
        forward[mode] = {"forward": collectives.counts(),
                         "backward": collectives.backward_counts()}
    gathered = _numpy(gather_params(local, mesh, specs))
    return {"losses": losses, "params": gathered, "per_step": per_step,
            "same_bits": same_bits, "forward_only": forward,
            "jax_modules": sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                                         "qwen3tts_tpu"))}
