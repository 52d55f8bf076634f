"""Random weights of one configuration, drawn from the run's seed.

The tree is the layout the program takes (its ``init_params`` on the meta
device gives the leaves' paths and shapes; nothing is drawn there).  The
numbers are this file's: normal draws from one ``torch.Generator`` on the
run's device, made in a few large calls and cut into the leaves, each leaf
scaled by a rule of its name and shape, then cast to the dtype it is served
in (the talker and the predictor in the configuration's dtype, the codec
and the speaker encoder in float32).  Norm weights sit around 1, biases and
the codec's snake parameters around 0, so no leaf is a constant the
program could get right by accident.
"""
from __future__ import annotations

from typing import Dict

import torch

NORMS = {"input_norm", "post_norm", "q_norm", "k_norm", "final_norm", "ln1", "ln2", "norm_w"}
LAYER_SCALES = {"scale1", "scale2", "scale"}
SNAKES = {"alpha", "beta", "alpha1", "beta1", "alpha2", "beta2", "out_alpha", "out_beta"}
EMBEDDINGS = {"codec_embedding", "text_embedding", "codec_embeddings", "code_embedding"}
DRAW = 1 << 27  # normal draws made at once


def _tree(cfg) -> Dict:
    """The program's parameter tree for ``cfg``, meta tensors."""
    from qwen3tts_tpu_torch.models import codec, predictor, speaker, talker

    meta, f32 = torch.device("meta"), torch.float32
    return {
        "talker": talker.init_params(None, cfg.talker, f32, meta),
        "predictor": predictor.init_params(None, cfg.predictor, cfg.talker.hidden_size,
                                           f32, meta),
        "codec": codec.init_params(None, cfg.codec, f32, meta),
        "speaker": speaker.init_params(None, cfg.speaker_encoder, f32, meta),
    }


def leaf_rule(path: tuple, shape: tuple):
    """(offset, scale) of the leaf at ``path``: draw * scale + offset."""
    name = path[-1]
    if name in NORMS:
        return 1.0, 0.1
    if name in LAYER_SCALES:
        return 0.01, 0.001
    if name in SNAKES:
        return 0.0, 0.1
    if name in ("b", "norm_b"):
        return 0.0, 0.02
    if name in EMBEDDINGS:
        return 0.0, 0.02
    if name == "codebooks":
        return 0.0, 0.05
    if len(shape) == 3 and path[0] in ("codec", "speaker"):
        # convolutions [Cout, Cin, K]; transposed ones [Cin, Cout, K]
        fan_in = (shape[0] if "tconv" in path else shape[1]) * shape[2]
        return 0.0, fan_in ** -0.5
    return 0.0, shape[-2] ** -0.5  # products [..., in, out]


def make_weights(cfg, seed: int, device) -> Dict:
    """The parameter tree of ``cfg`` on ``device``, drawn from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    model_dtype = cfg.torch_dtype
    buf, used = None, 0

    def draw(n: int) -> torch.Tensor:
        nonlocal buf, used
        if buf is None or used + n > buf.numel():
            buf = torch.randn(max(n, DRAW), generator=gen, device=device, dtype=torch.float32)
            used = 0
        out = buf[used: used + n]
        used += n
        return out

    def fill(node, path):
        if isinstance(node, dict):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v, path + (str(i),)) for i, v in enumerate(node)]
        dtype = model_dtype if path[0] in ("talker", "predictor") else torch.float32
        offset, scale = leaf_rule(path, tuple(node.shape))
        return (draw(node.numel()).view(node.shape) * scale + offset).to(dtype)

    with torch.no_grad():
        params = fill(_tree(cfg), ())
    del buf
    return params
