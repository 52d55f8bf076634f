"""Rank functions for tests/test_torch_sharding.py.

``launch`` pickles the function it runs by module and name, and its spawned
ranks import that module: these live apart from the test file, which
imports JAX, and import only torch, numpy and the port.
"""
import sys

import torch

from qwen3tts_tpu_torch.models import predictor as P
from qwen3tts_tpu_torch.models import talker as T
from qwen3tts_tpu_torch.parallel import collectives
from qwen3tts_tpu_torch.parallel.sharding import (
    _host,
    _shardable_cfg,
    gather_params,
    kv_cache_specs,
    predictor_param_specs,
    shard_kv_cache,
    shard_params,
    sharded_batched_serving_check,
    sharded_flagship_check,
    sharded_flagship_structural_check,
    sharded_inference_check,
    talker_param_specs,
)


def _embed_text(params, ids, group=None):
    """The text embedding and projection under their specs: the embedding
    split on its hidden axis, so the projection's input rows too; the
    partial products all-reduced, then the bias added once (the port builds
    prompts on the host from whole leaves; this holds the layout only)."""
    tp = params["text_projection"]
    y = params["text_embedding"][ids] @ tp["w"]
    return (y if group is None else collectives.all_reduce(y, group)) + tp["b"]


def _project_speaker(params, xvector, group=None):
    """The speaker projection under its spec: split on its output axis,
    the pieces all-gathered."""
    p = params["spk_proj"]
    y = xvector @ p["w"] + p["b"]
    return y if group is None else collectives.all_gather(y, group)


def greedy_tokens(mesh, params):
    """sharded_inference_check without and with the int8 KV cache."""
    return {kv_quant: sharded_inference_check(mesh, 8, kv_quant, params=params)
            for kv_quant in (False, True)}


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return float("inf")
    return (a.float() - b.float()).abs().max().item()


def _roundtrip(tree, mesh, specs) -> int:
    """Leaves of ``tree`` that gather_params(shard_params(...)) gives back
    bit for bit (all of them, or it raises)."""
    back = gather_params(shard_params(tree, mesh, specs), mesh, specs)
    n = 0

    def walk(a, b, path):
        nonlocal n
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
            return
        a = torch.as_tensor(a)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{path}: gather(shard(x)) != x")
        n += 1

    walk(tree, back, "")
    return n


def parts(mesh, params):
    """The layout and the sharded model's parts on one mesh: the round
    trip, the sharded embeddings / heads / lookups against the whole ones,
    the batched serving check, the flagship check's counted step and the
    structural check, both on the tiny shardable config, and the rank's
    imported JAX modules."""
    cfg = _shardable_cfg()
    tk, pk = cfg.talker, cfg.predictor
    tfull, pfull = _host(params[0], torch.float32), _host(params[1], torch.float32)
    g = mesh.tp_group
    out = {"jax_modules": sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "jaxlib", "qwen3tts_tpu"))}

    gen = torch.Generator().manual_seed(4)
    kv = T.new_kv_cache(tk, 2, 16, torch.float32, "cpu", kv_quant=True)
    kv = {k: (torch.randint(-127, 128, v.shape, generator=gen, dtype=torch.int8)
              if v.dtype == torch.int8 else torch.rand(v.shape, generator=gen))
          for k, v in kv.items()}
    out["roundtrip_leaves"] = (_roundtrip(params[0], mesh, talker_param_specs(tk))
                               + _roundtrip(params[1], mesh, predictor_param_specs(pk))
                               + _roundtrip(kv, mesh, kv_cache_specs(True)))
    kv_local = shard_kv_cache(kv, mesh)
    out["kv_shapes"] = {k: tuple(v.shape) for k, v in kv_local.items()}

    tloc = shard_params(tfull, mesh, talker_param_specs(tk))
    ploc = shard_params(pfull, mesh, predictor_param_specs(pk))
    ids = torch.randint(0, tk.vocab_size, (3, 5), generator=gen)
    text_ids = torch.randint(0, tk.text_vocab_size, (2, 7), generator=gen)
    hidden = torch.randn((3, tk.hidden_size), generator=gen)
    xvec = torch.randn((2, tk.speaker_embed_dim), generator=gen)
    h = torch.randn((3, pk.hidden_size), generator=gen)
    toks = torch.randint(0, pk.codebook_size, (3, pk.num_codebooks), generator=gen)
    d = {
        "embed_codec": _max_diff(T.embed_codec(tloc, ids, g), T.embed_codec(tfull, ids)),
        "codec_head": _max_diff(T.codec_head(tloc, hidden, g), T.codec_head(tfull, hidden)),
        "embed_text": _max_diff(_embed_text(tloc, text_ids, g), _embed_text(tfull, text_ids)),
        "project_speaker": _max_diff(_project_speaker(tloc, xvec, g),
                                     _project_speaker(tfull, xvec)),
        "lm_logits": max(_max_diff(P._lm_logits(ploc, cb, h, g), P._lm_logits(pfull, cb, h))
                         for cb in (0, 7, 14)),
        "codec_embed": max(_max_diff(P._codec_embed(ploc, cb, toks[:, cb], g),
                                     P._codec_embed(pfull, cb, toks[:, cb]))
                           for cb in (0, 6, 13)),
        "embed_sum": _max_diff(P.embed_sum_for(ploc, toks, torch.float32, g),
                               P.embed_sum_for(pfull, toks, torch.float32)),
    }
    out["diffs"] = d
    out["batched"] = sharded_batched_serving_check(mesh, params=params)
    stats = {}
    collectives.reset_counts()
    out["flagship"] = sharded_flagship_check(mesh, 4, preset=cfg, params=params, stats=stats)
    out["stats"] = stats
    out["structural"] = sharded_flagship_structural_check(mesh, 4, preset=cfg, params=params,
                                                          fp32_ids=out["flagship"][1])
    return out


def flagship_gloo(mesh):
    """The 0.6B flagship check in float32 with the int8 cache, eager (a
    gloo mesh on the card), with its counted step on every rank."""
    import torch.distributed as dist

    stats = {}
    ids, single = sharded_flagship_check(mesh, 4, use_cuda_graphs=False, stats=stats)
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, stats["sharded"])
    return ids, single, per_rank
