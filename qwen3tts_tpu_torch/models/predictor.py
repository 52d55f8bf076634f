"""The code predictor: the 5-layer MTP transformer emitting codebooks 1..15.

Port of ``qwen3tts_tpu/models/predictor.py:predict_frame`` on its default
path: a 2-token prefill, then one single-token step per remaining codebook
over a 17-slot cache, with one LM head and one sample per codebook.  The
predictor (head_dim 64) uses the plain masked attention, as in the JAX
package, which passes it no flash context.  With ``fused`` the 14
single-token micro-steps run each block through the fused kernels; the
2-token prefill does not.  With ``micro_kernel`` each micro-step is one
launch of ``ops/predictor_step.py:fused_micro_step`` (proj + every block +
final norm) for all the frame's rows; ``micro_kernel_misfit`` is its one
gate (the JAX package takes it at batch 1 only, and off by default; the
engine here takes it by default wherever the gate lets it).  The blocks may
be int8 weight-only or w8a8, the lm_heads int8 weight-only
(``ops/quant.py:quantize_bundle``).
``predict_frame_teacher`` runs the frame on given tokens and returns every
head's logits: the quantization quality gate's path (``utils/quality.py``).

A frame reads nothing from the host and allocates nothing that a replayed
CUDA graph could not reuse: ``frame_scratch`` holds the 17-slot cache (every
read is masked to the slots the frame has written) and the frame's fixed
positions, RoPE rows and masks, made once by the caller; the sampling
``temperature`` and ``top_p`` may be 0-d tensors (``runtime/engine.py``'s
knobs).

With a tp ``group`` (``parallel/sharding.py``) ``params`` is this rank's
shard (``predictor_param_specs``): the blocks and the 17-slot cache hold its
heads, each LM head a slice of the codebook's vocabulary (the logits are
all-gathered, so every rank samples from the same full logits), each codec
embedding table a slice of its vocabulary rows: a lookup by id
(``codec_rows``) gives this rank's rows and zeros for the ids it does not
hold, and is all-reduced (``embed_sum_for`` sums the 15 codebooks' rows
first and all-reduces once).  ``small_to_mtp`` stays whole.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.config import PredictorConfig
from ..ops import predictor_step as micro_step
from ..ops.predictor_step import fused_micro_step, micro_step_weights
from ..ops.quant import is_quantized
from ..ops.rope import mrope_cos_sin
from ..ops.sampling import Knob, sample_logits
from ..parallel.collectives import all_gather, all_reduce, rank, size
from .layers import (
    BlockSpec,
    decode_mask,
    init_block_stack,
    init_kv_cache,
    prefill_mask,
    randn,
    rms_norm,
    stack_forward,
)

Params = Dict


@dataclasses.dataclass(frozen=True)
class StaticPolicy:
    """The structural part of the predictor's sampling policy: what a
    captured frame is keyed on."""

    do_sample: bool = True
    top_k: int = 50
    use_top_p: bool = False


@dataclasses.dataclass(frozen=True)
class SamplingPolicy:
    """Predictor sampling policy (defaults mirror the JAX package)."""

    do_sample: bool = True
    top_k: int = 50
    top_p: float = 1.0
    temperature: float = 0.9

    @property
    def static(self) -> StaticPolicy:
        return StaticPolicy(do_sample=self.do_sample, top_k=self.top_k,
                            use_top_p=self.top_p < 1.0)


def block_spec(cfg: PredictorConfig, tp: int = 1) -> BlockSpec:
    """The stack's geometry, one rank's share of it at ``tp``."""
    return BlockSpec(
        num_layers=cfg.num_hidden_layers,
        hidden_size=cfg.hidden_size,
        num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        intermediate_size=cfg.intermediate_size,
        rms_norm_eps=cfg.rms_norm_eps,
    ).shard(tp)


def init_params(gen: torch.Generator, cfg: PredictorConfig, talker_hidden: int,
                dtype, device) -> Params:
    Hp, CB, NC = cfg.hidden_size, cfg.codebook_size, cfg.num_codebooks
    return {
        "small_to_mtp": {
            "w": randn(gen, (talker_hidden, Hp), talker_hidden ** -0.5, dtype, device),
            "b": torch.zeros((Hp,), dtype=dtype, device=device),
        },
        "blocks": init_block_stack(gen, block_spec(cfg), dtype, device),
        "final_norm": torch.ones((Hp,), dtype=dtype, device=device),
        "lm_heads": randn(gen, (NC, Hp, CB), Hp ** -0.5, dtype, device),
        "codec_embeddings": randn(gen, (NC, CB, talker_hidden), 0.02, dtype, device),
    }


def _proj(params: Params, x: torch.Tensor) -> torch.Tensor:
    p = params["small_to_mtp"]
    return x @ p["w"] + p["b"]


def _lm_logits(params: Params, cb: int, h: torch.Tensor, group=None) -> torch.Tensor:
    """h [B, Hp] @ lm_heads[cb] -> float32 logits [B, CB].  An int8 head is
    converted to h's values, accumulated in float32 and scaled per column,
    as the JAX package computes it (``predictor.py:104-115``).  With a
    ``group``, this rank's vocabulary slice, all-gathered."""
    lm = params["lm_heads"]
    if is_quantized(lm):
        y = torch.matmul(h.float(), lm["q"][cb].float())
        return y * lm["scale"][cb].float()
    logits = (h @ lm[cb]).float()
    return logits if group is None else all_gather(logits, group)


def codec_rows(params: Params, cb, ids: torch.Tensor, group=None) -> torch.Tensor:
    """``codec_embeddings[cb, ids]`` (``cb`` an int or an index tensor that
    broadcasts against ``ids``): [..., H_talker].  With a ``group`` the
    tables hold this rank's vocabulary rows, ``rank * n`` to ``(rank + 1) *
    n``: an id outside them gives zeros, and the caller all-reduces."""
    table = params["codec_embeddings"]
    if group is None:
        return table[cb, ids]
    n = table.shape[1]
    local = ids - rank(group) * n
    held = (local >= 0) & (local < n)
    return table[cb, local.clamp(0, n - 1)].masked_fill(~held[..., None], 0)


def _codec_embed(params: Params, cb: int, ids: torch.Tensor, group=None) -> torch.Tensor:
    rows = codec_rows(params, cb, ids, group)
    return rows if group is None else all_reduce(rows, group)


def _rope(cfg: PredictorConfig, pos_1d: torch.Tensor):
    return mrope_cos_sin(pos_1d, cfg.head_dim, cfg.rope_theta, None)


def micro_kernel_misfit(params: Params, cfg: PredictorConfig, rows: int,
                        device: Optional[torch.device] = None, group=None) -> Optional[str]:
    """The whole-micro-step kernel's one gate: why it cannot run the
    micro-steps of a frame of ``rows`` rows, or None where it can.  It takes
    plain (not int8 or w8a8) predictor blocks, full attention (no sliding
    window) and no tp ``group`` (it runs what the row-parallel all-reduce
    must split).  With a ``device`` it also asks what the card's kernel
    needs: CUDA tensors, at most ``MAX_ROWS`` rows and an instance for the
    shapes; without one, the micro-step's plain version, which any device
    and row count runs, is asked about."""
    blocks = params["blocks"]
    why = []
    if any(is_quantized(blocks[k]) for k in ("qkv_proj", "o_proj", "gateup_proj",
                                             "down_proj")):
        why.append("the predictor's blocks are quantized")
    if cfg.sliding_window is not None:
        why.append(f"a sliding window of {cfg.sliding_window}")
    if group is not None:
        why.append("a tp group (a mesh): the row-parallel all-reduce would fall inside the "
                   "kernel")
    if device is not None:
        if rows > micro_step.MAX_ROWS:
            why.append(f"{rows} rows (at most {micro_step.MAX_ROWS})")
        if device.type != "cuda":
            why.append(f"the tensors are on {device.type}, and the kernel runs on CUDA")
        elif not why:
            w = params["small_to_mtp"]["w"]
            dims = (w.shape[0], cfg.hidden_size, cfg.num_attention_heads,
                    cfg.num_key_value_heads, cfg.head_dim, cfg.intermediate_size,
                    cfg.num_hidden_layers, cfg.max_seq)
            try:
                with torch.cuda.device(device):
                    micro_step.instance(dims, rows, w.dtype)
            except ValueError as e:
                why.append(str(e))
    return "; ".join(why) or None


def frame_scratch(cfg: PredictorConfig, batch: int, dtype, device, tp: int = 1) -> Dict:
    """What every frame of one batch size reuses: the 17-slot cache (of one
    rank's kv heads at ``tp``) and, per micro-step, its slot ``pos`` (int32
    [1]), RoPE rows and decode mask; the 2-token prefill's RoPE rows and
    mask.  Make it once, outside any CUDA graph that reads it."""
    B, S, dev = batch, cfg.max_seq, torch.device(device)
    zero_pad = torch.zeros((B,), dtype=torch.int32, device=dev)
    steps = []
    for cb in range(1, cfg.num_codebooks):
        pos = torch.full((1,), cb + 1, dtype=torch.int32, device=dev)  # slot 2 + (cb - 1)
        cos, sin = _rope(cfg, pos.long().expand(B, 1))
        steps.append({"pos": pos, "cos": cos, "sin": sin,
                      "mask": decode_mask(S, cb + 1, zero_pad, cfg.sliding_window)})
    cos, sin = _rope(cfg, torch.arange(2, device=dev).expand(B, 2))
    return {"kv": init_kv_cache(block_spec(cfg, tp), B, S, dtype, dev), "steps": steps,
            "prefill": {"cos": cos, "sin": sin,
                        "mask": prefill_mask(2, 2, zero_pad, cfg.sliding_window)}}


def predict_frame(
    params: Params,
    cfg: PredictorConfig,
    pred_input: torch.Tensor,  # [B, 2, H_talker] = cat(past_hidden, token0_embed)
    generator: Optional[torch.Generator],
    policy,  # SamplingPolicy or StaticPolicy
    layers: Optional[Sequence[Params]] = None,
    fused: bool = False,
    micro_kernel: bool = False,
    micro_weights: Optional[Dict] = None,
    temperature: Optional[Knob] = None,  # default: policy.temperature
    top_p: Optional[Knob] = None,  # default: policy.top_p
    scratch: Optional[Dict] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the 15-codebook frame.  Returns (tokens [B, 15] int64, embed_sum
    [B, 1, H_talker]) with embed_sum = sum_i codec_embeddings[i][tokens_i].
    ``micro_weights`` is ``micro_step_weights(params)``, prepared once
    outside the frame loop (made here when it is not given); ``scratch`` is
    ``frame_scratch`` for this batch, dtype, device and tp (made here when
    it is not given).  With a tp ``group`` neither ``fused`` nor
    ``micro_kernel`` may be set: both kernels run what the row-parallel
    all-reduce must split.  ``micro_kernel`` raises where
    ``micro_kernel_misfit`` refuses the frame."""
    if group is not None and (fused or micro_kernel):
        raise ValueError("predict_frame with a tp group runs neither the fused kernels "
                         "nor the micro-step kernel")
    B = pred_input.shape[0]
    if micro_kernel:
        misfit = micro_kernel_misfit(params, cfg, B)
        if misfit:
            raise ValueError(f"predict_frame(micro_kernel=True): {misfit}")
    if isinstance(policy, SamplingPolicy):
        temperature = policy.temperature if temperature is None else temperature
        top_p = policy.top_p if top_p is None else top_p
        policy = policy.static
    dev = pred_input.device
    tp = size(group)
    spec = block_spec(cfg, tp)
    layers = layers if layers is not None else params["blocks"]
    if scratch is None:
        scratch = frame_scratch(cfg, B, pred_input.dtype, dev, tp)
    kv = scratch["kv"]

    def sample(logits):
        return sample_logits(generator, logits, temperature=temperature,
                             top_k=policy.top_k, top_p=top_p, use_top_p=policy.use_top_p,
                             do_sample=policy.do_sample)

    # prefill: 2 tokens, local [B, 2, 2] mask
    h = _proj(params, pred_input)
    pre = scratch["prefill"]
    h, kv = stack_forward(layers, h, pre["cos"], pre["sin"], kv, 0, pre["mask"], spec,
                          group=group)
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    tok = sample(_lm_logits(params, 0, h[:, -1, :], group))
    toks = [tok]

    if micro_kernel:
        w = micro_weights if micro_weights is not None else micro_step_weights(params)
        kk, vv = kv["k"], kv["v"]  # [L, B, S, KVH, D], written in place
        for cb, st in enumerate(scratch["steps"], start=1):
            h, kk, vv = fused_micro_step(w, codec_rows(params, cb - 1, tok),
                                         st["cos"][0, 0], st["sin"][0, 0], kk, vv, st["pos"],
                                         eps=cfg.rms_norm_eps)
            tok = sample(_lm_logits(params, cb, h))
            toks.append(tok)
        tokens = torch.stack(toks, dim=1)  # [B, 15]
        return tokens, embed_sum_for(params, tokens, pred_input.dtype)

    for cb, st in enumerate(scratch["steps"], start=1):
        x = _proj(params, _codec_embed(params, cb - 1, tok, group))[:, None, :]
        x, kv = stack_forward(layers, x, st["cos"], st["sin"], kv, cb + 1, st["mask"], spec,
                              fused=fused, group=group)
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        tok = sample(_lm_logits(params, cb, x[:, -1, :], group))
        toks.append(tok)

    tokens = torch.stack(toks, dim=1)  # [B, 15]
    return tokens, embed_sum_for(params, tokens, pred_input.dtype, group)


@torch.inference_mode()
def predict_frame_teacher(
    params: Params,
    cfg: PredictorConfig,
    pred_input: torch.Tensor,  # [B, 2, H_talker] = cat(past_hidden, token0_embed)
    teacher: torch.Tensor,  # [B, 15] int: the forced codebook tokens 1..15
) -> torch.Tensor:
    """Teacher-forced frame: the 15-codebook loop fed the GIVEN tokens in
    place of samples, returning every head's raw logits [B, 15, CB]
    float32 (head ``i`` predicts ``teacher[:, i]``).  Port of the JAX
    package's ``predict_frame_teacher``: with the same token history, two
    models' per-step logit deltas isolate their numeric difference (e.g.
    quantization).  Eager, on a fresh 17-slot cache; no sampling."""
    B, dev = pred_input.shape[0], pred_input.device
    spec, S = block_spec(cfg), cfg.max_seq
    kv = init_kv_cache(spec, B, S, pred_input.dtype, dev)
    zero_pad = torch.zeros((B,), dtype=torch.int32, device=dev)
    layers = params["blocks"]
    h = _proj(params, pred_input)
    cos, sin = _rope(cfg, torch.arange(2, device=dev).expand(B, 2))
    h, kv = stack_forward(layers, h, cos, sin, kv, 0,
                          prefill_mask(2, 2, zero_pad, cfg.sliding_window), spec)
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    logits = [_lm_logits(params, 0, h[:, -1, :])]
    teacher = teacher.long()
    for cb in range(1, cfg.num_codebooks):
        x = _proj(params, codec_rows(params, cb - 1, teacher[:, cb - 1]))[:, None, :]
        pos = cb + 1
        cos, sin = _rope(cfg, torch.full((B, 1), pos, dtype=torch.long, device=dev))
        x, kv = stack_forward(layers, x, cos, sin, kv, pos,
                              decode_mask(S, pos, zero_pad, cfg.sliding_window), spec)
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        logits.append(_lm_logits(params, cb, x[:, -1, :]))
    return torch.stack(logits, dim=1)


def embed_sum_for(params: Params, tokens: torch.Tensor, dtype, group=None) -> torch.Tensor:
    """sum_i codec_embeddings[i][tokens_i] for a [B, 15] frame, summed in
    float32 -> [B, 1, H_talker] in ``dtype``.  With a ``group``, this
    rank's rows summed, then all-reduced once."""
    cb = torch.arange(params["codec_embeddings"].shape[0], device=tokens.device)
    s = codec_rows(params, cb[None, :], tokens, group).float().sum(dim=1)  # [B, Ht]
    return (s if group is None else all_reduce(s, group)).to(dtype)[:, None, :]
