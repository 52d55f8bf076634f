"""Batch-1 decode runtime: prefill, the fused frame step, chunks, and the
chunk + streaming-vocode pairing.

Port of ``qwen3tts_tpu/runtime/engine.py``.  Where the JAX engine compiles
fixed-shape programs and donates a KV pytree, this one runs eager PyTorch.
Each request takes its own KV cache (``new_kv``) and hands it back when its
generation ends (``release``, as the JAX engine does) to a pool of one: a
live request never shares its cache, and requests that run one after
another reuse one cache without allocating.

All per-step state (position, counters, seen mask, done flags) lives in
device tensors, and the cache is written at the device-side position with
``index_copy_``, so a chunk of steps runs without any host sync; the host
reads results once per chunk.  The host tracks the position itself (prefill
length plus steps) to cap a chunk at ``max_seq_len - 1``.  The step's parts
are named ranges for ``torch.profiler``: ``predictor_frame``,
``talker_step`` and ``codec_stream``.

At batch 1 the JAX engine's bucket padding plus cache roll equals an
unpadded prefill with pad 0 and ``pos = T``, which is what runs here;
``bucket_for`` still rejects prompts longer than the largest bucket.

Options as in the JAX engine: ``use_fused_kernels`` (default off) runs the
talker's decode step and the predictor's 14 micro-steps through the fused
block kernels (``ops/fused_block.py``); ``kv_quant`` keeps the talker's KV
cache in int8 with f32 per-(slot, head) scales, read by the int8-KV
flash-decode kernel.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from ..core.config import TTSModelConfig
from ..models import codec as codec_lib
from ..models import predictor as predictor_lib
from ..models import talker as talker_lib
from ..models.layers import unstack_layers
from ..models.predictor import SamplingPolicy
from ..ops.sampling import apply_repetition_penalty, build_suppress_mask, sample_logits

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def bucket_for(n: int, buckets=PREFILL_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"Input is too long: prefill has {n} tokens but max bucket={buckets[-1]}. "
        "Use shorter text or shorter reference audio."
    )


@dataclasses.dataclass(frozen=True)
class GenerationPolicy:
    """Sampling policy for the talker's codebook-0 head."""

    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 1.0
    do_sample: bool = True
    repetition_penalty: float = 1.05
    min_new_tokens: int = 2


class Engine:
    """Eager runtime for one (talker, predictor) model instance at batch 1."""

    def __init__(
        self,
        talker_params,
        predictor_params,
        cfg: TTSModelConfig,
        *,
        max_seq_len: int = 2048,
        use_fused_kernels: Optional[bool] = None,
        kv_quant: bool = False,
    ):
        self.cfg = cfg
        self.talker_cfg = cfg.talker
        self.pred_cfg = cfg.predictor
        self.talker_params = talker_params
        self.predictor_params = predictor_params
        self.max_seq_len = max_seq_len
        self.batch = 1
        emb = talker_params["codec_embedding"]
        self.device = emb.device
        self.dtype = emb.dtype
        self.eos_id = cfg.talker.codec_eos_token_id
        tc = cfg.talker
        # the flash wrapper takes its plain version on CPU tensors; on the
        # card it launches the kernel, or raises for a head layout it lacks
        self.use_flash_decode = True
        # off unless asked for, as in the JAX engine (engine.py:142-153)
        self.use_fused_kernels = bool(use_fused_kernels)
        self.kv_quant = kv_quant
        self._talker_layers = unstack_layers(talker_params["blocks"])
        self._pred_layers = unstack_layers(predictor_params["blocks"])
        self._suppress = torch.from_numpy(
            build_suppress_mask(tc.vocab_size, self.eos_id)).to(self.device)
        # a finished generation's cache, handed to the next prefill (stale
        # rows are never read: every read is bounded to the live prefix)
        self._kv_pool = []
        self._kv_lock = threading.Lock()

    def new_kv(self) -> Dict[str, torch.Tensor]:
        """A KV cache [L, B, S, KVH, D] (int8 plus scales with ``kv_quant``)
        that no live request holds: the pooled one, or a new one."""
        with self._kv_lock:
            if self._kv_pool:
                return self._kv_pool.pop()
        return talker_lib.new_kv_cache(
            self.talker_cfg, self.batch, self.max_seq_len, self.dtype, self.device,
            kv_quant=self.kv_quant)

    def release(self, state: Dict) -> None:
        """Recycle a finished generation's KV cache into the pool (of one)."""
        with self._kv_lock:
            if state and "kv" in state and not self._kv_pool:
                self._kv_pool.append(state["kv"])

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, embeds, generator: Optional[torch.Generator],
                policy: GenerationPolicy,
                pred_policy: SamplingPolicy = SamplingPolicy()) -> Dict:
        """Run the prompt [1, T, H] (numpy or tensor) into the cache and sample
        the first token.  Returns the decode state."""
        embeds = torch.as_tensor(embeds).to(self.device, self.dtype)
        B, T, _ = embeds.shape
        if B != self.batch:
            raise ValueError(f"engine batch {self.batch} got prompt batch {B}")
        if bucket_for(T) > self.max_seq_len:
            raise ValueError(f"prefill bucket {bucket_for(T)} exceeds max_seq_len "
                             f"{self.max_seq_len}")
        dev = self.device
        pad = torch.zeros((B,), dtype=torch.int32, device=dev)
        last, logits, kv = talker_lib.prefill(
            self.talker_params, self.talker_cfg, embeds, pad, self.new_kv(),
            layers=self._talker_layers)
        token = sample_logits(
            generator, logits, temperature=policy.temperature, top_k=policy.top_k,
            top_p=policy.top_p, do_sample=policy.do_sample,
            suppress_mask=self._suppress,
            suppress_eos=torch.full((B,), policy.min_new_tokens > 0, device=dev),
            eos_id=self.eos_id)
        return {
            "kv": kv,
            "past_hidden": last,
            "token": token,
            "pos": torch.full((1,), T, dtype=torch.int32, device=dev),
            "pos_host": T,
            "pad_count": pad,
            "gen_step": torch.zeros((B,), dtype=torch.int64, device=dev),
            "seen": torch.zeros((B, self.talker_cfg.vocab_size), dtype=torch.bool,
                                device=dev),
            "n_gen": torch.zeros((B,), dtype=torch.int64, device=dev),
            "done": token == self.eos_id,
            "generator": generator,
            "policy": policy,
            "pred_policy": pred_policy,
        }

    # ------------------------------------------------------------------
    def _one_step(self, state: Dict, tth: torch.Tensor, tth_len: int,
                  tpe: torch.Tensor) -> torch.Tensor:
        """One frame step, updating ``state`` in place: predictor frame,
        talker decode step, repetition penalty, sampling.  Returns the frame
        [B, 16] (input token + 15 predictor codebooks).  No host sync."""
        tcfg = self.talker_cfg
        policy: GenerationPolicy = state["policy"]
        gen = state["generator"]
        token = state["token"]
        B = token.shape[0]

        tok_embed = talker_lib.embed_codec(self.talker_params, token)[:, None, :]
        pred_input = torch.cat([state["past_hidden"], tok_embed], dim=1)
        with record_function("predictor_frame"):
            cb_tokens, cb_embed_sum = predictor_lib.predict_frame(
                self.predictor_params, self.pred_cfg, pred_input, gen,
                state["pred_policy"], layers=self._pred_layers,
                fused=self.use_fused_kernels)
        frame = torch.cat([token[:, None], cb_tokens], dim=1)  # [B, 16]

        # next talker input = sum of the 16 codec embeds + trailing text hidden
        x = tok_embed + cb_embed_sum.to(tok_embed.dtype)
        gs = state["gen_step"]
        idx = gs.clamp_max(tth.shape[1] - 1)
        row_tth = tth[torch.arange(B, device=self.device), idx][:, None, :]
        x = x + torch.where((gs < tth_len)[:, None, None], row_tth, tpe)

        with record_function("talker_step"):
            hidden, _ = talker_lib.decode_step(
                self.talker_params, tcfg, x, state["pos"], state["pad_count"],
                state["kv"], use_flash=self.use_flash_decode, layers=self._talker_layers,
                fused=self.use_fused_kernels)
            logits = talker_lib.codec_head(self.talker_params, hidden[:, 0, :])

        seen = state["seen"]
        seen[torch.arange(B, device=self.device), token] = True
        if policy.repetition_penalty != 1.0:
            logits = apply_repetition_penalty(logits, seen, policy.repetition_penalty)
        n_gen = state["n_gen"] + 1
        next_token = sample_logits(
            gen, logits, temperature=policy.temperature, top_k=policy.top_k,
            top_p=policy.top_p, do_sample=policy.do_sample,
            suppress_mask=self._suppress,
            suppress_eos=n_gen < policy.min_new_tokens, eos_id=self.eos_id)

        state["past_hidden"] = hidden
        state["token"] = next_token
        state["pos"] += 1
        state["pos_host"] += 1
        state["gen_step"] = gs + 1
        state["n_gen"] = n_gen
        state["done"] = state["done"] | (next_token == self.eos_id)
        return frame

    @staticmethod
    def _tth(tth: torch.Tensor, tpe: torch.Tensor) -> torch.Tensor:
        """An empty trailing text falls back to the tts_pad embedding."""
        return tth if tth.shape[1] else tpe

    @torch.inference_mode()
    def decode_chunk(self, state: Dict, tth, tth_len: int, tpe, chunk_size: int):
        """Run up to ``chunk_size`` steps (fewer when the cache would fill).
        Returns (state, frames [B, chunk_size, 16], n_steps, lens [B], done [B])
        — frames/lens/done are device tensors.  ``lens[b]`` counts row b's
        valid frames: a row freezes at its EOS, and the frames after it are
        dropped by the caller."""
        steps = max(0, min(chunk_size, self.max_seq_len - 1 - state["pos_host"]))
        B = self.batch
        frames = torch.zeros((B, chunk_size, 16), dtype=torch.int64, device=self.device)
        lens = torch.zeros((B,), dtype=torch.int64, device=self.device)
        tth = self._tth(tth, tpe)
        for i in range(steps):
            live = ~state["done"]
            frames[:, i] = self._one_step(state, tth, tth_len, tpe)
            lens += live
        return state, frames, steps, lens, state["done"]

    def at_limit(self, state: Dict) -> bool:
        return state["pos_host"] >= self.max_seq_len - 1

    @torch.inference_mode()
    def chunk_vocode(self, vocoder, state: Dict, tth, tth_len: int, tpe,
                     chunk_size: int, voc_state: Dict, pcm16: bool = False):
        """decode_chunk, then the chunk's frames through the streaming codec.
        Returns (state, frames, n_steps, lens, done, audio [n_steps*spf],
        voc_state').  With ``pcm16`` the audio is int16 PCM.  Frames after an
        EOS enter the codec stream only in the final chunk, where the stream
        ends."""
        state, frames, n, lens, done = self.decode_chunk(
            state, tth, tth_len, tpe, chunk_size)
        if n == 0:
            audio = torch.zeros((0,), dtype=torch.float32, device=self.device)
        else:
            with record_function("codec_stream"):
                audio, voc_state = codec_lib.decode_stream(
                    vocoder.params, vocoder.cfg, voc_state, frames[:1, :n])
            audio = audio[0]
        if pcm16:
            audio = torch.clamp(torch.round(audio * 32767.0), -32768.0, 32767.0
                                ).to(torch.int16)
        return state, frames, n, lens, done, audio, voc_state
