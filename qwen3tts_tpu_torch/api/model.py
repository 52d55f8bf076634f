"""FasterQwen3TTS — the public API class of the PyTorch port.

Port of ``qwen3tts_tpu/api/model.py``:
``from_pretrained("random:<preset>" or a checkpoint dir, device=...,
dtype=...)`` and ``save_pretrained(dir)`` (the canonical checkpoint layout
both packages read, ``core/loader.py``); voice clone
from an x-vector or, with ``xvec_only=False``, in-context from the
reference's codec codes and transcript (``generate_voice_clone[_streaming]``,
``create_voice_clone_prompt``); the predefined speakers of a custom-voice
model (``generate_custom_voice[_streaming]``); instruction-conditioned voice
design (``generate_voice_design[_streaming]``); and ``parity_mode=True``,
the per-step loop of ``runtime/loops.py``; and batched voice clone
(``generate_voice_clone_batch``: several texts in one voice, one engine
pass on an ``Engine(batch=B)`` per batch size, built when first asked for).
Signatures, defaults and guards are the JAX class's, including
``quantize="int8" | "int8-talker" | "int8-predictor"`` (int8 weight-only),
``"w8a8" | "w8a8-talker" | "w8a8-predictor"`` (int8 activations and
weights: ``ops/w8a8.py``, hand-written kernels on the card) and
``kv_quant=True`` (int8 KV cache).

An ICL prompt carries the reference's codec frames: the non-streamed audio
is the decode of reference + generated frames with the reference's samples
cut off, and the streamed audio comes from a codec stream primed with the
reference frames, which gives the same samples.

As the JAX class compiles its decode programs before its first generation
(``_warmup``), this one captures them: the first request's
``Engine.warmup`` captures the chunk graphs (decode, and decode + vocode)
at chunk sizes 8 and 16, or the streaming request's own, for the request's
trailing-text bucket; a later request with another bucket or chunk size
captures its graph when it first needs it.  ``warmup_all`` captures every
bucket up front.  On the CPU nothing is captured.  With
``QWEN3TTS_PROFILE_DIR`` set, a generation is traced by ``torch.profiler``
and runs its chunks eagerly (``Engine.eager``): the profiler is never
active around a graph replay.

While the tracer is on (``utils/timing.py:TRACE``) each generation call is
one request (``one_request``), with spans ``prompt`` (the prompt build),
``warmup`` (the capture check and any capture) and ``vocode`` (a full codec
decode after a non-streamed generation, one a row in a batch), beside the
loops' own.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import os
from pathlib import Path
from typing import Dict, Generator, Optional, Tuple, Union

import numpy as np
import torch

from ..audio.vocoder import Vocoder
from ..audio.wav import read_wav, resample
from ..core.config import DTYPES, TTSModelConfig
from ..core.loader import (bundle_to_jax_layout, load_pretrained, resolve_device,
                           save_checkpoint)
from ..models import speaker as speaker_lib
from ..models.predictor import SamplingPolicy
from ..ops.quant import quantize_bundle
from ..runtime import loops
from ..runtime.engine import Engine, GenerationPolicy, bucket_for
from ..utils.timing import TRACE, device_trace, one_request
from .prompt import PromptBuilder
from .tokenizer import TextTokenizer

logger = logging.getLogger(__name__)


def _infer_sample_rate(codec_cfg, model_cfg) -> int:
    """Sample-rate inference chain: speech-tokenizer rate -> model-level
    rate -> 24000 default (with a warning)."""
    sr = getattr(codec_cfg, "sample_rate", None)
    if sr is None:
        sr = getattr(model_cfg, "sample_rate", None)
    if sr is None:
        logger.warning("Could not infer sample rate; defaulting to 24000 Hz.")
        return 24_000
    return int(sr)


class FasterQwen3TTS:
    """Qwen3-TTS voice clone on PyTorch (captured decode chunks on the
    card)."""

    def __init__(self, cfg: TTSModelConfig, params: Dict, *, max_seq_len: int = 2048,
                 seed: int = 0, tokenizer_json: Optional[str] = None,
                 vocoder_compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 kv_quant: bool = False):
        self.cfg = cfg
        self.params = params
        self.max_seq_len = max_seq_len
        self.device = params["talker"]["codec_embedding"].device
        self.dtype = cfg.torch_dtype
        self.kv_quant = kv_quant
        self.engine = Engine(params["talker"], params["predictor"], cfg,
                             max_seq_len=max_seq_len, kv_quant=kv_quant)
        self._batch_engines: Dict[int, Engine] = {}
        self.vocoder = Vocoder(params["codec"], cfg.codec,
                               compute_dtype=vocoder_compute_dtype)
        self.prompt_builder = PromptBuilder(params["talker"], params["predictor"], cfg)
        self.tokenizer = TextTokenizer(tokenizer_json=tokenizer_json,
                                       vocab_size=cfg.talker.text_vocab_size)
        self.sample_rate = _infer_sample_rate(cfg.codec, cfg)
        self._voice_prompt_cache: Dict = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.tts_model_type = cfg.model_type
        self.tts_model_size = cfg.model_size

    @classmethod
    def from_pretrained(cls, model_name: str, device: Union[str, torch.device, None] = None,
                        dtype: Union[str, torch.dtype, None] = None,
                        max_seq_len: int = 2048, seed: int = 0,
                        quantize: Optional[str] = None,
                        kv_quant: bool = False) -> "FasterQwen3TTS":
        """Build a model from 'random:<preset>' or a checkpoint dir (either
        layout, ``core/loader.py:load_checkpoint``) on ``device`` (default:
        the card; with no card, pass ``device="cpu"`` or it raises).
        ``dtype`` names the talker/predictor dtype ("bfloat16", "float32",
        ...; a checkpoint's own by default); the codec and speaker encoder
        stay float32, and the codec computes in bfloat16.  A checkpoint
        dir's ``tokenizer.json`` feeds the text tokenizer (the
        ``tokenizers`` package is imported only then); without one the
        byte-level fallback is used, with a warning.

        ``quantize`` stores the talker/predictor projection matrices (and
        the predictor's lm_heads) as int8 with per-channel scales: "int8"
        (weight-only) or "w8a8" (activations quantized per row too, the
        int8 products summed exactly; the lm_heads stay weight-only) for
        both, "<mode>-talker" or "<mode>-predictor" for one; unknown modes
        raise ValueError.  ``kv_quant=True`` keeps the talker's KV cache in
        int8."""
        device = resolve_device(device)
        if isinstance(dtype, str):
            dtype = DTYPES[dtype]
        cfg, params = load_pretrained(model_name, dtype=dtype, seed=seed, device=device)
        tokenizer_json = None
        ckpt_dir = Path(model_name)
        if ckpt_dir.is_dir():
            tok = ckpt_dir / "tokenizer.json"
            if tok.exists():
                tokenizer_json = str(tok)
            else:
                logger.warning(
                    "Checkpoint %s has no tokenizer.json — falling back to the "
                    "byte-level tokenizer, whose token ids will NOT match the "
                    "Qwen text vocab. Place the upstream tokenizer.json in the "
                    "checkpoint dir for correct text conditioning.", model_name)
        if quantize:
            params = quantize_bundle(params, quantize)
        logger.info("Loaded %s (%s, %s%s) on %s", model_name, cfg.model_type, cfg.dtype,
                    f", {quantize}" if quantize else "", device)
        return cls(cfg, params, max_seq_len=max_seq_len, seed=seed,
                   tokenizer_json=tokenizer_json, kv_quant=kv_quant)

    def save_pretrained(self, path: Union[str, Path]) -> None:
        """Write the model as a canonical checkpoint dir (config.json +
        model.safetensors in the JAX pytree's layout), which this package's
        and the JAX package's ``from_pretrained`` both load."""
        save_checkpoint(path, self.cfg, bundle_to_jax_layout(self.params))

    # ------------------------------------------------------------------
    # voice-clone prompt
    # ------------------------------------------------------------------

    def _load_ref_audio_with_silence(self, ref_audio: Union[str, Path],
                                     silence_secs: float = 0.5) -> Tuple[np.ndarray, int]:
        """Reference audio (mono) with trailing silence appended, so that an
        ICL prompt ends on silence rather than mid-phoneme."""
        audio, sr = read_wav(ref_audio)
        if silence_secs > 0:
            audio = np.concatenate([audio, np.zeros(int(silence_secs * sr), np.float32)])
        return audio, sr

    @torch.inference_mode()
    def extract_speaker_embedding(self, ref_audio: Union[str, Path, np.ndarray],
                                  sr: Optional[int] = None) -> np.ndarray:
        """x-vector from reference audio."""
        if isinstance(ref_audio, (str, Path)):
            audio, sr = read_wav(ref_audio)
        else:
            if sr is None:
                raise ValueError("sr is required with raw audio")
            audio = np.asarray(ref_audio, np.float32)
        audio16 = resample(audio, sr, self.cfg.speaker_encoder.sample_rate)
        wav = torch.from_numpy(np.ascontiguousarray(audio16, np.float32)).to(self.device)
        emb = speaker_lib.embed(self.params["speaker"], self.cfg.speaker_encoder, wav)
        return emb.float().cpu().numpy()

    def create_voice_clone_prompt(
        self,
        ref_audio: Union[str, Path, Tuple[np.ndarray, int]],
        ref_text: str = "",
        x_vector_only_mode: bool = False,
    ) -> Dict:
        """{'ref_spk_embedding', 'ref_code' ([Tr, 16] codec codes, ICL only),
        'x_vector_only_mode', 'icl_mode', 'ref_text'}."""
        if isinstance(ref_audio, tuple):
            audio, sr = ref_audio
        else:
            audio, sr = read_wav(ref_audio)
        out = {
            "ref_spk_embedding": self.extract_speaker_embedding(audio, sr),
            "ref_code": None,
            "x_vector_only_mode": x_vector_only_mode,
            "icl_mode": not x_vector_only_mode,
            "ref_text": ref_text,
        }
        if not x_vector_only_mode:
            out["ref_code"] = self.vocoder.encode(resample(audio, sr, self.cfg.codec.sample_rate))
        return out

    def _voice_prompt(self, ref_audio, ref_text: str, xvec_only: bool,
                      append_silence: bool) -> Dict:
        """The voice prompt of a path or an in-memory ``(audio, sr)`` tuple,
        cached by (path or sha1 of the samples, ref_text, xvec_only,
        append_silence).  ICL appends 0.5 s of silence when asked."""
        if isinstance(ref_audio, tuple):
            audio, sr = ref_audio
            audio = np.asarray(audio, np.float32)
            ident = hashlib.sha1(audio.tobytes()).hexdigest()
        else:
            ident = str(ref_audio)
        key = (ident, ref_text, xvec_only, append_silence)
        if key in self._voice_prompt_cache:
            return self._voice_prompt_cache[key]
        if isinstance(ref_audio, tuple):
            if not xvec_only and append_silence:
                audio = np.concatenate([audio, np.zeros(int(0.5 * sr), np.float32)])
            vcp = self.create_voice_clone_prompt(
                (audio, sr), "" if xvec_only else ref_text, x_vector_only_mode=xvec_only)
        elif xvec_only:
            vcp = self.create_voice_clone_prompt(ref_audio, "", x_vector_only_mode=True)
        else:
            audio, sr = self._load_ref_audio_with_silence(
                ref_audio, 0.5 if append_silence else 0.0)
            vcp = self.create_voice_clone_prompt((audio, sr), ref_text)
        self._voice_prompt_cache[key] = vcp
        return vcp

    def _prepare_clone(self, text, ref_audio, ref_text, language, xvec_only,
                       non_streaming_mode, append_silence, instruct):
        """(talker_input_embeds, trailing, tts_pad_embed, ref_codes or None),
        host numpy float32: the loops upload them.  The ``prompt`` span."""
        with TRACE.span("prompt"):
            return self._clone_prompt(text, ref_audio, ref_text, language, xvec_only,
                                      non_streaming_mode, append_silence, instruct)

    def _clone_prompt(self, text, ref_audio, ref_text, language, xvec_only,
                      non_streaming_mode, append_silence, instruct):
        input_ids = self.tokenizer.build_assistant_ids(text)
        instruct_ids = self.tokenizer.build_instruct_ids(instruct) if instruct else None
        vcp = self._voice_prompt(ref_audio, ref_text, xvec_only, append_silence)
        spk = self.prompt_builder.project_speaker(vcp["ref_spk_embedding"])
        ref_ids = None
        if vcp["icl_mode"] and vcp.get("ref_text"):
            ref_ids = self.tokenizer.build_ref_ids(vcp["ref_text"])
        embeds, trailing, tpe = self.prompt_builder.build(
            input_ids=input_ids, ref_ids=ref_ids, spk_embedding=spk,
            ref_codes=vcp["ref_code"],
            icl_mode=vcp["icl_mode"] and vcp["ref_code"] is not None and ref_ids is not None,
            language=language, non_streaming_mode=non_streaming_mode,
            instruct_ids=instruct_ids)
        return embeds, trailing, tpe, (vcp["ref_code"] if not xvec_only else None)

    def _prepare_custom(self, text, language, speaker, instruct):
        with TRACE.span("prompt"):
            input_ids = self.tokenizer.build_assistant_ids(text)
            instruct_ids = self.tokenizer.build_instruct_ids(instruct) if instruct else None
            return self.prompt_builder.build(
                input_ids=input_ids, language=language, speaker=speaker,
                non_streaming_mode=False, instruct_ids=instruct_ids)

    def _policies(self, temperature, top_k, top_p, do_sample, repetition_penalty,
                  min_new_tokens):
        pol = GenerationPolicy(temperature=temperature, top_k=top_k, top_p=top_p,
                               do_sample=do_sample,
                               repetition_penalty=repetition_penalty,
                               min_new_tokens=min_new_tokens)
        # the predictor always samples at top_k 50 / temperature 0.9, as in
        # the JAX package: greedy decoding makes only codebook 0 greedy
        return pol, SamplingPolicy(do_sample=True, top_k=50, top_p=1.0, temperature=0.9)

    def _warmup(self, prefill_len: int, tth_len: int, policy, pred_policy,
                chunk_sizes=(8, 16)):
        """Capture the engine's chunk graphs before its first generation."""
        with TRACE.span("warmup"):
            if self.engine.warmed_up:
                return
            logger.info("Capturing the decode chunks as CUDA graphs (one-time)...")
            self.engine.warmup(prefill_len, tth_len, policy, pred_policy, chunk_sizes,
                               vocoder=self.vocoder)

    def warmup_all(self, chunk_sizes=(8, 16), max_prefill: Optional[int] = None) -> float:
        """Capture every (trailing-text bucket x chunk size) chunk graph,
        with and without the vocoder, so that no request captures
        mid-stream (servers call this at startup).  Returns seconds."""
        pol, ppol = self._policies(0.9, 50, 1.0, True, 1.05, 2)
        with TRACE.span("warmup"):
            dt = self.engine.warmup_all(pol, ppol, chunk_sizes, max_prefill=max_prefill,
                                        vocoder=self.vocoder)
        logger.info("warmup_all finished in %.1fs", dt)
        return dt

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def generate(self, *a, **k):
        raise NotImplementedError(
            "Default voice generation not yet implemented. "
            "Use generate_voice_clone() with reference audio."
        )

    def _finish_audio(self, codec_ids: Optional[np.ndarray], ref_codes, timing):
        """The waveform of the generated frames; after an ICL prompt, the
        decode of reference + generated frames with the reference's
        ``len(ref_codes) * spf`` samples cut off."""
        if codec_ids is None:
            logger.warning("Generation returned no tokens")
            return [np.zeros(1, np.float32)], self.sample_rate
        with TRACE.span("vocode"):
            wav = self._decode(codec_ids, ref_codes)
        dur = timing["steps"] / self.cfg.codec.frame_rate
        total = timing["prefill_ms"] / 1000 + timing["decode_s"]
        logger.info("Generated %.2fs audio in %.2fs (%.1fms/step, RTF: %.2f)", dur, total,
                    timing["ms_per_step"], dur / total if total > 0 else 0.0)
        return [wav], self.sample_rate

    def _decode(self, codec_ids: np.ndarray, ref_codes) -> np.ndarray:
        """The waveform of ``codec_ids``; after an ICL prompt the decode of
        reference + generated frames, the reference's samples cut off."""
        if ref_codes is not None and len(ref_codes):
            wav = self.vocoder.decode(np.concatenate([np.asarray(ref_codes), codec_ids]))
            return wav[len(ref_codes) * self.vocoder.spf:]
        return self.vocoder.decode(codec_ids)

    def _generate(self, embeds, trailing, tpe, ref_codes, pol, ppol, max_new_tokens,
                  parity_mode: bool = False):
        if not parity_mode:
            self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol)
        gen = loops.parity_generate if parity_mode else loops.fast_generate
        # QWEN3TTS_PROFILE_DIR: a torch.profiler trace of the generation,
        # whose chunks then run eagerly (no replay under the profiler: see
        # device_trace)
        profile_dir = os.environ.get("QWEN3TTS_PROFILE_DIR")
        with (self.engine.eager() if profile_dir else contextlib.nullcontext()), \
                device_trace(profile_dir):
            codec_ids, timing = gen(self.engine, embeds, trailing, tpe, generator=self._gen,
                                    max_new_tokens=max_new_tokens, policy=pol,
                                    pred_policy=ppol)
        return self._finish_audio(codec_ids, ref_codes, timing)

    @one_request
    def generate_voice_clone(
        self,
        text: str,
        language: str,
        ref_audio: Union[str, Path],
        ref_text: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        xvec_only: bool = True,
        non_streaming_mode: bool = True,
        append_silence: bool = True,
        instruct: Optional[str] = None,
        parity_mode: bool = False,
    ) -> Tuple[list, int]:
        """Voice-cloned speech.  Returns ([waveform float32], sample_rate).
        ``ref_text`` and ``append_silence`` matter only for ICL clone
        (``xvec_only=False``); ``parity_mode`` runs the per-step loop."""
        embeds, trailing, tpe, ref_codes = self._prepare_clone(
            text, ref_audio, ref_text, language, xvec_only, non_streaming_mode,
            append_silence, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        return self._generate(embeds, trailing, tpe, ref_codes, pol, ppol, max_new_tokens,
                              parity_mode)

    def _batch_engine(self, batch: int) -> Engine:
        """The engine of ``batch`` rows: ``self.engine`` at 1, else one per
        batch size on the same parameters, built at first use."""
        if batch == 1:
            return self.engine
        if batch not in self._batch_engines:
            self._batch_engines[batch] = Engine(
                self.params["talker"], self.params["predictor"], self.cfg,
                max_seq_len=self.max_seq_len, batch=batch, kv_quant=self.kv_quant)
        return self._batch_engines[batch]

    def _batch_prompt(self, texts, ref_audio, ref_text, language, xvec_only,
                      non_streaming_mode, append_silence, instruct):
        """The clone prompts of ``texts`` in one voice, stacked on the host
        at their common bucket width: (embeds [B, T, H] left-padded, trailing
        [B, Tt, H] padded with each row's tts_pad embedding, tpe [B, 1, H],
        pads [B], tth_lens [B], the reference's codes or None)."""
        with TRACE.span("prompt"):
            rows = [self._clone_prompt(t, ref_audio, ref_text, language, xvec_only,
                                       non_streaming_mode, append_silence, instruct)
                    for t in texts]
            B, H = len(rows), self.cfg.talker.hidden_size
            T = bucket_for(max(r[0].shape[1] for r in rows))
            Tt = max(max(r[1].shape[1] for r in rows), 1)
            embeds = np.zeros((B, T, H), np.float32)
            trailing = np.zeros((B, Tt, H), np.float32)
            tpe = np.zeros((B, 1, H), np.float32)
            pads = np.zeros((B,), np.int64)
            tth_lens = np.zeros((B,), np.int64)
            for b, (e, t, p, _) in enumerate(rows):
                pads[b] = T - e.shape[1]
                embeds[b, pads[b]:] = e[0]
                trailing[b, : t.shape[1]] = t[0]
                trailing[b, t.shape[1]:] = p[0]
                tth_lens[b] = t.shape[1]
                tpe[b] = p[0]
            return embeds, trailing, tpe, pads, tth_lens, rows[0][3]

    @one_request
    def generate_voice_clone_batch(
        self,
        texts: list,
        language: str,
        ref_audio: Union[str, Path],
        ref_text: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        xvec_only: bool = True,
        non_streaming_mode: bool = True,
        append_silence: bool = True,
        instruct: Optional[str] = None,
    ) -> Tuple[list, int]:
        """Voice-cloned speech for ``len(texts)`` texts in one voice, in one
        batched engine pass (each row ends at its own EOS).  Returns ([B]
        waveforms, sample_rate).  The prompts are stacked on the host,
        left-padded to their common bucket; each row's trailing text is
        padded with its tts_pad embedding.  After an ICL prompt each row is
        decoded after the reference's frames, whose samples are cut off."""
        if not texts:
            return [], self.sample_rate
        embeds, trailing, tpe, pads, tth_lens, ref_codes = self._batch_prompt(
            texts, ref_audio, ref_text, language, xvec_only, non_streaming_mode,
            append_silence, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        ids_rows, timing = loops.fast_generate_batch(
            self._batch_engine(len(texts)), embeds, trailing, tpe, generator=self._gen,
            pad_count=pads, tth_lens=tth_lens, max_new_tokens=max_new_tokens,
            policy=pol, pred_policy=ppol)
        wavs = []
        for ids in ids_rows:
            if ids.shape[0] == 0:
                wavs.append(np.zeros(1, np.float32))
                continue
            with TRACE.span("vocode"):
                wavs.append(self._decode(ids, ref_codes))
        audio_s = sum(len(w) for w in wavs) / self.sample_rate
        wall = timing["prefill_ms"] / 1000 + timing["decode_s"]
        logger.info("Batch %d: %.2fs audio in %.2fs (throughput RTF %.2f)", len(texts), audio_s,
                    wall, audio_s / wall if wall else 0.0)
        return wavs, self.sample_rate

    @one_request
    def generate_voice_clone_streaming(
        self,
        text: str,
        language: str,
        ref_audio: Union[str, Path],
        ref_text: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
        xvec_only: bool = True,
        non_streaming_mode: bool = True,
        append_silence: bool = True,
        parity_mode: bool = False,
        instruct: Optional[str] = None,
        first_chunks: Tuple[int, ...] = (),
    ) -> Generator[Tuple[np.ndarray, int, dict], None, None]:
        """Streaming voice clone: yields (audio_chunk, sr, timing) every
        ``chunk_size`` codec steps (``first_chunks`` ramps the first sizes)."""
        embeds, trailing, tpe, ref_codes = self._prepare_clone(
            text, ref_audio, ref_text, language, xvec_only, non_streaming_mode,
            append_silence, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        yield from self._stream_audio(embeds, trailing, tpe, ref_codes, pol, ppol,
                                      max_new_tokens, chunk_size, parity_mode, first_chunks)

    def _stream_audio(self, embeds, trailing, tpe, ref_codes, pol, ppol,
                      max_new_tokens, chunk_size, parity_mode=False, first_chunks=()):
        if not parity_mode:
            self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol,
                         chunk_sizes=tuple(dict.fromkeys(list(first_chunks) + [chunk_size])))
            for _codes, audio, timing in loops.fast_generate_streaming_audio(
                    self.engine, self.vocoder, embeds, trailing, tpe, generator=self._gen,
                    max_new_tokens=max_new_tokens, policy=pol, pred_policy=ppol,
                    chunk_size=chunk_size, first_chunks=first_chunks, ref_codes=ref_codes):
                yield audio, self.sample_rate, timing
            return
        sd = self.vocoder.stateful_stream_decoder()
        if ref_codes is not None and len(ref_codes):
            sd.feed(np.asarray(ref_codes))  # prime the codec's context, audio discarded
        for codec_chunk, timing in self._parity_stream(embeds, trailing, tpe, pol, ppol,
                                                       max_new_tokens, chunk_size):
            yield sd.feed(codec_chunk), self.sample_rate, timing

    def _parity_stream(self, embeds, trailing, tpe, pol, ppol, max_new_tokens, chunk_size):
        """The per-step parity loop, its chunks yielded as they are decoded."""
        yield from loops.parity_generate_streaming(
            self.engine, embeds, trailing, tpe, generator=self._gen,
            max_new_tokens=max_new_tokens, policy=pol, pred_policy=ppol,
            chunk_size=chunk_size)

    # ------------------------------------------------------------------
    # replication: one model per card behind a ReplicaPool
    # ------------------------------------------------------------------

    def replicate_to(self, device, seed: Optional[int] = None) -> "FasterQwen3TTS":
        """A full replica of the model on ``device`` (``runtime/replicas.py``).

        The parameters are copied there (a tensor already on ``device`` is
        shared: weights are read-only); the engine, the vocoder, the batch
        engines, the generator (seeded with ``seed``, else from the device's
        name) and the voice-prompt cache are the replica's own, so replicas
        share no mutable device state.  The config, tokenizer and prompt
        builder (host numpy) are shared."""
        device = torch.device(device)
        clone = object.__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.device = device
        clone.params = _tree_to(self.params, device)
        clone.engine = Engine(clone.params["talker"], clone.params["predictor"], self.cfg,
                              max_seq_len=self.max_seq_len, kv_quant=self.kv_quant)
        clone._batch_engines = {}
        # the vocoder's weights are already cast to its compute dtype
        clone.vocoder = Vocoder(_tree_to(self.vocoder.params, device), self.cfg.codec,
                                compute_dtype=None)
        clone._voice_prompt_cache = {}
        clone._gen = torch.Generator(device=device).manual_seed(
            seed if seed is not None else int(hashlib.sha1(str(device).encode()).hexdigest(),
                                              16) % 2**31)
        return clone

    # ------------------------------------------------------------------
    # custom voice / voice design
    # ------------------------------------------------------------------

    def _validate_languages(self, languages):
        for lg in languages:
            if lg and lg.lower() != "auto" and lg.lower() not in self.cfg.talker.codec_language_id:
                raise NotImplementedError(f"Language {lg} not implemented")

    def _validate_speakers(self, speakers):
        for sp in speakers:
            if sp and sp.lower() not in self.cfg.talker.spk_id:
                raise NotImplementedError(f"Speaker {sp} not implemented")

    def _custom_prompt(self, text, speaker, language, instruct):
        if self.tts_model_type != "custom_voice":
            raise ValueError("Loaded model does not support custom voice generation")
        self._validate_languages([language])
        self._validate_speakers([speaker])
        if self.tts_model_size == "0.6b":  # the 0.6B custom-voice model takes no instruct
            instruct = None
        return self._prepare_custom(text, language, speaker, instruct)

    def _design_prompt(self, text, instruct, language):
        if self.tts_model_type != "voice_design":
            raise ValueError("Loaded model does not support voice design generation")
        self._validate_languages([language])
        return self._prepare_custom(text, language, None, instruct)

    @one_request
    def generate_custom_voice(
        self,
        text: str,
        speaker: str,
        language: str,
        instruct: Optional[str] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
    ) -> Tuple[list, int]:
        """Speech in one of a custom-voice model's predefined speakers."""
        prompt = self._custom_prompt(text, speaker, language, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        return self._generate(*prompt, None, pol, ppol, max_new_tokens)

    @one_request
    def generate_custom_voice_streaming(
        self,
        text: str,
        speaker: str,
        language: str,
        instruct: Optional[str] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
    ) -> Generator[Tuple[np.ndarray, int, dict], None, None]:
        prompt = self._custom_prompt(text, speaker, language, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        yield from self._stream_audio(*prompt, None, pol, ppol, max_new_tokens, chunk_size)

    @one_request
    def generate_voice_design(
        self,
        text: str,
        instruct: str,
        language: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
    ) -> Tuple[list, int]:
        """Speech in a voice described by ``instruct`` (voice-design model)."""
        prompt = self._design_prompt(text, instruct, language)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        return self._generate(*prompt, None, pol, ppol, max_new_tokens)

    @one_request
    def generate_voice_design_streaming(
        self,
        text: str,
        instruct: str,
        language: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
    ) -> Generator[Tuple[np.ndarray, int, dict], None, None]:
        prompt = self._design_prompt(text, instruct, language)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        yield from self._stream_audio(*prompt, None, pol, ppol, max_new_tokens, chunk_size)


def _tree_to(tree, device: torch.device):
    """A nested dict / list of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
