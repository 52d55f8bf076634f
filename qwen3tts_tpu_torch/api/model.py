"""FasterQwen3TTS — the public API class of the PyTorch port.

Port of ``qwen3tts_tpu/api/model.py`` for x-vector voice clone:
``from_pretrained("random:<preset>", device=..., dtype=...)``,
``generate_voice_clone`` and ``generate_voice_clone_streaming`` with the JAX
class's signatures and defaults, including ``quantize="int8" |
"int8-talker" | "int8-predictor"`` (int8 weight-only) and ``kv_quant=True``
(int8 KV cache).  ICL clone (``xvec_only=False``), custom voice, voice
design, batching, the parity loops and the w8a8 modes are not ported yet.

As the JAX class compiles its decode programs before its first generation
(``_warmup``), this one captures them: the first request's
``Engine.warmup`` captures the chunk graphs (decode, and decode + vocode)
at chunk sizes 8 and 16, or the streaming request's own, for the request's
trailing-text bucket; a later request with another bucket or chunk size
captures its graph when it first needs it.  ``warmup_all`` captures every
bucket up front.  On the CPU nothing is captured.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Generator, Optional, Tuple, Union

import numpy as np
import torch

from ..audio.vocoder import Vocoder
from ..audio.wav import read_wav, resample
from ..core.config import DTYPES, TTSModelConfig
from ..core.loader import load_pretrained, resolve_device
from ..models import speaker as speaker_lib
from ..models.predictor import SamplingPolicy
from ..ops.quant import quantize_bundle
from ..runtime import loops
from ..runtime.engine import Engine, GenerationPolicy
from .prompt import PromptBuilder
from .tokenizer import TextTokenizer

logger = logging.getLogger(__name__)


class FasterQwen3TTS:
    """Qwen3-TTS voice clone on PyTorch (captured decode chunks on the card,
    batch 1)."""

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
        self.vocoder = Vocoder(params["codec"], cfg.codec,
                               compute_dtype=vocoder_compute_dtype)
        self.prompt_builder = PromptBuilder(params["talker"], params["predictor"], cfg)
        self.tokenizer = TextTokenizer(tokenizer_json=tokenizer_json,
                                       vocab_size=cfg.talker.text_vocab_size)
        self.sample_rate = int(getattr(cfg.codec, "sample_rate", None) or cfg.sample_rate)
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
        """Build a model from 'random:<preset>' on ``device`` (default: the
        card; with no card, pass ``device="cpu"`` or it raises).  ``dtype`` names the talker/predictor dtype
        ("bfloat16", "float32", ...); the codec and speaker encoder stay
        float32, and the codec computes in bfloat16.

        ``quantize`` stores the talker/predictor projection matrices (and
        the predictor's lm_heads) as int8 with per-channel scales: "int8"
        both, "int8-talker" or "int8-predictor" one; the w8a8 modes raise
        NotImplementedError, unknown modes ValueError.  ``kv_quant=True``
        keeps the talker's KV cache in int8."""
        device = resolve_device(device)
        if isinstance(dtype, str):
            dtype = DTYPES[dtype]
        cfg, params = load_pretrained(model_name, dtype=dtype, seed=seed, device=device)
        if quantize:
            params = quantize_bundle(params, quantize)
        logger.info("Loaded %s (%s, %s%s) on %s", model_name, cfg.model_type, cfg.dtype,
                    f", {quantize}" if quantize else "", device)
        return cls(cfg, params, max_seq_len=max_seq_len, seed=seed, kv_quant=kv_quant)

    # ------------------------------------------------------------------
    # voice-clone prompt
    # ------------------------------------------------------------------

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

    def _voice_prompt(self, ref_audio, xvec_only: bool) -> Dict:
        if not xvec_only:
            raise NotImplementedError(
                "ICL voice clone (xvec_only=False) needs codec.encode, which the "
                "PyTorch port does not have yet")
        if isinstance(ref_audio, tuple):
            import hashlib

            audio, sr = ref_audio
            audio = np.asarray(audio, np.float32)
            key = hashlib.sha1(audio.tobytes()).hexdigest()
        else:
            key = str(ref_audio)
        if key not in self._voice_prompt_cache:
            if isinstance(ref_audio, tuple):
                xvec = self.extract_speaker_embedding(audio, sr)
            else:
                xvec = self.extract_speaker_embedding(ref_audio)
            self._voice_prompt_cache[key] = {"ref_spk_embedding": xvec}
        return self._voice_prompt_cache[key]

    def _prepare_clone(self, text, ref_audio, language, xvec_only, non_streaming_mode,
                       instruct):
        input_ids = self.tokenizer.build_assistant_ids(text)
        instruct_ids = self.tokenizer.build_instruct_ids(instruct) if instruct else None
        vcp = self._voice_prompt(ref_audio, xvec_only)
        spk = self.prompt_builder.project_speaker(vcp["ref_spk_embedding"])
        return self.prompt_builder.build(
            input_ids=input_ids, spk_embedding=spk, language=language,
            non_streaming_mode=non_streaming_mode, instruct_ids=instruct_ids)

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
        dt = self.engine.warmup_all(pol, ppol, chunk_sizes, max_prefill=max_prefill,
                                    vocoder=self.vocoder)
        logger.info("warmup_all finished in %.1fs", dt)
        return dt

    @staticmethod
    def _unsupported(parity_mode: bool):
        if parity_mode:
            raise NotImplementedError("parity_mode is not ported to PyTorch yet")

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

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
        ``ref_text`` and ``append_silence`` matter only for ICL clone."""
        self._unsupported(parity_mode)
        embeds, trailing, tpe = self._prepare_clone(
            text, ref_audio, language, xvec_only, non_streaming_mode, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol)
        codec_ids, timing = loops.fast_generate(
            self.engine, embeds, trailing, tpe, generator=self._gen,
            max_new_tokens=max_new_tokens, policy=pol, pred_policy=ppol)
        if codec_ids is None:
            logger.warning("Generation returned no tokens")
            return [np.zeros(1, np.float32)], self.sample_rate
        wav = self.vocoder.decode(codec_ids)
        dur = timing["steps"] / self.cfg.codec.frame_rate
        total = timing["prefill_ms"] / 1000 + timing["decode_s"]
        logger.info("Generated %.2fs audio in %.2fs (%.1fms/step, RTF: %.2f)", dur, total,
                    timing["ms_per_step"], dur / total if total > 0 else 0.0)
        return [wav], self.sample_rate

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
        self._unsupported(parity_mode)
        embeds, trailing, tpe = self._prepare_clone(
            text, ref_audio, language, xvec_only, non_streaming_mode, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol,
                     chunk_sizes=tuple(dict.fromkeys(list(first_chunks) + [chunk_size])))
        for _codes, audio, timing in loops.fast_generate_streaming_audio(
                self.engine, self.vocoder, embeds, trailing, tpe, generator=self._gen,
                max_new_tokens=max_new_tokens, policy=pol, pred_policy=ppol,
                chunk_size=chunk_size, first_chunks=first_chunks):
            yield audio, self.sample_rate, timing
