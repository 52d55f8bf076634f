"""Audio-fidelity metrics and the quantization quality gate.

Port of ``qwen3tts_tpu/utils/quality.py``.  What the int8, w8a8 and
kv_quant modes cost in quality, measured with random weights today and
re-runnable on real ones:

  - ``waveform_snr_db`` / ``log_mel_distance``: the quantized model's audio
    against the reference model's at the same seed;
  - ``token_agreement``: how far quantization moves the decode decisions
    (exact-match rate over the [steps, 16] codec ids, and the first step
    where codebook 0 diverges);
  - ``teacher_forced_quality``: both models over the SAME code history,
    per-step logit MSE and argmax-flip rate of the talker and predictor
    heads, and the vocoder's SNR on identical codes (the fidelity claim: one
    flipped token cannot cascade);
  - ``quant_quality``: the whole A/B, free-running and teacher-forced.

The metrics are numpy on the host (a copy of the JAX package's);
``fixed_generation`` and ``teacher_forced_logits`` run the models on their
own device.  Imports torch and numpy only.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_SNR_CAP_DB = 99.0


def waveform_snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """SNR of ``test`` against ``ref`` (dB), truncated to the common length.
    Identical signals cap at 99 dB."""
    ref = np.asarray(ref, np.float64).ravel()
    test = np.asarray(test, np.float64).ravel()
    n = min(len(ref), len(test))
    if n == 0:
        return 0.0
    ref, test = ref[:n], test[:n]
    sig = float(np.sum(ref * ref))
    err = float(np.sum((ref - test) ** 2))
    if err <= sig * 10 ** (-_SNR_CAP_DB / 10):
        return _SNR_CAP_DB
    if sig == 0.0:
        return 0.0
    return float(10.0 * np.log10(sig / err))


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular HTK-mel filterbank."""
    fmax = fmax or sr / 2
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, ctr, hi = bins[i], bins[i + 1], bins[i + 2]
        for b in range(lo, ctr):
            if ctr > lo:
                fb[i, b] = (b - lo) / (ctr - lo)
        for b in range(ctr, hi):
            if hi > ctr:
                fb[i, b] = (hi - b) / (hi - ctr)
    return fb


def log_mel(wav: np.ndarray, sr: int = 24_000, n_fft: int = 1024,
            hop: int = 256, n_mels: int = 80) -> np.ndarray:
    """[frames, n_mels] log-mel spectrogram (numpy STFT, Hann window)."""
    wav = np.asarray(wav, np.float64).ravel()
    if len(wav) < n_fft:
        wav = np.pad(wav, (0, n_fft - len(wav)))
    n_frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(n_fft)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = spec @ mel_filterbank(sr, n_fft, n_mels).T
    return np.log(np.maximum(mel, 1e-10))


def log_mel_distance(ref: np.ndarray, test: np.ndarray, sr: int = 24_000) -> float:
    """Mean absolute log-mel difference over the common frame count: the
    "does it sound the same" proxy (robust to phase, unlike SNR)."""
    a, b = log_mel(ref, sr), log_mel(test, sr)
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    return float(np.mean(np.abs(a[:n] - b[:n])))


def token_agreement(ids_a: np.ndarray, ids_b: np.ndarray) -> Dict[str, float]:
    """Exact-match stats between two [steps, 16] codec-id matrices."""
    a, b = np.asarray(ids_a), np.asarray(ids_b)
    n = min(len(a), len(b))
    if n == 0:
        return {"match_rate": 0.0, "cb0_match_rate": 0.0,
                "first_divergence_step": 0, "steps_compared": 0}
    a, b = a[:n], b[:n]
    cb0_neq = np.nonzero(a[:, 0] != b[:, 0])[0]
    return {
        "match_rate": float(np.mean(a == b)),
        "cb0_match_rate": float(np.mean(a[:, 0] == b[:, 0])),
        "first_divergence_step": int(cb0_neq[0]) if len(cb0_neq) else n,
        "steps_compared": n,
    }


def fixed_generation(model, text, ref_audio, ref_text, language, steps, seed):
    """Greedy-codebook-0, fixed-length generation returning (ids [steps,
    16], audio).  A generator seeded with ``seed`` on the model's device (not
    the model's own stream) keeps the predictor's sampled codebooks
    comparable across two models; ``min_new_tokens = steps`` suppresses the
    EOS, so both runs emit exactly ``steps`` frames."""
    from ..runtime import loops

    embeds, trailing, tpe, _ = model._prepare_clone(
        text, ref_audio, ref_text, language, True, True, True, None)
    pol, ppol = model._policies(
        temperature=0.9, top_k=50, top_p=1.0, do_sample=False,
        repetition_penalty=1.05, min_new_tokens=steps)
    model._warmup(embeds.shape[1], trailing.shape[1], pol, ppol)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    ids, _ = loops.fast_generate(model.engine, embeds, trailing, tpe, generator=gen,
                                 max_new_tokens=steps, policy=pol, pred_policy=ppol)
    ids = np.asarray(ids)
    return ids, np.asarray(model.vocoder.decode(ids))


@torch.inference_mode()
def teacher_forced_logits(model, text, ref_audio, ref_text, language, codes: np.ndarray):
    """Run the model's talker and predictor over a FIXED token history.

    ``codes`` is a [steps, 16] codec-id matrix (codebook 0 the talker's
    token, 1..15 the predictor's).  Every step's inputs come from the codes,
    so two models given the same codes see the same history, and their
    per-step logit deltas isolate the models' numeric difference (e.g.
    quantization) from the divergence a free-running comparison compounds
    after its first argmax flip.

    Returns (talker_logits [steps, V], pred_logits [steps, 15, CB]) float32:
    ``talker_logits[t]`` is the codec head's output whose argmax predicts
    ``codes[t, 0]`` (t = 0 from the prefill), ``pred_logits[t, i]``
    predicts ``codes[t, i + 1]``.  The JAX package's scan as a plain eager
    loop: no CUDA graph, no flash-decode (the JAX path passes
    ``use_flash=False``), and a KV cache of its own of ``T + steps + 1``
    slots (in int8 when the engine's is)."""
    from ..models import predictor as predictor_lib
    from ..models import talker as talker_lib
    from ..runtime.engine import upload

    embeds, trailing, tpe, _ = model._prepare_clone(
        text, ref_audio, ref_text, language, True, True, True, None)
    eng = model.engine
    tcfg, pcfg = model.cfg.talker, model.cfg.predictor
    tparams, pparams = eng.talker_params, eng.predictor_params
    dev, dtype = eng.device, eng.dtype
    steps, T, Tt = int(codes.shape[0]), int(embeds.shape[1]), int(trailing.shape[1])
    embeds, trailing, tpe = (upload(a, dev, dtype) for a in (embeds, trailing, tpe))
    frames = torch.as_tensor(np.asarray(codes, np.int64)).to(dev)
    zero_pad = torch.zeros((1,), dtype=torch.int32, device=dev)
    kv = talker_lib.new_kv_cache(tcfg, 1, T + steps + 1, dtype, dev, kv_quant=eng.kv_quant)
    past_hidden, logits_p, kv = talker_lib.prefill(tparams, tcfg, embeds, zero_pad, kv)
    talker_logits, pred_logits = [logits_p[0]], []
    for t in range(steps):
        frame = frames[t]
        tok_embed = talker_lib.embed_codec(tparams, frame[:1])[:, None, :]
        pred_input = torch.cat([past_hidden, tok_embed], dim=1)
        pred_logits.append(predictor_lib.predict_frame_teacher(
            pparams, pcfg, pred_input, frame[None, 1:])[0])
        emb_sum = predictor_lib.embed_sum_for(pparams, frame[None, 1:], tok_embed.dtype)
        trail = trailing[:, min(t, Tt - 1)][:, None] if t < Tt else tpe
        x = tok_embed + emb_sum.to(tok_embed.dtype) + trail
        pos = torch.full((1,), T + t, dtype=torch.int32, device=dev)
        past_hidden, kv = talker_lib.decode_step(tparams, tcfg, x, pos, zero_pad, kv,
                                                 use_flash=False)
        # the last step's logits predict a frame past the codes: dropped
        if t < steps - 1:
            talker_logits.append(talker_lib.codec_head(tparams, past_hidden[:, 0, :])[0])
    tl = torch.stack(talker_logits).float().cpu().numpy()
    pl = torch.stack(pred_logits).float().cpu().numpy()
    return tl, pl


def teacher_forced_quality(model_ref, model_q, *, text: str, ref_audio, ref_text: str,
                           language: str = "English", codes: np.ndarray) -> Dict:
    """Token-matched fidelity of ``model_q`` against ``model_ref`` over the
    SAME code history (teacher forcing): per-step logit MSE and argmax-flip
    rate for the talker and predictor heads separately, and the vocoder's
    waveform SNR on identical codes."""
    tl_r, pl_r = teacher_forced_logits(model_ref, text, ref_audio, ref_text, language, codes)
    tl_q, pl_q = teacher_forced_logits(model_q, text, ref_audio, ref_text, language, codes)
    wav_r = np.asarray(model_ref.vocoder.decode(codes))
    wav_q = np.asarray(model_q.vocoder.decode(codes))
    talker_mse = float(np.mean((tl_r - tl_q) ** 2))
    pred_mse = float(np.mean((pl_r - pl_q) ** 2))
    talker_flips = float(np.mean(tl_r.argmax(-1) != tl_q.argmax(-1)))
    pred_flips = float(np.mean(pl_r.argmax(-1) != pl_q.argmax(-1)))
    return {
        "steps": int(codes.shape[0]),
        # the headline aggregates, both heads pooled
        "logit_mse": round((talker_mse + pred_mse) / 2, 6),
        "argmax_flip_rate": round(float(np.mean(np.concatenate([
            (tl_r.argmax(-1) != tl_q.argmax(-1)).ravel(),
            (pl_r.argmax(-1) != pl_q.argmax(-1)).ravel()]))), 4),
        "vocoder_snr_db": round(waveform_snr_db(wav_r, wav_q), 2),
        # per component
        "talker_logit_mse": round(talker_mse, 6),
        "talker_argmax_flip_rate": round(talker_flips, 4),
        "pred_logit_mse": round(pred_mse, 6),
        "pred_argmax_flip_rate": round(pred_flips, 4),
    }


def quant_quality(model_ref, model_q, *, text: str, ref_audio, ref_text: str,
                  language: str = "English", steps: int = 48,
                  seed: int = 1337, teacher_forced: bool = True) -> Dict:
    """A/B fidelity of ``model_q`` against ``model_ref`` (the same weights
    and seed, e.g. bf16 against w8a8).

    Two layers:
      - ``teacher_forced`` (primary): both models over the reference model's
        code history: logit MSE, argmax-flip rates, vocoder SNR on identical
        codes.  This is the fidelity claim.
      - free-running (secondary): token agreement, waveform SNR and log-mel
        distance of each model's OWN generation at the same seed.  After the
        first argmax flip the sequences are incomparable, so these report
        divergence, not quality.

    Returns a JSON-ready dict."""
    ids_r, wav_r = fixed_generation(model_ref, text, ref_audio, ref_text, language, steps, seed)
    ids_q, wav_q = fixed_generation(model_q, text, ref_audio, ref_text, language, steps, seed)
    out = {
        "steps": int(steps),
        "waveform_snr_db": round(waveform_snr_db(wav_r, wav_q), 2),
        "log_mel_dist": round(log_mel_distance(wav_r, wav_q, model_ref.sample_rate), 4),
    }
    out.update(token_agreement(ids_r, ids_q))
    if teacher_forced:
        out["teacher_forced"] = teacher_forced_quality(
            model_ref, model_q, text=text, ref_audio=ref_audio, ref_text=ref_text,
            language=language, codes=ids_r)
    return out
