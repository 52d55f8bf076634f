"""Self-training loop for the CTC recognizer on this framework's own TTS output.

Port of ``tools/train_asr.py``, with its names and flags (plus
``--device``):

    text (fixed lexicon) --TTS (random:tiny, greedy, per-speaker ref)--> wav
    wav --log-mel--> CTC training pair (mel, chars)

The held-out axis is an acoustic perturbation (gain, a leading-silence
shift, white noise at a random SNR): training takes random perturbations of
the deterministic utterances, and the gate evaluates perturbations from a
disjoint seed range.  (With random TTS weights nothing that changes the
conditioning transfers: the JAX tool's docstring gives the measurements.)

Synthesis goes through the port's ``FasterQwen3TTS.generate_voice_clone_batch``;
a stochastic draw seeds the model's generator (``model._gen``), so a draw's
tokens are Philox's, not JAX's threefry's.  Features are the port's
``models/speaker.py:log_mel`` after ``models/asr.py:resample``.  The mel
jitter draws from an explicit ``torch.Generator``: its distribution is
JAX's, its numbers are not.  Its deterministic half (``apply_mel_jitter``:
the gain shift, the roll behind a PAD lead, ``logaddexp`` with the noise
floor) is apart from the draws (``jitter_draws``).  The CTC loss is
``F.ctc_loss`` (``ctc_loss``), which equals ``optax.ctc_loss`` wherever an
alignment exists; ``train`` refuses a pair with none before it starts.  The
optimiser is ``utils/optim.py``: optax's global-norm clip at 1.0, then
AdamW on optax's warm-up cosine schedule.

Outputs (in ``--out``, by default ``runs/asr_torch``, which ``.gitignore``
lists; the tool refuses to write under the repository's ``samples/``, where
the JAX tool's committed outputs live):

    ctc_selftrained/            the trained checkpoint (the JAX layout:
                                 both packages' CTCRecognizer load it)
    eval/NN.wav + manifest.json held-out-perturbation gate set
    metrics.json                train/eval CER, all four axes

Everything runs on the card unless ``--device`` names another; without a
card it raises.  On the card the TTS model's talker must have a
flash-decode instance (head_dim 128, 16/8 heads: ``--model
random:qwen3-tts-0.6b``); ``random:tiny`` runs on the CPU.

Run:  python -m qwen3tts_tpu_torch.tools.train_asr --cache runs/asr_cache.npz
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.wav import write_wav
from ..core.loader import resolve_device
from ..models import asr as asr_lib
from ..models.asr import ASRConfig, CTCRecognizer, cer, init_params, resample
from ..models.speaker import log_mel
from ..utils import optim

_CHAR_TO_ID = {c: i for i, c in enumerate(asr_lib.VOCAB)}
_REPO = Path(__file__).resolve().parents[2]

# fixed lexicon: common short words; sentences are random draws, train and
# eval sentence SETS are disjoint
LEXICON = (
    "the a of to and in is it you that he was for on are with as his they be "
    "at one have this from or had by hot word but what some we can out other "
    "were all there when up use your how said an each she which do their time "
    "if will way about many then them write would like so these her long make "
    "thing see him two has look more day could go come did number sound no "
    "most people my over know water than call first who may down side been "
    "now find any new work part take get place made live where after back "
    "little only round man year came show every good me give our under name"
).split()

# synthetic reference voices: (f0 Hz, AM rate Hz, envelope base, env depth).
# Speakers 1-2 are the demo server's preset_low / preset_high recipes; the
# LAST speaker is never trained on (the held-out-voice CER is reported).
SPEAKERS = [
    (180.0, 2.5, 0.6, 0.4),
    (140.0, 3.0, 0.7, 0.3),   # demo preset_low
    (260.0, 5.0, 0.7, 0.3),   # demo preset_high
    (320.0, 4.2, 0.6, 0.4),   # held out
]


def make_ref(spk: int, path: Path) -> str:
    f0, am, base, depth = SPEAKERS[spk]
    t = np.linspace(0, 3.0, 72_000, dtype=np.float32)
    w = (0.25 * np.sin(2 * np.pi * f0 * t)
         * (base + depth * np.sin(2 * np.pi * am * t))).astype(np.float32)
    write_wav(str(path), w, 24_000)
    return str(path)


def augment(wav: np.ndarray, rs: np.random.RandomState) -> np.ndarray:
    """One random acoustic perturbation of ``wav``: gain, leading-silence
    shift, additive white noise at a random SNR (numpy: the same numbers as
    the JAX tool for the same ``rs``)."""
    w = np.asarray(wav, np.float32) * rs.uniform(0.5, 1.6)
    shift = rs.randint(0, 6000)  # up to 0.25 s of leading silence
    if shift:
        w = np.concatenate([np.zeros(shift, np.float32), w])
    rms = float(np.sqrt((w ** 2).mean())) or 1.0
    snr_db = rs.uniform(15.0, 35.0)
    w = w + rs.randn(len(w)).astype(np.float32) * (rms / 10 ** (snr_db / 20))
    return w


def make_texts(n: int, seed: int, min_words=3, max_words=6) -> List[str]:
    rs = np.random.RandomState(seed)
    out, seen = [], set()
    while len(out) < n:
        k = rs.randint(min_words, max_words + 1)
        t = " ".join(LEXICON[i] for i in rs.randint(0, len(LEXICON), k))
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def synthesize(model, texts, ref_wav, batch=8, draw=None, temperature=0.8):
    """Fixed-length TTS for every text (min == max new tokens: chars + 16
    frames cover the sentence).  ``draw=None`` decodes greedily; an integer
    seeds the model's generator for a reproducible stochastic decode."""
    wavs = []
    t0 = time.time()
    if draw is not None:
        model._gen.manual_seed(100_000 + draw)
    for i in range(0, len(texts), batch):
        chunk = texts[i:i + batch]
        steps = max(len(t) for t in chunk) + 16
        got, _sr = model.generate_voice_clone_batch(
            chunk, "English", ref_wav, "reference",
            max_new_tokens=steps, min_new_tokens=steps,
            do_sample=draw is not None, temperature=temperature)
        wavs.extend(got)
        print(f"  synth {i + len(chunk)}/{len(texts)} ({time.time() - t0:.0f}s)",
              file=sys.stderr)
    return wavs


def _log_mel(w24: np.ndarray, cfg: ASRConfig, device) -> np.ndarray:
    w16 = resample(np.asarray(w24, np.float32), 24_000, cfg.sample_rate)
    with torch.inference_mode():
        m = log_mel(torch.from_numpy(np.ascontiguousarray(w16)).to(device), cfg.n_mels,
                    cfg.sample_rate)
        return m.cpu().numpy()


def featurize(wavs, texts, cfg: ASRConfig, mel_T: int, lab_L: int, device=None):
    """(mel [N, mel_T, n_mels], mel_lens, labels [N, lab_L], lab_lens,
    log_rms), numpy.  ``log_rms`` is ln(RMS) of the 24 kHz waveform, the
    scale the gate's SNR draws are relative to (the train-time jitter's
    matched noise).  The mels are computed on ``device`` (default: the
    card)."""
    device = resolve_device(device)
    N = len(wavs)
    mels = np.full((N, mel_T, cfg.n_mels), asr_lib._LOG_MEL_PAD, np.float32)
    mel_lens = np.zeros((N,), np.int32)
    labels = np.zeros((N, lab_L), np.int32)
    lab_lens = np.zeros((N,), np.int32)
    log_rms = np.zeros((N,), np.float32)
    for i, (w, t) in enumerate(zip(wavs, texts)):
        w = np.asarray(w, np.float32)
        log_rms[i] = float(np.log(np.sqrt((w ** 2).mean()) + 1e-12))
        m = _log_mel(w, cfg, device)
        L = min(len(m), mel_T)
        mels[i, :L] = m[:L]
        mel_lens[i] = L
        ids = [_CHAR_TO_ID[c] for c in t if c in _CHAR_TO_ID]
        if len(ids) > lab_L:
            raise ValueError(f"{len(ids)} characters do not fit {lab_L} label slots")
        labels[i, :len(ids)] = ids
        lab_lens[i] = len(ids)
    return mels, mel_lens, labels, lab_lens, log_rms


def noise_mel_floor(cfg: ASRConfig, device=None) -> np.ndarray:
    """Per-mel-bin expected log-power of unit-variance white noise
    [n_mels], measured through the recognizer's own frontend (the noise
    added at 24 kHz, before the 16 kHz resample, as the gate adds it): a
    white floor at std s sits at ``floor + 2 ln s``, and signal + noise is
    ``logaddexp(mel, floor + 2 ln s)``."""
    w24 = np.random.RandomState(1234).randn(24_000 * 4).astype(np.float32)
    m = _log_mel(w24, cfg, resolve_device(device))
    # mean in the power domain (the floor is E[power], not E[log power])
    return np.log(np.exp(m).mean(axis=0)).astype(np.float32)


def jitter_draws(gen: torch.Generator, shape, dropout: float = 0.0) -> Dict[str, torch.Tensor]:
    """The random half of the train-time mel jitter, for a batch of mels of
    ``shape`` [B, T, n_mels], drawn from ``gen`` (on its device), in the
    JAX tool's distributions: a log gain uniform in [ln 0.5, ln 1.6), an
    unmatched Gaussian jitter of std uniform in [0, 0.25), a lead shift
    uniform in 0..23 frames, an SNR uniform in [12, 38) dB, and with
    ``dropout`` a keep mask."""
    B = shape[0]
    dev = gen.device

    def uniform(lo, hi):
        return torch.rand((B, 1, 1), generator=gen, device=dev) * (hi - lo) + lo

    gain_ln = uniform(math.log(0.5), math.log(1.6))
    noise = torch.randn(shape, generator=gen, device=dev) * uniform(0.0, 0.25)
    shift = torch.randint(0, 24, (), generator=gen, device=dev)
    out = {"gain_ln": gain_ln, "noise": noise, "shift": shift, "snr_db": uniform(12.0, 38.0)}
    if dropout > 0.0:
        out["keep"] = torch.rand(shape, generator=gen, device=dev) >= dropout
    return out


def apply_mel_jitter(mel: torch.Tensor, mel_len: torch.Tensor, log_rms: torch.Tensor,
                     nfloor: torch.Tensor, draws: Dict[str, torch.Tensor]):
    """The deterministic half of the jitter, on given draws: every
    perturbation of the gate modelled in log-power mels.  A gain g is a
    ``+2 ln g`` shift of the valid frames (then the unmatched jitter); the
    lead shift rolls the frames by ``k`` behind a PAD lead and lengthens
    the utterance by ``k`` (at most to T); white noise at std s over the
    whole shifted utterance is ``logaddexp(mel, floor + 2 ln s)``, with s
    from the utterance's RMS, the gain and the SNR.  Returns (mel,
    mel_len)."""
    T = mel.shape[1]
    frames = torch.arange(T, device=mel.device)[None, :, None]
    gain_ln = draws["gain_ln"]
    valid = frames < mel_len[:, None, None]
    mel = torch.where(valid, mel + 2 * gain_ln, mel)
    mel = torch.where(valid, mel + draws["noise"], mel)
    k = draws["shift"]
    mel = torch.roll(mel, int(k), dims=1)
    mel = torch.where(frames < k, torch.full_like(mel, asr_lib._LOG_MEL_PAD), mel)
    mel_len = torch.clamp(mel_len + k, max=T)
    sigma_ln = (log_rms[:, None, None] + gain_ln
                - draws["snr_db"] * (math.log(10.0) / 20.0))
    floor = nfloor[None, None, :] + 2 * sigma_ln
    valid2 = frames < mel_len[:, None, None]
    mel = torch.where(valid2, torch.logaddexp(mel, floor), mel)
    return mel, mel_len


def ctc_loss(logits: torch.Tensor, mel_len: torch.Tensor, labels: torch.Tensor,
             lab_len: torch.Tensor) -> torch.Tensor:
    """The JAX tool's loss: the CTC negative log-likelihood of each row
    (``logits`` [B, Tl, V], blank 0, ``min(ceil(mel_len / 4), Tl)`` valid
    frames, ``lab_len`` labels), divided by ``max(lab_len, 1)``, averaged.
    ``F.ctc_loss`` equals ``optax.ctc_loss`` wherever an alignment exists;
    where none does (fewer frames than labels plus their repeats) optax
    returns a large finite value (its ``log_epsilon``, -1e5, per frame) and
    this returns ``inf``, which ``train`` never meets: it refuses such a
    pair first (``check_alignable``)."""
    Tl = logits.shape[1]
    in_len = torch.clamp(torch.ceil(mel_len.float() / 4), max=Tl).long()
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # [Tl, B, V]
    per = F.ctc_loss(logp, labels.long(), in_len, lab_len.long(), blank=0,
                     reduction="none", zero_infinity=False)
    return (per / lab_len.clamp_min(1).to(per.dtype)).mean()


def check_alignable(mel_lens: np.ndarray, labels: np.ndarray, lab_lens: np.ndarray,
                    mel_T: int) -> None:
    """Raise when a row's frames cannot hold a CTC alignment of its labels
    (each label a frame, a blank between two equal neighbours)."""
    Tl = -(-mel_T // 4)
    for i, (m, n) in enumerate(zip(mel_lens, lab_lens)):
        lab = labels[i, :n]
        need = int(n) + int((lab[1:] == lab[:-1]).sum())
        if min(-(-int(m) // 4), Tl) < need:
            raise ValueError(f"utterance {i}: {min(-(-int(m) // 4), Tl)} CTC frames cannot "
                             f"align {n} labels ({need} frames needed)")


def train(cfg: ASRConfig, data, *, lr=4e-4, epochs=60, batch=32, seed=0, dropout=0.0,
          mel_jitter=True, eval_fn=None, eval_every=0, init=None, device=None,
          losses: Optional[list] = None):
    """AdamW (``utils/optim.py``, optax's numbers) behind a global-norm clip
    of 1.0 on a warm-up cosine schedule (peak ``lr``, end ``lr * 0.02``),
    ``epochs`` passes of batches of ``batch`` in the order of
    ``np.random.RandomState(seed + 1)`` (JAX's), the jitter and the
    dropout drawn from ``torch.Generator(device).manual_seed(seed + 2)``.
    ``init``: a parameter tree in the JAX layout (numpy, JAX or torch
    leaves: the JAX package's ``init_params`` output, say) to start from;
    default the port's ``init_params`` from ``seed``.  ``losses``, when given, takes
    each epoch's mean loss.  Returns the parameters (the port's layout) on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    mels, mel_lens, labels, lab_lens, log_rms = data
    N = len(mels)
    check_alignable(mel_lens, labels, lab_lens, mels.shape[1])
    if init is not None:
        params = asr_lib.asr_params_from_jax_numpy(init, device)
    else:
        params = init_params(torch.Generator(device=device).manual_seed(seed), cfg, device)
    total_steps = max((N // batch) * epochs, 1)
    sched = optim.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(500, total_steps // 10 + 1), decay_steps=total_steps,
        end_value=lr * 0.02)
    opt = optim.adamw(sched)
    opt_state = opt.init(params)
    ps = optim.leaves(params)
    nfloor = torch.from_numpy(noise_mel_floor(cfg, device)).to(device)
    d_mels, d_mel_lens, d_labels, d_lab_lens, d_log_rms = (
        torch.from_numpy(np.asarray(x)).to(device)
        for x in (mels, mel_lens, labels, lab_lens, log_rms))
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    rs = np.random.RandomState(seed + 1)
    t0 = time.time()
    for ep in range(epochs):
        order = rs.permutation(N)
        tot, nb = 0.0, 0
        for i in range(0, N - batch + 1, batch):
            idx = torch.from_numpy(order[i:i + batch]).to(device)
            mel, mel_len = d_mels[idx], d_mel_lens[idx]
            if mel_jitter or dropout > 0.0:
                draws = jitter_draws(gen, mel.shape, dropout)
                if mel_jitter:
                    mel, mel_len = apply_mel_jitter(mel, mel_len, d_log_rms[idx], nfloor,
                                                    draws)
                if dropout > 0.0:  # input-feature dropout
                    mel = torch.where(draws["keep"], mel,
                                      torch.full_like(mel, asr_lib._LOG_MEL_PAD))
            for p in ps:
                p.requires_grad_(True)
            try:
                loss = ctc_loss(asr_lib.forward(params, mel), mel_len, d_labels[idx],
                                d_lab_lens[idx])
                grads = list(torch.autograd.grad(loss, ps))
            finally:
                for p in ps:
                    p.requires_grad_(False)
            optim.clip_by_global_norm(grads, 1.0)
            opt.step(params, grads, opt_state)
            tot += loss.item()
            nb += 1
        if losses is not None:
            losses.append(tot / max(nb, 1))
        if ep % 5 == 0 or ep == epochs - 1:
            print(f"  epoch {ep:3d} loss {tot / max(nb, 1):.4f} ({time.time() - t0:.0f}s)",
                  file=sys.stderr)
        if eval_fn is not None and eval_every and ep and ep % eval_every == 0:
            print(f"  epoch {ep:3d} {eval_fn(params)}", file=sys.stderr)
    return params


def eval_cer(rec: CTCRecognizer, wavs, texts, sr=24_000):
    scores, hyps = [], []
    for w, t in zip(wavs, texts):
        hyp = rec.transcribe(np.asarray(w, np.float32), sr)
        scores.append(cer(t, hyp))
        hyps.append(hyp)
    return float(np.mean(scores)), hyps


def _out_dir(arg: str) -> Path:
    out = Path(arg).resolve()
    samples = _REPO / "samples"
    if out == samples or samples in out.parents:
        raise ValueError(f"--out {arg}: the repository's samples/ holds the JAX tool's "
                         "committed outputs; write elsewhere")
    return out


def main(argv=None) -> Dict:
    """The command line (the JAX tool's flags, ``--device``); returns what
    it wrote to ``metrics.json`` with the run's seconds (synthesis,
    featurisation, training and each epoch), its epoch losses and its
    device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="random:tiny")
    ap.add_argument("--n-train", type=int, default=240,
                    help="training sentences (each synthesized by every training speaker)")
    ap.add_argument("--n-eval", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--n-draws", type=int, default=0,
                    help="stochastic decodes of each training sentence (speaker 0) also "
                         "trained on")
    ap.add_argument("--n-aug", type=int, default=2,
                    help="random acoustic perturbations of each training utterance trained "
                         "on (besides the clean one)")
    ap.add_argument("--out", default="runs/asr_torch",
                    help="output directory (not under the repository's samples/)")
    ap.add_argument("--cache", default=None,
                    help="npz path: reuse synthesized wavs across runs")
    ap.add_argument("--spk0-cache", default=None,
                    help="legacy single-speaker cache (train_wavs/eval_wavs for speaker 0) "
                         "to seed synthesis from")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; without one, pass cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    out = _out_dir(args.out)
    (out / "eval").mkdir(parents=True, exist_ok=True)
    seconds = {"synthesis": 0.0}

    train_texts = make_texts(args.n_train, seed=11)
    unseen_texts = [t for t in make_texts(args.n_eval * 4, seed=97)
                    if t not in set(train_texts)][: args.n_eval]
    gate_texts = train_texts[: args.n_eval]  # spoken by the held-out voice
    n_spk = len(SPEAKERS) - 1  # last speaker held out

    refs = [make_ref(s, out / ("ref.wav" if s == 0 else f"ref{s}.wav"))
            for s in range(len(SPEAKERS))]

    # key-tolerant cache: reuse whatever subsets exist, synthesize the rest,
    # save the merged set
    cache = Path(args.cache) if args.cache else None
    cached = {}
    if cache and cache.exists():
        z = np.load(cache, allow_pickle=True)
        spk_ok = ("speakers" in z.files
                  and np.allclose(np.asarray(z["speakers"], np.float64),
                                  np.asarray(SPEAKERS, np.float64)))
        if list(z["train_texts"]) == train_texts and spk_ok:
            cached = {k: list(z[k]) for k in z.files if k not in ("train_texts", "speakers")}
            print(f"cache {cache}: {sorted(cached)}", file=sys.stderr)
        else:
            print(f"cache {cache}: texts/speakers changed, ignoring", file=sys.stderr)
    _model = [None]

    def get(key, texts, ref, n=None, draw=None):
        got = cached.get(key)
        if got is not None and (n is None or len(got) >= n):
            return got if n is None else got[:n]
        t = time.time()
        if _model[0] is None:
            from ..api.model import FasterQwen3TTS

            _model[0] = FasterQwen3TTS.from_pretrained(args.model, device=device,
                                                       dtype="fp32")
        print(f"synthesizing {len(texts)} utterances ({key})", file=sys.stderr)
        cached[key] = synthesize(_model[0], texts, ref, draw=draw)
        seconds["synthesis"] += time.time() - t
        return cached[key]

    if ("train_wavs_0" not in cached and args.spk0_cache
            and Path(args.spk0_cache).exists()):
        z0 = np.load(args.spk0_cache, allow_pickle=True)
        if list(z0["train_texts"])[: args.n_train] == train_texts:
            cached["train_wavs_0"] = list(z0["train_wavs"])[: args.n_train]
            print(f"speaker 0 seeded from {args.spk0_cache}", file=sys.stderr)

    train_wavs = {s: get(f"train_wavs_{s}", train_texts, refs[s]) for s in range(n_spk)}
    draw_wavs = {d: get(f"draw_wavs_{d}", train_texts, refs[0], draw=d)
                 for d in range(1, args.n_draws + 1)}
    gate_wavs = get("gate_wavs", gate_texts, refs[0], draw=99)
    spk_wavs = get("spk_wavs", gate_texts, refs[n_spk])
    unseen_wavs = get("unseen_wavs", unseen_texts, refs[0])
    if cache:
        np.savez_compressed(
            cache, train_texts=np.asarray(train_texts, object),
            speakers=np.asarray(SPEAKERS, np.float64),
            **{k: np.asarray(v, object) for k, v in cached.items()})
    _model[0] = None  # free the TTS model before training

    base_wavs = ([w for s in range(n_spk) for w in train_wavs[s]]
                 + [w for d in draw_wavs for w in draw_wavs[d]])
    base_texts = train_texts * (n_spk + len(draw_wavs))
    # train-time perturbations (clean + n_aug variants of every utterance);
    # the gate below draws its params from a DISJOINT seed range
    all_train_wavs = list(base_wavs)
    all_train_texts = list(base_texts)
    for i, (w, t) in enumerate(zip(base_wavs, base_texts)):
        for a in range(args.n_aug):
            rs = np.random.RandomState(1_000_000 + i * 17 + a)
            all_train_wavs.append(augment(w, rs))
            all_train_texts.append(t)
    # gate: held-out PERTURBATION of in-domain utterances, cycling over the
    # trained voices
    gate_wavs_aug, gate_src = [], []
    for i in range(len(gate_texts)):
        spk = i % n_spk
        rs = np.random.RandomState(7_000_000 + i)
        gate_wavs_aug.append(augment(train_wavs[spk][i], rs))
        gate_src.append(spk)

    cfg = ASRConfig(channels=args.channels, num_layers=args.layers)
    max_chars = max(len(t) for t in train_texts + unseen_texts)
    # mel frames per TTS frame: 2000 samples @24k -> 1333 @16k -> ~8.3 mels;
    # +64 covers the augmentation's leading-silence shift (<= 0.25 s)
    mel_T = int(np.ceil((max_chars + 16) * 8.5 / 64.0)) * 64 + 64
    t = time.time()
    data = featurize(all_train_wavs, all_train_texts, cfg, mel_T, max_chars + 2, device)
    seconds["featurize"] = time.time() - t

    print(f"training ctc ({args.channels}ch x {args.layers}L, mel_T={mel_T}, "
          f"{len(all_train_wavs)} utts = {args.n_train} texts x "
          f"{n_spk + len(draw_wavs)} renditions x {1 + args.n_aug} perturbations, "
          f"on {device})", file=sys.stderr)

    def gate_eval(p):
        g, _ = eval_cer(CTCRecognizer(cfg, p), gate_wavs_aug, gate_texts)
        return f"gate CER {g:.3f}"

    losses: List[float] = []
    t = time.time()
    params = train(cfg, data, epochs=args.epochs, dropout=args.dropout, mel_jitter=True,
                   eval_fn=gate_eval, eval_every=50, device=device, losses=losses)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds["train"] = time.time() - t
    seconds["epoch"] = seconds["train"] / max(args.epochs, 1)
    rec = CTCRecognizer(cfg, params)

    train_cer, _ = eval_cer(rec, all_train_wavs[:32], all_train_texts[:32])
    gate_cer, gate_hyps = eval_cer(rec, gate_wavs_aug, gate_texts)
    draw_cer, _ = eval_cer(rec, gate_wavs, gate_texts)
    spk_cer, _ = eval_cer(rec, spk_wavs, gate_texts)
    unseen_cer, _ = eval_cer(rec, unseen_wavs, unseen_texts)
    print(f"train CER (32 sample) {train_cer:.3f}  "
          f"GATE held-out-perturbation CER {gate_cer:.3f}  "
          f"held-out-draw CER {draw_cer:.3f}  "
          f"held-out-speaker CER {spk_cer:.3f}  "
          f"unseen-text CER {unseen_cer:.3f}", file=sys.stderr)
    for txt, hyp in list(zip(gate_texts, gate_hyps))[:6]:
        print(f"  ref: {txt}\n  hyp: {hyp}", file=sys.stderr)

    rec.save_pretrained(out / "ctc_selftrained")
    manifest = []
    for i, (w, txt) in enumerate(zip(gate_wavs_aug, gate_texts)):
        name = f"eval/{i:02d}.wav"
        write_wav(str(out / name), np.asarray(w, np.float32), 24_000)
        manifest.append({"wav": name, "text": txt, "speaker": gate_src[i],
                         "heldout": "acoustic perturbation (seed 7M range)"})
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    metrics = {
        "train_cer_32": round(train_cer, 4),
        "eval_cer_heldout_perturbation": round(gate_cer, 4),
        "eval_cer_heldout_draw": round(draw_cer, 4),
        "eval_cer_heldout_speaker": round(spk_cer, 4),
        "eval_cer_unseen_text": round(unseen_cer, 4),
        "n_train_texts": len(train_texts),
        "n_train_speakers": n_spk,
        "n_train_draws": len(draw_wavs),
        "n_aug": args.n_aug,
        "n_eval": len(gate_texts),
        "tts_model": args.model, "channels": args.channels,
        "layers": args.layers, "epochs": args.epochs,
        "dropout": args.dropout,
    }
    (out / "metrics.json").write_text(json.dumps(metrics, indent=1) + "\n")
    print(json.dumps({k: metrics[k] for k in (
        "eval_cer_heldout_perturbation", "eval_cer_heldout_draw",
        "eval_cer_heldout_speaker", "eval_cer_unseen_text")}))
    return {**metrics, "seconds": seconds, "losses": losses, "device": str(device),
            "out": str(out)}


if __name__ == "__main__":
    main()
