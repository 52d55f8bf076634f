"""PyTorch port vs the JAX package: the quantization quality gate
(``utils/quality.py``) and ``predict_frame_teacher``.

- The numpy metrics (SNR, mel filterbank, log-mel, token agreement) equal
  the JAX package's on the same inputs (the same numpy code: exact).
- ``predict_frame_teacher`` and ``teacher_forced_logits`` against JAX on the
  same weights, prompt and codes, tiny float32: logits within 1e-4 (float32
  sums in another order through a dozen layers, logits up to ~5 in size;
  measured up to 6e-6).
- The self-comparison is perfect; frame coverage and causality (JAX
  ``tests/test_quality.py:121-162``); the int8 / w8a8 / kv_quant floor at
  12 steps on the port alone.

Codes and inputs come from numpy.random.default_rng.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the tier-1 run's workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.utils import quality as JQ  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.utils import quality as TQ  # noqa: E402

LOGIT_ATOL = 1e-4


def _sine(freq, n=24_000, sr=24_000):
    return np.sin(2 * np.pi * freq * np.arange(n) / sr).astype(np.float32)


_RS = np.random.RandomState(0)
_NOISY = _RS.randn(48000)
_NOISE = _RS.randn(48000) * 0.1
_IDS = np.random.default_rng(3).integers(0, 32, (10, 16))
_IDS_B = _IDS.copy()
_IDS_B[7:, 0] += 1


@pytest.mark.parametrize("name,call", [
    ("snr_identical", lambda q: q.waveform_snr_db(_sine(220), _sine(220))),
    ("snr_noise", lambda q: q.waveform_snr_db(_NOISY, _NOISY + _NOISE)),
    ("snr_truncates", lambda q: q.waveform_snr_db(np.ones(1000), np.ones(500))),
    ("snr_empty", lambda q: q.waveform_snr_db(np.zeros(0), np.ones(10))),
    ("mel_filterbank", lambda q: q.mel_filterbank(24_000, 1024, 80)),
    ("log_mel", lambda q: q.log_mel(_sine(220))),
    ("log_mel_short", lambda q: q.log_mel(_sine(220, n=500))),
    ("log_mel_distance", lambda q: q.log_mel_distance(_sine(220), _sine(440))),
    ("token_agreement", lambda q: q.token_agreement(_IDS, _IDS_B)),
    ("token_agreement_empty", lambda q: q.token_agreement(_IDS[:0], _IDS[:0])),
])
def test_metrics_equal_jax(name, call):
    got, want = call(TQ), call(JQ)
    if isinstance(want, dict):
        assert got == want
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_metric_values():
    assert TQ.waveform_snr_db(_sine(220), _sine(220)) == 99.0
    assert 19.0 < TQ.waveform_snr_db(_NOISY, _NOISY + _NOISE) < 21.0
    assert TQ.log_mel_distance(_sine(220), _sine(220)) == 0.0
    assert TQ.log_mel_distance(_sine(220), _sine(440)) > 0.1
    r = TQ.token_agreement(_IDS, _IDS_B)
    assert r["first_divergence_step"] == 7 and r["cb0_match_rate"] == 0.7


def test_predict_frame_teacher_matches_jax(tiny_cfg, tiny_models):
    from qwen3tts_tpu.models import predictor as JP
    from qwen3tts_tpu_torch.models import predictor as TP

    _, pp = tiny_models
    cfg = get_preset("tiny")
    tparams = bundle_from_jax_numpy({"predictor": jax.tree.map(np.asarray, pp)}, cfg,
                                    torch.float32, "cpu")["predictor"]
    rng = np.random.default_rng(1)
    pin = rng.standard_normal((2, 2, cfg.talker.hidden_size)).astype(np.float32) * 0.5
    teacher = rng.integers(0, cfg.predictor.codebook_size, (2, 15))
    want = np.asarray(jax.jit(lambda p, x, t: JP.predict_frame_teacher(
        p, tiny_cfg.predictor, x, t))(pp, jnp.asarray(pin), jnp.asarray(teacher, jnp.int32)))
    got = TP.predict_frame_teacher(tparams, cfg.predictor, torch.from_numpy(pin),
                                   torch.from_numpy(teacher))
    assert got.dtype == torch.float32 and got.shape == (2, 15, cfg.predictor.codebook_size)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)
    # greedy predict_frame is teacher forcing on its own argmaxes
    toks, _ = TP.predict_frame(tparams, cfg.predictor, torch.from_numpy(pin), None,
                               TP.SamplingPolicy(do_sample=False))
    forced = TP.predict_frame_teacher(tparams, cfg.predictor, torch.from_numpy(pin), toks)
    np.testing.assert_array_equal(forced.argmax(-1).numpy(), toks.numpy())


@pytest.fixture(scope="module")
def port_tts(tiny_tts):
    """The JAX ``random:tiny`` weights in the port, codec in float32."""
    cfg = get_preset("tiny")
    params = bundle_from_jax_numpy(jax.tree.map(np.asarray, tiny_tts.params), cfg,
                                   torch.float32, "cpu")
    return FasterQwen3TTS(cfg, params, vocoder_compute_dtype=None)


def _codes(model, steps, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, model.cfg.predictor.codebook_size, (steps, 16))
    codes[:, 0] = rng.integers(0, model.cfg.talker.vocab_size, steps)
    return codes


def test_teacher_forced_logits_match_jax(tiny_tts, port_tts, ref_wav, monkeypatch):
    """Both packages over the same prompt (the JAX one's: the two speaker
    encoders differ by ~7e-5 in float32, which would move the logits by
    ~5e-4) and the same codes."""
    monkeypatch.setattr(port_tts, "_prepare_clone", lambda *a: tuple(
        None if x is None else np.array(x) for x in tiny_tts._prepare_clone(*a)))
    codes = _codes(port_tts, 6, 4)
    args = ("teacher forcing", ref_wav, "ref", "English", codes)
    jtl, jpl = JQ.teacher_forced_logits(tiny_tts, *args)
    tl, pl = TQ.teacher_forced_logits(port_tts, *args)
    assert tl.shape == jtl.shape == (6, port_tts.cfg.talker.vocab_size)
    assert pl.shape == jpl.shape == (6, 15, port_tts.cfg.predictor.codebook_size)
    assert tl.dtype == pl.dtype == np.float32
    np.testing.assert_allclose(tl, jtl, atol=LOGIT_ATOL)
    np.testing.assert_allclose(pl, jpl, atol=LOGIT_ATOL)


@pytest.fixture(scope="module")
def tiny_port():
    return FasterQwen3TTS.from_pretrained("random:tiny", device="cpu")


def test_quant_quality_self_is_perfect(tiny_port, ref_wav):
    """The same model on both sides: the seeded generator pins the sampled
    codebooks, and the teacher-forced path adds no noise."""
    r = TQ.quant_quality(tiny_port, tiny_port, text="identity check", ref_audio=ref_wav,
                         ref_text="ref", steps=12)
    assert r["steps_compared"] == 12 and r["match_rate"] == 1.0
    assert r["waveform_snr_db"] == 99.0 and r["log_mel_dist"] == 0.0
    tf = r["teacher_forced"]
    assert tf["logit_mse"] == 0.0 and tf["argmax_flip_rate"] == 0.0
    assert tf["vocoder_snr_db"] == 99.0


def test_teacher_forced_covers_all_frames(tiny_port, ref_wav):
    """Talker logits align with codes[:, 0] (the prefill predicts frame 0) and
    the predictor's cover all 15 codebooks of every frame; perturbing frame
    k's codebook 0 leaves talker logits 0..k and predictor frames 0..k-1
    unchanged and changes predictor frame k and talker logits k+1."""
    ids, _ = TQ.fixed_generation(tiny_port, "shapes", ref_wav, "ref", "English", 8, 3)
    tl, pl = TQ.teacher_forced_logits(tiny_port, "shapes", ref_wav, "ref", "English", ids)
    V = tiny_port.cfg.talker.vocab_size
    assert ids.shape == (8, 16)
    assert tl.shape == (8, V) and pl.shape == (8, 15, tiny_port.cfg.predictor.codebook_size)
    k = 4
    ids2 = np.array(ids)
    ids2[k, 0] = (ids2[k, 0] + 1) % V
    tl2, pl2 = TQ.teacher_forced_logits(tiny_port, "shapes", ref_wav, "ref", "English", ids2)
    np.testing.assert_array_equal(tl2[: k + 1], tl[: k + 1])
    np.testing.assert_array_equal(pl2[:k], pl[:k])
    assert not np.array_equal(pl2[k], pl[k])
    assert not np.array_equal(tl2[k + 1], tl[k + 1])


@pytest.mark.parametrize("mode,kw", [
    ("int8", {"quantize": "int8"}),
    ("w8a8", {"quantize": "w8a8"}),
    ("kv_quant", {"kv_quant": True}),
])
def test_quant_quality_floor(tiny_port, ref_wav, mode, kw):
    """JAX ``tests/test_quality.py``'s floors at 12 steps: free-running
    metrics only in a sane band (random weights: one flip makes the rest
    incomparable), the teacher-forced flip rate under 0.25, and the
    unquantized vocoder exact on identical codes."""
    q = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu", **kw)
    r = TQ.quant_quality(tiny_port, q, text="hello quality gate", ref_audio=ref_wav,
                         ref_text="ref", steps=12)
    assert r["steps_compared"] == 12, r
    assert r["match_rate"] >= 0.02, (mode, r)
    assert r["log_mel_dist"] <= 2.0, (mode, r)
    assert r["waveform_snr_db"] >= -15.0, (mode, r)
    tf = r["teacher_forced"]
    assert tf["argmax_flip_rate"] <= 0.25, (mode, tf)
    assert tf["logit_mse"] < 1.0, (mode, tf)
    assert tf["vocoder_snr_db"] == 99.0, (mode, tf)
