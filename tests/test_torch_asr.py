"""The port's CTC recognizer (``qwen3tts_tpu_torch/models/asr.py``) against
the JAX package's (``qwen3tts_tpu/models/asr.py``) on the CPU.

- ``_conv1d`` equals ``jax.lax.conv_general_dilated`` with ``"SAME"``
  padding at strides 1 and 2, for even and odd lengths, within 1e-5.
- The forward on JAX's ``init_params`` (carried across as numpy by
  ``asr_params_from_jax_numpy``) equals JAX ``forward`` on the same seeded
  mel, for ``ctc-tiny`` and ``ctc-base``, within 1e-5 (float32).
- ``transcribe`` gives JAX's string at 16 kHz and 24 kHz (resampled), for
  lengths inside one 256-frame bucket and across two.
- Each package loads the other's ``save_pretrained`` output, leaf for leaf,
  with equal transcripts.
- The committed self-trained checkpoint: the port's transcripts of the 16
  committed clips equal JAX's, and the CER gate of ``tests/test_asr.py``
  holds (within 0.08 of the recorded figure, and below 0.7).
- ``tests/test_asr.py``'s tests on the port: decode, resample,
  determinism, bucketing, save and load, the demo's ``/transcribe`` and
  ``resolve_asr``.
"""
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.audio.wav import read_wav  # noqa: E402
from qwen3tts_tpu.models import asr as J  # noqa: E402
from qwen3tts_tpu_torch.models import asr as P  # noqa: E402
from qwen3tts_tpu_torch.models.asr import asr_params_from_jax_numpy  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5  # float32, the same function in another summation order


def _jax_rec(ref="random:ctc-tiny", seed=0):
    return J.CTCRecognizer.from_pretrained(ref, seed=seed)


def _port_of(jrec):
    """The port's recognizer on the JAX recognizer's weights."""
    return P.CTCRecognizer(P.ASRConfig.from_dict(jrec.cfg.to_dict()),
                           asr_params_from_jax_numpy(jax.tree.map(np.asarray, jrec.params), "cpu"))


def _speechlike(sr: int, seconds: float, seed: int) -> np.ndarray:
    """A vibrato tone in noise: more varied frames than a pure sine."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds), dtype=np.float32) / sr
    f0 = 180.0 + 60.0 * np.sin(2 * np.pi * 2.5 * t)
    wav = 0.2 * np.sin(2 * np.pi * np.cumsum(f0) / sr) + 0.02 * rng.standard_normal(t.size)
    return wav.astype(np.float32)


# ---------------------------------------------------------------------------
# the layers and the forward against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [7, 255, 256, 257])
@pytest.mark.parametrize("stride,k", [(2, 3), (1, 5)])
def test_conv1d_matches_xla_same_padding(T, stride, k):
    rng = np.random.default_rng(T * 10 + stride)
    cin, cout = 16, 8
    x = rng.standard_normal((T, cin)).astype(np.float32)
    w = (rng.standard_normal((k, cin, cout)) * (k * cin) ** -0.5).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(J._conv1d(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                stride=stride))
    port = {"w": torch.from_numpy(w).permute(2, 1, 0).contiguous(), "b": torch.from_numpy(b)}
    got = P._conv1d(torch.from_numpy(x).T[None], port, stride)[0].T.numpy()
    assert got.shape == want.shape == (-(-T // stride), cout)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_same_pad_follows_xla_rule():
    """All of an even length's padding at stride 2 goes on the right."""
    assert P._same_pad(256, 3, 2) == (0, 1)
    assert P._same_pad(255, 3, 2) == (1, 1)
    assert P._same_pad(256, 5, 1) == (2, 2)


@pytest.mark.parametrize("preset", ["ctc-tiny", "ctc-base"])
def test_forward_matches_jax(preset):
    cfg = J.PRESETS[preset]
    jparams = J.init_params(jax.random.PRNGKey(0), cfg)
    mel = np.random.default_rng(1).standard_normal((512, cfg.n_mels)).astype(np.float32)
    want = np.asarray(J.forward(jparams, cfg, jnp.asarray(mel)))
    got = P.forward(asr_params_from_jax_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
                    torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (128, cfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_config_vocab_and_presets_match_jax():
    assert P.VOCAB == J.VOCAB
    assert {k: v.to_dict() for k, v in P.PRESETS.items()} == {
        k: v.to_dict() for k, v in J.PRESETS.items()}
    d = dict(J.PRESETS["ctc-base"].to_dict(), unknown_key=1)
    assert P.ASRConfig.from_dict(d) == P.ASRConfig()
    for ref, hyp in (("hello world", "helo wrld"), ("", "x"), ("", ""), ("abc", "")):
        assert P.cer(ref, hyp) == J.cer(ref, hyp)
    assert P.default_checkpoint() == J.default_checkpoint()


def test_random_weights_follow_jax_scales():
    """``random:ctc-*``: N(0, fan_in^-0.5) conv and head weights, zero biases,
    unit gains, the same numbers for the same seed."""
    rec = P.CTCRecognizer.from_pretrained("random:ctc-base", seed=4, device="cpu")
    cfg, p = rec.cfg, rec.params
    for w, fan_in in ((p["down1"]["w"], 3 * cfg.n_mels), (p["down2"]["w"], 3 * cfg.channels),
                      (p["blocks"][0]["conv"]["w"], cfg.kernel * cfg.channels),
                      (p["head"]["w"], cfg.channels)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.05
    assert p["blocks"][0]["conv"]["w"].shape == (2 * cfg.channels, cfg.channels, cfg.kernel)
    assert not p["down1"]["b"].any() and bool((p["blocks"][1]["norm"] == 1).all())
    again = P.CTCRecognizer.from_pretrained("random:ctc-base", seed=4, device="cpu")
    assert torch.equal(again.params["head"]["w"], p["head"]["w"])


@pytest.mark.parametrize("sr,seconds", [(16_000, 1.0), (24_000, 1.0), (16_000, 2.2),
                                        (24_000, 3.5)])
def test_transcribe_matches_jax(sr, seconds):
    """One 256-frame bucket (1 s: 98 frames) and two (2.2 s, 3.5 s); 24 kHz
    resampled to the recognizer's 16 kHz."""
    jrec = _jax_rec()
    prec = _port_of(jrec)
    wav = _speechlike(sr, seconds, seed=int(seconds * 10))
    want = jrec.transcribe(wav, sr)
    assert prec.transcribe(wav, sr) == want
    assert len(prec.logits(wav, sr)) == -(-(1 + (int(seconds * 16_000) - 400) // 160) // 4)


def test_checkpoints_cross_load(tmp_path):
    """Each package loads the other's ``save_pretrained`` output leaf for
    leaf (conv weights in the JAX layout on disk), transcripts equal."""
    wav = _speechlike(16_000, 1.5, seed=5)
    jrec = _jax_rec(seed=3)
    jrec.save_pretrained(tmp_path / "jax")
    from_jax = P.CTCRecognizer.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert from_jax.transcribe(wav, 16_000) == jrec.transcribe(wav, 16_000)
    np.testing.assert_array_equal(from_jax.params["blocks"][0]["conv"]["w"].permute(2, 1, 0),
                                  np.asarray(jrec.params["blocks"][0]["conv"]["w"]))

    prec = P.CTCRecognizer.from_pretrained("random:ctc-tiny", seed=3, device="cpu")
    prec.save_pretrained(tmp_path / "port")
    from_port = J.CTCRecognizer.from_pretrained(str(tmp_path / "port"))
    assert from_port.transcribe(wav, 16_000) == prec.transcribe(wav, 16_000)
    np.testing.assert_array_equal(np.asarray(from_port.params["down1"]["w"]),
                                  prec.params["down1"]["w"].permute(2, 1, 0).numpy())
    assert json.loads((tmp_path / "port/config.json").read_text()) == prec.cfg.to_dict()


# ---------------------------------------------------------------------------
# the committed self-trained checkpoint
# ---------------------------------------------------------------------------

CKPT = REPO / "samples/asr/ctc_selftrained"
MANIFEST = REPO / "samples/asr/manifest.json"


@pytest.fixture(scope="module")
def committed_clips():
    """(reference text, wav, sr, JAX transcript) of each committed clip: the
    JAX recognizer runs once per module."""
    jrec = J.CTCRecognizer.from_pretrained(str(CKPT))
    out = []
    for e in json.loads(MANIFEST.read_text()):
        wav, sr = read_wav(str(REPO / "samples/asr" / e["wav"]))
        out.append((e["text"], wav, sr, jrec.transcribe(wav, sr)))
    return out


def test_committed_checkpoint_matches_jax_and_holds_cer_gate(committed_clips):
    recorded = json.loads((REPO / "samples/asr/metrics.json").read_text())[
        "eval_cer_heldout_perturbation"]
    rec = P.CTCRecognizer.from_pretrained(P.default_checkpoint(), device="cpu")
    assert rec.cfg == P.ASRConfig(channels=96, num_layers=3)
    assert len(committed_clips) == 16
    scores = []
    for text, wav, sr, want in committed_clips:
        got = rec.transcribe(wav, sr)
        assert got == want, (text, got, want)
        scores.append(P.cer(text, got))
    mean = float(np.mean(scores))
    # the JAX gate's bound (tests/test_asr.py): mel and resample numerics
    # differ slightly across hosts
    assert abs(mean - recorded) < 0.08, (mean, recorded, scores)
    assert mean < 0.7, (mean, scores)


# ---------------------------------------------------------------------------
# tests/test_asr.py, on the port
# ---------------------------------------------------------------------------

def test_greedy_ctc_decode_collapses_and_drops_blanks():
    c, a, t = P.VOCAB.index("c"), P.VOCAB.index("a"), P.VOCAB.index("t")
    assert P.greedy_ctc_decode(np.asarray([0, c, c, 0, a, a, a, 0, 0, t, 0])) == "cat"
    assert P.greedy_ctc_decode(np.asarray([a, 0, a])) == "aa"  # a repeat across a blank
    assert P.greedy_ctc_decode(np.asarray([0, 0, 0])) == ""


def test_resample_lengths():
    wav = np.random.RandomState(0).randn(24_000).astype(np.float32)
    assert len(P.resample(wav, 24_000, 16_000)) == 16_000
    assert np.array_equal(P.resample(wav, 16_000, 16_000), wav)


def test_transcribe_returns_text_and_is_deterministic():
    rec = P.CTCRecognizer.from_pretrained("random:ctc-tiny", device="cpu")
    wav = (0.1 * np.sin(np.linspace(0, 800, 24_000))).astype(np.float32)
    t1 = rec.transcribe(wav, 24_000)
    assert isinstance(t1, str) and t1 == rec.transcribe(wav, 24_000)
    assert isinstance(rec.transcribe(np.zeros(8_000, np.float32), 16_000), str)


def test_mel_bucketing_consistency():
    """The valid-length slice keeps the early transcript independent of the
    padding: appended silence only perturbs frames near the join."""
    rec = P.CTCRecognizer.from_pretrained("random:ctc-tiny", device="cpu")
    a = np.random.RandomState(1).randn(16_000).astype(np.float32) * 0.05
    long = np.concatenate([a, np.zeros(4_000, np.float32)])
    ta, tl = rec.transcribe(a, 16_000), rec.transcribe(long, 16_000)
    assert isinstance(ta, str) and isinstance(tl, str)
    assert ta[:12] == tl[:12]


def test_save_load_roundtrip(tmp_path):
    rec = P.CTCRecognizer.from_pretrained("random:ctc-tiny", seed=3, device="cpu")
    wav = np.random.RandomState(2).randn(16_000).astype(np.float32) * 0.05
    want = rec.transcribe(wav, 16_000)
    rec.save_pretrained(tmp_path / "asr")
    rec2 = P.CTCRecognizer.from_pretrained(str(tmp_path / "asr"), device="cpu")
    assert rec2.transcribe(wav, 16_000) == want


def test_demo_transcribe_endpoint(tmp_path):
    """``/transcribe`` answers 200 with text through the builtin hook."""
    import qwen3tts_tpu_torch.apps.demo_server as ds
    from qwen3tts_tpu_torch.audio.wav import write_wav

    httpd, _ = ds.serve(models=["random:tiny"], dtype="fp32", host="127.0.0.1", port=0,
                        asr=ds.resolve_asr("builtin:random:ctc-tiny", device="cpu"),
                        device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        sr = 16_000
        write_wav(tmp_path / "u.wav", (0.1 * np.sin(np.linspace(0, 600, sr))).astype(np.float32),
                  sr)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/transcribe",
            data=(tmp_path / "u.wav").read_bytes(), headers={"Content-Type": "audio/wav"},
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert r.status == 200 and isinstance(body["text"], str)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_resolve_asr_specs():
    import qwen3tts_tpu_torch.apps.demo_server as ds

    assert ds.resolve_asr(None) is None
    assert ds.resolve_asr("none") is None
    hook = ds.resolve_asr("builtin:random:ctc-tiny", device="cpu")
    assert callable(hook) and isinstance(hook(np.zeros(16_000, np.float32), 16_000), str)
    # module:callable takes any (audio, sr) -> str
    assert ds.resolve_asr("qwen3tts_tpu_torch.models.asr:cer") is P.cer
