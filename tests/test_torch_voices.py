"""Custom voice, voice design and long form in the PyTorch port, against the
JAX package (tiny-custom / tiny-design presets, float32, one set of weights
through ``bundle_from_jax_numpy``, inputs from numpy seeds).

- ``_prepare_custom`` within 1e-5 of JAX's, with a speaker, with a speaker
  and ``instruct``, and with ``instruct`` alone (voice design); greedy
  ``Engine`` tokens from those prompts equal JAX's.
- The guards raise what JAX's raise: ``ValueError`` for a model of another
  type, ``NotImplementedError`` for an unknown speaker or language and for
  ``generate``; a 0.6B custom-voice model drops ``instruct``.
- The four entry points return ``steps x samples-per-frame`` audio.
- Long form: ``split_sentences`` equals JAX's; with
  ``condition_on_previous=True`` the second segment is an ICL clone of the
  first segment's audio and text (cached under the sha1 of its samples);
  the output is the segments plus the gaps; the streamed variant tags its
  chunks with ``segment`` and ``is_gap``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu import FasterQwen3TTS as JFasterQwen3TTS  # noqa: E402
from qwen3tts_tpu.api import longform as jlongform  # noqa: E402
from qwen3tts_tpu.core.presets import get_preset as jget_preset  # noqa: E402
from qwen3tts_tpu.models.predictor import SamplingPolicy as JSamplingPolicy  # noqa: E402
from qwen3tts_tpu.runtime.engine import Engine as JEngine  # noqa: E402
from qwen3tts_tpu.runtime.engine import GenerationPolicy as JGenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.api import longform  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy  # noqa: E402

TEXT = "hello there, a voice of my own"
INSTRUCT = "a warm, slow voice"


@pytest.fixture(scope="module")
def pairs():
    """{preset: (JAX model, port model)} for tiny, tiny-custom and
    tiny-design, all on the same float32 weights."""
    jm = JFasterQwen3TTS.from_pretrained("random:tiny")
    np_params = jax.tree.map(np.asarray, jm.params)
    out = {}
    for name in ("tiny", "tiny-custom", "tiny-design"):
        cfg = get_preset(name)
        params = bundle_from_jax_numpy(np_params, cfg, torch.float32, "cpu")
        out[name] = (JFasterQwen3TTS(jget_preset(name), jm.params, max_seq_len=128),
                     FasterQwen3TTS(cfg, params, max_seq_len=128))
    return out


def _speaker(model):
    return sorted(model.cfg.talker.spk_id)[0]


PROMPTS = {"speaker": ("tiny-custom", True, None),
           "speaker+instruct": ("tiny-custom", True, INSTRUCT),
           "design": ("tiny-design", False, INSTRUCT)}


def _prompt(model, case):
    _, with_speaker, instruct = PROMPTS[case]
    return model._prepare_custom(TEXT, "English", _speaker(model) if with_speaker else None,
                                 instruct)


@pytest.mark.parametrize("case", list(PROMPTS))
def test_custom_prompt_matches_jax(pairs, case):
    jm, tm = pairs[PROMPTS[case][0]]
    got, want = _prompt(tm, case), _prompt(jm, case)
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["speaker+instruct", "design"])
def test_greedy_engine_tokens_equal_jax(pairs, case):
    jm, tm = pairs[PROMPTS[case][0]]
    embeds, trailing, tpe = _prompt(tm, case)
    steps = 16
    jeng = JEngine(jm.engine.talker_params, jm.engine.predictor_params, jm.cfg,
                   max_seq_len=128)
    jpol = JGenerationPolicy(do_sample=False, min_new_tokens=steps)
    jppol = JSamplingPolicy(do_sample=False)
    js = jeng.prefill(embeds, jax.random.PRNGKey(0), jpol, jppol)
    eng = Engine(tm.params["talker"], tm.params["predictor"], tm.cfg, max_seq_len=128)
    ts = eng.prefill(embeds, None, GenerationPolicy(do_sample=False, min_new_tokens=steps),
                     SamplingPolicy(do_sample=False))
    np.testing.assert_array_equal(ts["token"].numpy(), np.asarray(js["token"]))
    Tt = trailing.shape[1]
    for _ in range(steps // 8):
        js, jf, _, jlens, _ = jeng.decode_chunk(js, jnp.asarray(trailing), Tt,
                                                jnp.asarray(tpe), jpol, jppol, 8)
        ts, f, _, lens, _ = eng.decode_chunk(ts, torch.from_numpy(trailing), Tt,
                                             torch.from_numpy(tpe), 8)
        assert int(lens[0]) == int(np.asarray(jlens)[0]) == 8
        np.testing.assert_array_equal(f[0].numpy(), np.asarray(jf)[0])


GUARDS = {
    "custom on a base model": ("tiny", "generate_custom_voice", (TEXT, "aiden", "English"),
                               ValueError),
    "design on a custom model": ("tiny-custom", "generate_voice_design",
                                 (TEXT, INSTRUCT, "English"), ValueError),
    "unknown speaker": ("tiny-custom", "generate_custom_voice", (TEXT, "nobody", "English"),
                        NotImplementedError),
    "unknown language": ("tiny-custom", "generate_custom_voice", (TEXT, "aiden", "Klingon"),
                         NotImplementedError),
    "design, unknown language": ("tiny-design", "generate_voice_design_streaming",
                                 (TEXT, INSTRUCT, "Klingon"), NotImplementedError),
    "streamed custom on a design model": ("tiny-design", "generate_custom_voice_streaming",
                                          (TEXT, "aiden", "English"), ValueError),
    "generate": ("tiny", "generate", (TEXT,), NotImplementedError),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_guards_raise_as_jax(pairs, case):
    preset, method, args, exc = GUARDS[case]
    for model in pairs[preset]:
        with pytest.raises(exc):
            out = getattr(model, method)(*args, max_new_tokens=4) if method != "generate" \
                else model.generate(*args)
            if method.endswith("_streaming"):
                next(out)


def test_06b_custom_voice_drops_instruct(pairs):
    jm, tm = pairs["tiny-custom"]
    spk = _speaker(tm)
    assert tm._custom_prompt(TEXT, spk, "English", INSTRUCT)[0].shape[1] > \
        tm._prepare_custom(TEXT, "English", spk, None)[0].shape[1]  # the tiny model keeps it
    m06 = FasterQwen3TTS(dataclasses.replace(tm.cfg, model_size="0.6b"), tm.params,
                         max_seq_len=128)
    got = m06._custom_prompt(TEXT, spk, "English", INSTRUCT)
    want = jm._prepare_custom(TEXT, "English", spk, None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("streamed", [False, True])
def test_entry_points_audio_length(pairs, streamed):
    steps = 10
    kw = dict(max_new_tokens=steps, min_new_tokens=steps)
    custom, design = pairs["tiny-custom"][1], pairs["tiny-design"][1]
    spf = custom.vocoder.spf
    calls = [(custom.generate_custom_voice, (TEXT, _speaker(custom), "English")),
             (design.generate_voice_design, (TEXT, INSTRUCT, "English"))]
    for fn, args in calls:
        if streamed:
            fn = getattr(fn.__self__, fn.__name__ + "_streaming")
            out = list(fn(*args, chunk_size=4, **kw))
            assert [a.shape[0] for a, _, _ in out] == [4 * spf, 4 * spf, 2 * spf]
            assert out[-1][2]["is_final"]
            audio = np.concatenate([a for a, _, _ in out])
        else:
            wavs, sr = fn(*args, **kw)
            audio = wavs[0]
            assert sr == 24_000
        assert audio.shape == (steps * spf,) and np.isfinite(audio).all()


TEXTS = [
    "",
    "One sentence.",
    "First sentence here. Second one follows! Is this the third? Yes.",
    "A very long sentence without any stop that goes on and on " * 8,
    "你好。今天天气很好！我们去公园吧？好的",
    "Mixed text. 中文句子。Another one!",
]


@pytest.mark.parametrize("max_chars", [300, 40, 12])
def test_split_sentences_matches_jax(max_chars):
    for text in TEXTS:
        assert longform.split_sentences(text, max_chars) == \
            jlongform.split_sentences(text, max_chars), text


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    from qwen3tts_tpu_torch.audio.wav import write_wav

    path = tmp_path_factory.mktemp("voices") / "ref.wav"
    t = np.arange(12_000, dtype=np.float32) / 24_000
    write_wav(path, (0.3 * np.sin(2 * np.pi * 200 * t)).astype(np.float32), 24_000)
    return str(path)


LONG = "The first group is here. The second group follows it. And a third one ends it."


def test_longform_conditions_on_the_previous_segment(pairs, ref_wav, monkeypatch):
    tm = pairs["tiny"][1]
    calls = []
    real = tm.generate_voice_clone

    def spy(text, language, ra, rt, **kw):
        out = real(text, language, ra, rt, **kw)
        calls.append((text, ra, rt, kw, out[0][0]))
        return out

    monkeypatch.setattr(tm, "generate_voice_clone", spy)
    steps, spf = 6, tm.vocoder.spf
    audio, sr = longform.generate_longform(
        tm, LONG, "English", ref_wav, "", max_chars=30, gap_ms=100,
        condition_on_previous=True, max_new_tokens=steps, min_new_tokens=steps)
    groups = longform.split_sentences(LONG, 30)
    assert [c[0] for c in calls] == groups and len(groups) == 3
    assert calls[0][1] == ref_wav and "xvec_only" not in calls[0][3]
    for prev, cur in zip(calls, calls[1:]):
        ra, rt, kw = cur[1:4]
        assert isinstance(ra, tuple) and ra[1] == sr
        np.testing.assert_array_equal(ra[0], prev[4])
        assert rt == prev[0] and kw["xvec_only"] is False
    import hashlib

    key = (hashlib.sha1(calls[0][4].astype(np.float32).tobytes()).hexdigest(), groups[0],
           False, True)
    assert tm._voice_prompt_cache[key]["ref_code"].shape == (steps + 6, 16)  # + 0.5 s silence
    gap = int(0.1 * sr)
    assert audio.shape == (3 * steps * spf + 2 * gap,)
    np.testing.assert_array_equal(audio[steps * spf: steps * spf + gap], 0.0)


def test_longform_streaming_tags_segments_and_gaps(pairs, ref_wav):
    tm = pairs["tiny"][1]
    steps, spf = 6, tm.vocoder.spf
    out = list(longform.generate_longform_streaming(
        tm, LONG, "English", ref_wav, "", max_chars=30, gap_ms=100, chunk_size=4,
        max_new_tokens=steps, min_new_tokens=steps))
    tags = [(t["segment"], t["is_gap"]) for _, _, t in out]
    assert tags == [(0, False), (0, False), (1, True), (1, False), (1, False), (2, True),
                    (2, False), (2, False)]
    assert [len(a) for a, _, _ in out if len(a) != int(0.1 * 24_000)] == \
        [4 * spf, 2 * spf] * 3
