"""ICL voice clone in the PyTorch port against the JAX package (tiny preset,
float32, weights through ``bundle_from_jax_numpy``, inputs from numpy
seeds).

- The codec encoder: the pre-RVQ hidden within 1e-5 of JAX's; the codes
  equal JAX's at every frame where the best and second-best RVQ distances
  are more than 1e-4 apart relative to the terms they cancel (a closer pair
  can flip with the summation order; most frames must qualify); the same
  through ``Vocoder.encode`` at float32, with a trailing partial frame and
  with no whole frame; the bridge keeps every encoder leaf bit for bit;
  ``init_random`` draws the encoder in JAX's shapes and scales.
- The ICL prompt of ``_prepare_clone(xvec_only=False)`` within 1e-5 of
  JAX's (streaming and non-streaming text layout), the reference codes
  equal, and greedy ``Engine`` tokens from it equal JAX's.
- Priming: the codec stream primed with the reference codes gives the
  trimmed full decode within 1e-5, its state is JAX's ``vocode_prime``
  state within 1e-5, and the streamed ICL loop's audio equals the
  non-streamed audio of the same greedy frames within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu import FasterQwen3TTS as JFasterQwen3TTS  # noqa: E402
from qwen3tts_tpu.audio.vocoder import Vocoder as JVocoder  # noqa: E402
from qwen3tts_tpu.models import codec as JC  # noqa: E402
from qwen3tts_tpu.models.predictor import SamplingPolicy as JSamplingPolicy  # noqa: E402
from qwen3tts_tpu.runtime.engine import Engine as JEngine  # noqa: E402
from qwen3tts_tpu.runtime.engine import GenerationPolicy as JGenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.audio.vocoder import Vocoder  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models import codec as TC  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime import loops  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy  # noqa: E402

CFG = get_preset("tiny")
CLEAR = 1e-4  # relative RVQ margin above which a code must not flip


def _randomised(tree, rng):
    """The initialisers zero every SnakeBeta alpha/beta and every bias:
    randomise them (small) so the whole function is exercised."""
    scale = {"alpha": 0.1, "beta": 0.1, "alpha1": 0.1, "beta1": 0.1, "alpha2": 0.1,
             "beta2": 0.1, "out_alpha": 0.1, "out_beta": 0.1, "b": 0.002}
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(np.shape(v)).astype(np.float32) * scale[k]
                    if k in scale else _randomised(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomised(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def codec_pair():
    jparams = jax.tree.map(np.asarray, JC.init_params(jax.random.PRNGKey(9), CFG.codec,
                                                      jnp.float32))
    jparams = _randomised(jparams, np.random.default_rng(5))
    tparams = bundle_from_jax_numpy({"codec": jparams}, CFG, device="cpu")["codec"]
    return jparams, tparams


def _jax_hidden(params, wav):
    """JAX ``codec.encode`` up to its RVQ (the same calls, in order)."""
    cfg, enc = CFG.codec, params["encoder"]
    T = wav.shape[1] // cfg.total_upsample
    h = wav[:, : T * cfg.total_upsample, None]
    h = JC.causal_conv(h, enc["in_conv"]["w"], enc["in_conv"]["b"])
    rates = list(cfg.upsampling_ratios)[::-1] + list(cfg.upsample_rates)[::-1]
    for st, r in zip(enc["stages"], rates):
        h = JC.snake_beta(h, st["alpha"], st["beta"])
        h = JC.causal_conv(h, st["conv"]["w"], st["conv"]["b"], stride=r)
    h = h @ enc["proj"]["w"] + enc["proj"]["b"]
    return JC._pre_transformer(enc["transformer"], h, cfg)


def _clear_frames(hidden, codebooks):
    """Frames whose every RVQ choice, along JAX's hidden, clears CLEAR."""
    _, margins = TC.rvq(torch.from_numpy(np.array(hidden)), codebooks)
    return (margins >= CLEAR).all(-1)[0].numpy()


def _wav(frames, extra, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(frames * CFG.codec.total_upsample + extra) * 0.2
            ).astype(np.float32)


def test_encode_matches_jax(codec_pair):
    jparams, tparams = codec_pair
    wav = _wav(24, 700, 1)[None]
    jp = jax.tree.map(jnp.asarray, jparams)
    want_h = np.asarray(jax.jit(_jax_hidden)(jp, jnp.asarray(wav)))
    got_h = TC.encode_hidden(tparams, CFG.codec, torch.from_numpy(wav)).numpy()
    assert got_h.shape == want_h.shape == (1, 24, CFG.codec.hidden_size)
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=1e-5)

    want = np.asarray(jax.jit(lambda p, w: JC.encode(p, CFG.codec, w))(jp, jnp.asarray(wav)))
    got = TC.encode(tparams, CFG.codec, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 24, 16) and got.dtype == np.int32
    clear = _clear_frames(want_h, tparams["encoder"]["codebooks"])
    assert clear.sum() >= 0.8 * len(clear)
    np.testing.assert_array_equal(got[0, clear], want[0, clear])


@pytest.mark.parametrize("frames,extra", [(10, 1234), (3, 0), (0, 1999)])
def test_vocoder_encode_matches_jax(codec_pair, frames, extra):
    jparams, tparams = codec_pair
    wav = _wav(frames, extra, 2 + frames)
    want = JVocoder(jax.tree.map(jnp.asarray, jparams), CFG.codec,
                    compute_dtype=jnp.float32).encode(wav)
    got = Vocoder(tparams, CFG.codec, compute_dtype=torch.float32).encode(wav)
    assert got.shape == want.shape == (frames, 16) and got.dtype == np.int32
    if frames:
        hidden = jax.jit(_jax_hidden)(jax.tree.map(jnp.asarray, jparams),
                                      jnp.asarray(wav[None]))
        clear = _clear_frames(hidden, tparams["encoder"]["codebooks"])
        assert clear.sum() >= 0.8 * frames
        np.testing.assert_array_equal(got[clear], want[clear])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _is_conv(path):
    return path[-1] == "w" and path[-2] in ("conv", "in_conv")


def test_bridge_keeps_every_encoder_leaf(codec_pair):
    jparams, tparams = codec_pair
    got = dict(_leaves(tparams["encoder"]))
    want = dict(_leaves(jparams["encoder"]))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.transpose(w, (2, 1, 0)) if _is_conv(path) else w
        g = got[path]
        assert g.dtype == torch.float32 and g.is_contiguous(), path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


def test_init_random_encoder_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    got = dict(_leaves(TC.init_params(gen, CFG.codec, torch.float32, "cpu")["encoder"]))
    want = dict(_leaves(JC.init_params(jax.random.PRNGKey(0), CFG.codec,
                                       jnp.float32)["encoder"]))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.transpose(w, (2, 1, 0)) if _is_conv(path) else np.asarray(w)
        g = got[path].numpy()
        assert g.shape == w.shape, path
        if w.size >= 1000:  # a drawn tensor: the same initialiser scale
            assert abs(g.std() / w.std() - 1) < 0.1, path
        else:
            np.testing.assert_array_equal(g == 0, w == 0, err_msg=str(path))


# ---------------------------------------------------------------------------
# the ICL prompt, the engine and priming, through the API classes
# ---------------------------------------------------------------------------

REF_TEXT = "a reference transcript"
TEXT = "hello there, this is the target text"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX and the port's API class on the same tiny weights, both with
    a float32 vocoder, and a 1 s reference wav."""
    from qwen3tts_tpu_torch.audio.wav import write_wav

    jm = JFasterQwen3TTS.from_pretrained("random:tiny")
    jm = JFasterQwen3TTS(jm.cfg, jm.params, max_seq_len=128,
                         vocoder_compute_dtype=jnp.float32)
    params = bundle_from_jax_numpy(jax.tree.map(np.asarray, jm.params), CFG, torch.float32,
                                   "cpu")
    tm = FasterQwen3TTS(CFG, params, max_seq_len=128, vocoder_compute_dtype=torch.float32)
    path = tmp_path_factory.mktemp("icl") / "ref.wav"
    t = np.arange(24_000, dtype=np.float32) / 24_000
    write_wav(path, (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(9 * t))
                     ).astype(np.float32), 24_000)
    return jm, tm, str(path)


def _icl(tm, path, non_streaming_mode=True):
    return tm._prepare_clone(TEXT, path, REF_TEXT, "English", False, non_streaming_mode,
                             True, None)


@pytest.mark.parametrize("non_streaming_mode", [True, False])
def test_icl_prompt_matches_jax(models, non_streaming_mode):
    jm, tm, path = models
    want = jm._prepare_clone(TEXT, path, REF_TEXT, "English", False, non_streaming_mode,
                             True, None, device=False)
    got = _icl(tm, path, non_streaming_mode)
    ref = got[3]
    assert ref.shape == (18, 16)  # 1 s + 0.5 s of silence at 12 frames a second
    np.testing.assert_array_equal(ref, np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
    # the prompt carries the reference frames: longer than the x-vector one
    assert got[0].shape[1] > tm._prepare_clone(TEXT, path, REF_TEXT, "English", True,
                                               non_streaming_mode, True, None)[0].shape[1]


def _greedy_frames_both(jm, tm, embeds, trailing, tpe, steps=24):
    jeng = JEngine(jm.engine.talker_params, jm.engine.predictor_params, jm.cfg,
                   max_seq_len=128)
    jpol = JGenerationPolicy(do_sample=False, min_new_tokens=steps)
    jppol = JSamplingPolicy(do_sample=False)
    js = jeng.prefill(np.asarray(embeds), jax.random.PRNGKey(0), jpol, jppol)
    want = [np.asarray(js["token"])]
    eng = Engine(tm.params["talker"], tm.params["predictor"], CFG, max_seq_len=128)
    ts = eng.prefill(embeds, None, GenerationPolicy(do_sample=False, min_new_tokens=steps),
                     SamplingPolicy(do_sample=False))
    got = [ts["token"].numpy()]
    Tt = trailing.shape[1]
    for _ in range(steps // 8):
        js, f, _, lens, _ = jeng.decode_chunk(js, jnp.asarray(trailing), Tt, jnp.asarray(tpe),
                                              jpol, jppol, 8)
        want.append(np.asarray(f)[0, : int(np.asarray(lens)[0])])
        ts, f, _, lens, _ = eng.decode_chunk(ts, torch.from_numpy(trailing), Tt,
                                             torch.from_numpy(tpe), 8)
        got.append(f[0, : int(lens[0])].numpy())
    return got, want


def test_icl_greedy_engine_tokens_equal_jax(models):
    jm, tm, path = models
    embeds, trailing, tpe, _ = _icl(tm, path, non_streaming_mode=False)
    got, want = _greedy_frames_both(jm, tm, embeds, trailing, tpe)
    assert sum(len(g) for g in got[1:]) == 24
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _timing(steps):
    return {"steps": steps, "prefill_ms": 1.0, "decode_s": 1.0, "ms_per_step": 1.0}


def test_primed_stream_equals_trimmed_full_decode(models):
    _, tm, path = models
    ref = _icl(tm, path)[3]
    codes = np.random.default_rng(3).integers(0, CFG.codec.codebook_size, (11, 16))
    voc = tm.vocoder
    state = tm.engine.vocode_prime(voc, voc.stream_state(), ref)
    audio = []
    for part in np.split(codes, [4, 8]):
        a, state = voc.stream_feed(state, part)
        audio.append(a)
    want = tm._finish_audio(codes, ref, _timing(11))[0][0]
    assert want.shape == (11 * voc.spf,)
    np.testing.assert_allclose(np.concatenate(audio), want, rtol=0, atol=1e-5)


def _port_layout(js):
    """JAX's stream state (conv carries [B, K, C]) in the port's layout
    ([B, C, K]); the attention windows and the frame counter as they are."""
    t = lambda a: np.swapaxes(np.asarray(a), 1, 2)  # noqa: E731
    return {"frame0": np.asarray(js["frame0"]),
            "xf_k": [np.asarray(a) for a in js["xf_k"]],
            "xf_v": [np.asarray(a) for a in js["xf_v"]],
            "up": [{"tail": t(u["tail"]), "cnx": t(u["cnx"])} for u in js["up"]],
            "dec_in": t(js["dec_in"]),
            "blocks": [{"tail": t(b["tail"]), "units": [t(u) for u in b["units"]]}
                       for b in js["blocks"]],
            "out": t(js["out"])}


def test_primed_state_matches_jax(models):
    jm, tm, path = models
    ref = _icl(tm, path)[3]
    want = dict(_leaves(_port_layout(
        jm.engine.vocode_prime(jm.vocoder, jm.vocoder.stream_state(), ref))))
    got = dict(_leaves(tm.engine.vocode_prime(tm.vocoder, tm.vocoder.stream_state(), ref)))
    assert set(got) == set(want)
    assert int(got[("frame0",)][0]) == len(ref)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].float().numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=str(k))


def test_streamed_icl_audio_equals_non_streamed(models):
    _, tm, path = models
    embeds, trailing, tpe, ref = _icl(tm, path)
    frames, audio = [], []
    for f, a, _ in loops.fast_generate_streaming_audio(
            tm.engine, tm.vocoder, embeds, trailing, tpe, generator=None, max_new_tokens=20,
            policy=GenerationPolicy(do_sample=False, min_new_tokens=20),
            pred_policy=SamplingPolicy(do_sample=False), chunk_size=8, ref_codes=ref):
        frames.append(f)
        audio.append(a)
    frames = np.concatenate(frames)
    assert frames.shape == (20, 16)
    want = tm._finish_audio(frames, ref, _timing(20))[0][0]
    np.testing.assert_allclose(np.concatenate(audio), want, rtol=0, atol=1e-5)
