"""PyTorch port of the codec decoder: full decode vs the JAX package (tiny
codec, float32, weights through ``bundle_from_jax_numpy``), and the port's
chained ``decode_stream`` vs its own full ``decode``.

Codes come from numpy.random.default_rng.  Tolerances: 1e-5 against JAX
(float32 convs summed in another order), 1e-6 stream vs full (the same
convs; only the overlap-add split differs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.models import codec as JC  # noqa: E402
from qwen3tts_tpu_torch.audio.vocoder import Vocoder  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models import codec as TC  # noqa: E402


def _nonzero_snake(tree, rng):
    """The initialisers zero every SnakeBeta alpha/beta and every bias;
    randomise them (small, so the waveform stays mostly inside the clip
    range) so the test exercises the whole function."""
    scale = {"alpha": 0.1, "beta": 0.1, "alpha1": 0.1, "beta1": 0.1, "alpha2": 0.1,
             "beta2": 0.1, "out_alpha": 0.1, "out_beta": 0.1, "b": 0.002}
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(np.shape(v)).astype(np.float32) * scale[k]
                    if k in scale else _nonzero_snake(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_nonzero_snake(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def codec_pair():
    cfg = get_preset("tiny").codec
    jparams = jax.tree.map(np.asarray, JC.init_params(jax.random.PRNGKey(9), cfg, jnp.float32))
    jparams = {"decoder": _nonzero_snake(jparams["decoder"], np.random.default_rng(5)),
               "encoder": jparams["encoder"]}
    tparams = bundle_from_jax_numpy({"codec": jparams}, get_preset("tiny"),
                                    device="cpu")["codec"]
    return cfg, jparams, tparams


def _codes(cfg, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.codebook_size, (1, T, 16))


def test_decode_matches_jax(codec_pair):
    cfg, jparams, tparams = codec_pair
    codes = _codes(cfg, 7, 0)
    want = np.asarray(jax.jit(lambda p, c: JC.decode(p, cfg, c))(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(codes, jnp.int32)))
    got = TC.decode(tparams, cfg, torch.from_numpy(codes)).numpy()
    assert got.shape == (1, 7 * cfg.total_upsample)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_stream_chunks_equal_full_decode(codec_pair):
    cfg, _, tparams = codec_pair
    codes = torch.from_numpy(_codes(cfg, 16, 1))
    full = TC.decode(tparams, cfg, codes).numpy()
    st = TC.stream_init(tparams, cfg, 1)
    outs, i = [], 0
    for n in (3, 5, 1, 7):
        wav, st = TC.decode_stream(tparams, cfg, st, codes[:, i:i + n])
        outs.append(wav.numpy())
        i += n
    stream = np.concatenate(outs, axis=1)
    assert stream.shape == full.shape
    np.testing.assert_allclose(stream, full, atol=1e-6)
    assert int(st["frame0"][0]) == 16


def test_vocoder_bf16_stream_and_decode(codec_pair):
    cfg, _, tparams = codec_pair
    voc = Vocoder(tparams, cfg)  # bf16 compute, f32 weights cast once
    assert voc.params["decoder"]["dec_in"]["w"].dtype == torch.bfloat16
    codes = _codes(cfg, 10, 2)[0]
    full = voc.decode(codes)
    st = voc.stream_state()
    a1, st = voc.stream_feed(st, codes[:4])
    a2, st = voc.stream_feed(st, codes[4:])
    stream = np.concatenate([a1, a2])
    assert full.shape == stream.shape == (10 * voc.spf,)
    assert np.isfinite(full).all() and np.abs(full).max() <= 1.0
    # bf16 keeps 8 significant bits: at |wav| <= 0.13 one rounding is ~5e-4,
    # and the stack rounds some twenty times
    np.testing.assert_allclose(stream, full, atol=5e-3)
    f32 = TC.decode(tparams, cfg, torch.from_numpy(codes)[None])[0].numpy()
    np.testing.assert_allclose(full, f32, atol=5e-3)


# ---------------------------------------------------------------------------
# the fixed-window StreamDecoder (JAX tests/test_codec.py:67 and :139), held
# against the JAX decoder on the same codes, both in float32.  Tolerance
# 1e-4 (JAX's own for the primed suffix): the biases of 0.05 drive this
# waveform to the clip at +-1, and at that amplitude the deep conv stack
# summed in another order (another package, or another padded length) moves
# samples by up to 3e-5
# ---------------------------------------------------------------------------

STREAM_ATOL = 1e-4

_BIAS_KEYS = ("b", "norm_b", "beta1", "beta2", "out_beta", "beta")


def _perturb_biases(tree, eps=0.05):
    """Every bias / offset leaf moved by ``eps`` (JAX tests/test_codec.py
    ``_perturb_biases``): a padding scheme exact only for zero biases would
    show."""
    if isinstance(tree, dict):
        return {k: (v + eps if k in _BIAS_KEYS else _perturb_biases(v, eps))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb_biases(v, eps) for v in tree]
    return tree


@pytest.fixture(scope="module")
def stream_pair():
    """The JAX test's codec: ``init_params(PRNGKey(0))`` with every bias
    moved by 0.05."""
    from qwen3tts_tpu.audio.vocoder import Vocoder as JVocoder

    cfg = get_preset("tiny").codec
    jp = jax.tree.map(np.asarray, JC.init_params(jax.random.PRNGKey(0), cfg, jnp.float32))
    jp = {"decoder": _perturb_biases(jp["decoder"]), "encoder": jp["encoder"]}
    tp = bundle_from_jax_numpy({"codec": jp}, get_preset("tiny"), device="cpu")["codec"]
    jv = JVocoder(jax.tree.map(jnp.asarray, jp), cfg, context_frames=25,
                  compute_dtype=jnp.float32)
    return cfg, jv, Vocoder(tp, cfg, context_frames=25, compute_dtype=None)


def test_stream_decoder_exact_with_nonzero_biases(stream_pair):
    cfg, jv, tv = stream_pair
    codes = _codes(cfg, 18, 11)[0]
    full, jfull = tv.decode(codes), jv.decode(codes)
    np.testing.assert_allclose(full, jfull, atol=STREAM_ATOL)
    sd, jsd = tv.stream_decoder(chunk_size=6), jv.stream_decoder(chunk_size=6)
    assert sd.window == jsd.window == 31
    outs = [sd.feed(codes[i: i + 6]) for i in range(0, 18, 6)]
    jouts = [jsd.feed(codes[i: i + 6]) for i in range(0, 18, 6)]
    assert np.concatenate(outs).shape == full.shape
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o, jo, atol=STREAM_ATOL)
    # the window covers every frame fed so far: the stream is the full decode
    np.testing.assert_allclose(np.concatenate(outs), full, atol=STREAM_ATOL)
    assert sd.feed(codes[:0]).shape == (0,)


def test_stream_decoder_chunk_longer_than_window(stream_pair):
    """A chunk longer than the window decodes everything so far (right-padded
    to its bucket) and returns the new frames' samples."""
    cfg, jv, tv = stream_pair
    short = Vocoder(tv.params, cfg, context_frames=2, compute_dtype=None)
    codes = _codes(cfg, 11, 12)[0]
    sd = short.stream_decoder(chunk_size=3)
    first, second = sd.feed(codes[:3]), sd.feed(codes[3:])  # 8 frames > window 5
    assert second.shape == (8 * cfg.total_upsample,) and sd.n_emitted_frames == 11
    np.testing.assert_allclose(second, jv.decode(codes)[3 * cfg.total_upsample:], atol=STREAM_ATOL)
    np.testing.assert_allclose(first, jv.decode(codes[:3]), atol=STREAM_ATOL)


def test_stream_decoder_icl_priming(stream_pair):
    """Priming with reference codes gives the next chunk real left context:
    its output differs from an unprimed feed, holds only the new frames'
    samples and equals the suffix of a full decode of reference + new."""
    cfg, jv, tv = stream_pair
    ref, gen = _codes(cfg, 10, 5)[0], _codes(cfg, 6, 6)[0]
    primed = tv.stream_decoder(chunk_size=6)
    primed.feed(ref)
    out_primed = primed.feed(gen)
    out_unprimed = tv.stream_decoder(chunk_size=6).feed(gen)
    assert out_primed.shape == out_unprimed.shape == (6 * cfg.total_upsample,)
    assert not np.allclose(out_primed, out_unprimed)
    full = jv.decode(np.concatenate([ref, gen]))
    np.testing.assert_allclose(out_primed, full[10 * cfg.total_upsample:], atol=STREAM_ATOL)
    jprimed = jv.stream_decoder(chunk_size=6)
    jprimed.feed(ref)
    np.testing.assert_allclose(out_primed, jprimed.feed(gen), atol=STREAM_ATOL)


def test_stateful_stream_decoder_factory(stream_pair):
    cfg, jv, tv = stream_pair
    codes = _codes(cfg, 14, 13)[0]
    sd = tv.stateful_stream_decoder()
    stream = np.concatenate([sd.feed(codes[i: i + 5]) for i in range(0, 14, 5)])
    np.testing.assert_allclose(stream, jv.decode(codes), atol=STREAM_ATOL)
