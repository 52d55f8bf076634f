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
