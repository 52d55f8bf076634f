"""The port's Engine gives every live request its own KV cache.

Two streaming generators of one Engine, advanced in turn, must each give the
JAX Engine's greedy tokens for their own prompt run alone (tiny float32,
weights through ``bundle_from_jax_numpy``): a cache shared between live
requests lets the second prefill overwrite the first request's rows.  A
finished or closed stream, and ``fast_generate``, hand their cache back to a
pool that holds at most one, and the next request takes it from there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402

from qwen3tts_tpu.models.predictor import SamplingPolicy as JSamplingPolicy  # noqa: E402
from qwen3tts_tpu.runtime.engine import Engine as JEngine  # noqa: E402
from qwen3tts_tpu.runtime.engine import GenerationPolicy as JGenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime import loops  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy  # noqa: E402

STEPS, CHUNK, MAX_SEQ = 24, 8, 64
POLICY = dict(do_sample=False, min_new_tokens=STEPS)  # greedy, no early EOS


def _prompt(seed: int, T: int, H: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) * 0.1
                 for s in ((1, T, H), (1, 5, H), (1, 1, H)))


def _jax_frames(tp, pp, cfg, prompt):
    """The JAX Engine's frames [STEPS, 16] for one prompt, run alone."""
    embeds, tth, tpe = prompt
    jeng = JEngine(tp, pp, cfg, max_seq_len=MAX_SEQ)
    jpol, jppol = JGenerationPolicy(**POLICY), JSamplingPolicy(do_sample=False)
    state = jeng.prefill(embeds, jax.random.PRNGKey(0), jpol, jppol)
    frames = []
    for _ in range(STEPS // CHUNK):
        state, f, _, lens, _ = jeng.decode_chunk(
            state, jax.numpy.asarray(tth), tth.shape[1], jax.numpy.asarray(tpe), jpol, jppol,
            CHUNK)
        frames.append(np.asarray(f)[0, : int(np.asarray(lens)[0])])
    return np.concatenate(frames)


@pytest.fixture(scope="module")
def port(tiny_cfg, tiny_models):
    """(the port's Engine on the JAX weights, a vocoder, JAX frames per prompt)."""
    tp, pp = tiny_models
    cfg = get_preset("tiny")
    params = bundle_from_jax_numpy({"talker": jax.tree.map(np.asarray, tp),
                                    "predictor": jax.tree.map(np.asarray, pp)},
                                   cfg, torch.float32, "cpu")
    eng = Engine(params["talker"], params["predictor"], cfg, max_seq_len=MAX_SEQ)
    vocoder = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu").vocoder
    H = cfg.talker.hidden_size
    prompts = {"a": _prompt(1, 10, H), "b": _prompt(2, 12, H)}
    want = {k: _jax_frames(tp, pp, tiny_cfg, p) for k, p in prompts.items()}
    return eng, vocoder, prompts, want


def _stream(eng, vocoder, prompt):
    return loops.fast_generate_streaming_audio(
        eng, vocoder, *prompt, generator=None, max_new_tokens=STEPS,
        policy=GenerationPolicy(**POLICY), pred_policy=SamplingPolicy(do_sample=False),
        chunk_size=CHUNK)


def test_interleaved_streams_each_match_jax(port):
    """Chunk by chunk, a, b, a, b, ...: each stream's frames equal the JAX
    Engine's for its own prompt.  While both live, neither cache is pooled;
    when both have ended, the pool holds one."""
    eng, vocoder, prompts, want = port
    eng._kv_pool.clear()
    streams = {k: _stream(eng, vocoder, p) for k, p in prompts.items()}
    got = {k: [] for k in streams}
    for _ in range(STEPS // CHUNK):
        for k, s in streams.items():
            frames, audio, timing = next(s)
            got[k].append(frames)
            assert audio.shape == (frames.shape[0] * vocoder.spf,)
            assert not eng._kv_pool  # both requests hold their own cache
    for k, s in streams.items():
        with pytest.raises(StopIteration):
            next(s)
        np.testing.assert_array_equal(np.concatenate(got[k]), want[k], err_msg=k)
    assert len(eng._kv_pool) == 1


def test_closed_stream_returns_its_cache(port):
    """A stream closed after its first chunk hands its cache back, and the
    next request takes that same cache."""
    eng, vocoder, prompts, want = port
    eng._kv_pool.clear()
    s = _stream(eng, vocoder, prompts["a"])
    frames, _, _ = next(s)
    np.testing.assert_array_equal(frames, want["a"][:CHUNK])
    assert not eng._kv_pool
    s.close()
    assert len(eng._kv_pool) == 1
    pooled = eng._kv_pool[0]
    assert eng.new_kv() is pooled and not eng._kv_pool
    eng.release({"kv": pooled})


def test_fast_generate_releases_and_reuses_its_cache(port):
    """Requests one after another: fast_generate takes the pooled cache,
    gives the JAX tokens and hands the cache back; a second release while the
    pool is full is dropped."""
    eng, _, prompts, want = port
    eng._kv_pool.clear()
    eng.release({"kv": eng.new_kv()})
    pooled = eng._kv_pool[0]
    for k in ("b", "a"):
        ids, timing = loops.fast_generate(
            eng, *prompts[k], generator=None, max_new_tokens=STEPS,
            policy=GenerationPolicy(**POLICY), pred_policy=SamplingPolicy(do_sample=False),
            device_chunk=CHUNK)
        np.testing.assert_array_equal(ids, want[k], err_msg=k)
        assert timing["steps"] == STEPS
        assert len(eng._kv_pool) == 1 and eng._kv_pool[0] is pooled
    eng.release({"kv": {"k": torch.zeros(1)}})  # the pool is full: dropped
    assert len(eng._kv_pool) == 1 and eng._kv_pool[0] is pooled
