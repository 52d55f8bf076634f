"""The per-step parity loops of the PyTorch port (``parity_generate``,
``parity_generate_streaming``) and the API's ``parity_mode``, against the
JAX package's loops and the port's fast path (tiny preset, float32, weights
through ``bundle_from_jax_numpy``, inputs from a numpy seed).

- Greedy parity tokens equal the port's ``fast_generate`` tokens and JAX
  ``parity_generate``'s; both stop where JAX's stops: at an EOS token and
  one slot short of a full cache.
- The streamed parity loop's chunks concatenated equal ``parity_generate``;
  its ``is_final`` flags and timing keys equal JAX's; closed early, it gives
  its KV cache back to the engine.
- ``parity_mode=True`` through the API streams the same audio as it
  returns unstreamed from the same generator seed, with and without an ICL
  prompt (the stream's codec primed with the reference codes), within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402

from qwen3tts_tpu.models.predictor import SamplingPolicy as JSamplingPolicy  # noqa: E402
from qwen3tts_tpu.runtime import loops as jloops  # noqa: E402
from qwen3tts_tpu.runtime.engine import Engine as JEngine  # noqa: E402
from qwen3tts_tpu.runtime.engine import GenerationPolicy as JGenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy, init_random  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime import loops  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy  # noqa: E402

CFG = get_preset("tiny")
STEPS = 20


@pytest.fixture(scope="module")
def setup(tiny_models):
    tp, pp = tiny_models
    params = bundle_from_jax_numpy({"talker": jax.tree.map(np.asarray, tp),
                                    "predictor": jax.tree.map(np.asarray, pp)},
                                   CFG, torch.float32, "cpu")
    rng = np.random.default_rng(4)
    H = CFG.talker.hidden_size
    prompt = tuple(rng.standard_normal(s).astype(np.float32) * 0.1
                   for s in ((1, 10, H), (1, 5, H), (1, 1, H)))
    return tp, pp, params, prompt


def _greedy(min_new_tokens=STEPS):
    return (GenerationPolicy(do_sample=False, min_new_tokens=min_new_tokens),
            SamplingPolicy(do_sample=False))


def _jgreedy(min_new_tokens=STEPS):
    return dict(policy=JGenerationPolicy(do_sample=False, min_new_tokens=min_new_tokens),
                pred_policy=JSamplingPolicy(do_sample=False))


def _engines(setup, eos=None, max_seq_len=64):
    """The port's and the JAX Engine on the same weights (with the talker's
    EOS id replaced by ``eos``)."""
    from qwen3tts_tpu.core.presets import get_preset as jget_preset

    tp, pp, params, _ = setup
    cfgs = [CFG, jget_preset("tiny")]
    if eos is not None:
        cfgs = [dataclasses.replace(c, talker=dataclasses.replace(
            c.talker, codec_eos_token_id=eos)) for c in cfgs]
    return (Engine(params["talker"], params["predictor"], cfgs[0], max_seq_len=max_seq_len),
            JEngine(tp, pp, cfgs[1], max_seq_len=max_seq_len))


def test_parity_tokens_equal_fast_path_and_jax(setup):
    prompt = setup[3]
    eng, jeng = _engines(setup)
    pol, ppol = _greedy()
    got, timing = loops.parity_generate(eng, *prompt, generator=None, max_new_tokens=STEPS,
                                        policy=pol, pred_policy=ppol)
    fast, _ = loops.fast_generate(eng, *prompt, generator=None, max_new_tokens=STEPS,
                                  policy=pol, pred_policy=ppol, device_chunk=8)
    want, jtiming = jloops.parity_generate(jeng, *prompt, key=jax.random.PRNGKey(0),
                                           max_new_tokens=STEPS, **_jgreedy())
    assert got.shape == (STEPS, 16) and got.dtype == np.int32
    np.testing.assert_array_equal(got, fast)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert set(timing) == set(jtiming) and timing["steps"] == STEPS


def _eos(setup):
    """The first token that the greedy run samples only at step 6 or later
    (an EOS id that stops the run there), and that step."""
    eng, _ = _engines(setup)
    pol, ppol = _greedy(2)
    ids, _ = loops.parity_generate(eng, *setup[3], generator=None, max_new_tokens=STEPS,
                                   policy=pol, pred_policy=ppol)
    first_at = {}
    for i, t in enumerate(ids[:, 0].tolist()):
        first_at.setdefault(t, i)
    k = min(i for i in first_at.values() if i >= 6)
    return int(ids[k, 0]), k


@pytest.mark.parametrize("stop", ["eos", "cache"])
def test_parity_stops_where_jax_stops(setup, stop):
    prompt = setup[3]
    if stop == "eos":
        eos, k = _eos(setup)
        eng, jeng = _engines(setup, eos)
        budget, min_new = STEPS, 2
    else:  # a 32-slot cache after a 10-token prompt: 31 - 10 steps
        eng, jeng = _engines(setup, max_seq_len=32)
        budget, min_new, k = 40, 40, 21
    pol, ppol = _greedy(min_new)
    got, _ = loops.parity_generate(eng, *prompt, generator=None, max_new_tokens=budget,
                                   policy=pol, pred_policy=ppol)
    want, _ = jloops.parity_generate(jeng, *prompt, key=jax.random.PRNGKey(0),
                                     max_new_tokens=budget, **_jgreedy(min_new))
    assert got.shape == (k, 16)
    np.testing.assert_array_equal(got, np.asarray(want))
    chunks = list(loops.parity_generate_streaming(
        eng, *prompt, generator=None, max_new_tokens=budget, policy=pol, pred_policy=ppol,
        chunk_size=8))
    jchunks = list(jloops.parity_generate_streaming(
        jeng, *prompt, key=jax.random.PRNGKey(0), max_new_tokens=budget, chunk_size=8,
        **_jgreedy(min_new)))
    assert [t["is_final"] for _, t in chunks] == [t["is_final"] for _, t in jchunks]
    np.testing.assert_array_equal(np.concatenate([c for c, _ in chunks]), got)


@pytest.mark.parametrize("budget", [STEPS, 16])
def test_parity_streaming_chunks_equal_parity_generate(setup, budget):
    prompt = setup[3]
    eng, jeng = _engines(setup)
    pol, ppol = _greedy()
    whole, _ = loops.parity_generate(eng, *prompt, generator=None, max_new_tokens=budget,
                                     policy=pol, pred_policy=ppol)
    chunks = list(loops.parity_generate_streaming(
        eng, *prompt, generator=None, max_new_tokens=budget, policy=pol, pred_policy=ppol,
        chunk_size=8))
    jchunks = list(jloops.parity_generate_streaming(
        jeng, *prompt, key=jax.random.PRNGKey(0), max_new_tokens=budget, chunk_size=8,
        **_jgreedy()))
    assert [len(c) for c, _ in chunks] == [len(c) for c, _ in jchunks] == \
        [8, 8, 4][: -(-budget // 8)]
    np.testing.assert_array_equal(np.concatenate([c for c, _ in chunks]), whole)
    np.testing.assert_array_equal(np.concatenate([c for c, _ in chunks]),
                                  np.concatenate([np.asarray(c) for c, _ in jchunks]))
    assert [t["is_final"] for _, t in chunks] == [t["is_final"] for _, t in jchunks]
    assert all(set(t) == set(jt) for (_, t), (_, jt) in zip(chunks, jchunks))
    assert [t["total_steps_so_far"] for _, t in chunks] == \
        [t["total_steps_so_far"] for _, t in jchunks]
    # a stream closed after its first chunk gives its cache back to the pool
    stream = loops.parity_generate_streaming(eng, *prompt, generator=None,
                                             max_new_tokens=budget, policy=pol,
                                             pred_policy=ppol, chunk_size=8)
    next(stream)
    assert not eng._kv_pool
    stream.close()
    assert len(eng._kv_pool) == 1


@pytest.fixture(scope="module")
def api_model(tmp_path_factory):
    from qwen3tts_tpu_torch.audio.wav import write_wav

    m = FasterQwen3TTS(CFG, init_random(CFG, seed=2, device="cpu"),
                       vocoder_compute_dtype=torch.float32)
    path = tmp_path_factory.mktemp("parity") / "ref.wav"
    t = np.arange(12_000, dtype=np.float32) / 24_000
    write_wav(path, (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32), 24_000)
    return m, str(path)


@pytest.mark.parametrize("icl", [False, True])
def test_api_parity_mode_streams_the_unstreamed_audio(api_model, icl):
    m, ref = api_model
    kw = dict(text="hello there", language="English", ref_audio=ref,
              ref_text="some reference words", max_new_tokens=12, min_new_tokens=12,
              xvec_only=not icl, parity_mode=True)
    m._gen.manual_seed(7)
    out = list(m.generate_voice_clone_streaming(chunk_size=5, **kw))
    m._gen.manual_seed(7)
    wavs, _ = m.generate_voice_clone(**kw)
    spf = m.vocoder.spf
    assert [a.shape[0] for a, _, _ in out] == [5 * spf, 5 * spf, 2 * spf]
    assert [t["is_final"] for _, _, t in out] == [False, False, True]
    assert not m.engine.warmed_up  # parity mode captures nothing
    np.testing.assert_allclose(np.concatenate([a for a, _, _ in out]), wavs[0], rtol=0,
                               atol=1e-5)
