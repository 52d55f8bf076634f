"""The port's compiled-chunk layer on the CPU, against the JAX engine.

On the card the port's chunks are captured CUDA graphs; on CPU tensors the
same steps run eagerly, so here the layer around them is held to the JAX
package (tiny float32, weights through ``bundle_from_jax_numpy``, greedy):

- the in-place step (``decode_chunk``, ``decode_step``) gives the JAX
  engine's tokens, with the trailing-text length as an int or a tensor;
- ``fast_generate`` and ``fast_generate_streaming`` with ``bucketed=True``
  and ``fast_generate_streaming_audio`` at ``pipeline_depth`` 1, 2 and 3
  give the JAX loops' frames, chunk by chunk, with ``n * spf`` samples of
  audio a chunk;
- ``make_knobs``, ``StaticPolicy`` and ``_pad_tth`` match the JAX ones;
  tensor knobs give the same bits as number knobs;
- the newest state's cache goes back to the pool, also when a stream is
  closed early; ``use_flash_decode=False`` runs the plain masked attention;
  ``warmup`` / ``warmup_all`` run eager chunks and capture nothing;
- a captured chunk's static input (``ChunkGraphs._input``) follows its
  source when the source is written in place between two chunks.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.models.predictor import SamplingPolicy as JSamplingPolicy  # noqa: E402
from qwen3tts_tpu.runtime import engine as jengine  # noqa: E402
from qwen3tts_tpu.runtime import loops as jloops  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models import layers as layers_lib  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.ops import sampling as S  # noqa: E402
from qwen3tts_tpu_torch.runtime import engine as E  # noqa: E402
from qwen3tts_tpu_torch.runtime import loops  # noqa: E402

STEPS, CHUNK, MAX_SEQ = 24, 8, 64
POLICY = dict(do_sample=False, min_new_tokens=STEPS)  # greedy, no early EOS


@pytest.fixture(scope="module")
def setup(tiny_cfg, tiny_models):
    """(the port's params and cfg, a vocoder, the prompt, the JAX loops'
    streamed frames per chunk)."""
    tp, pp = tiny_models
    cfg = get_preset("tiny")
    params = bundle_from_jax_numpy({"talker": jax.tree.map(np.asarray, tp),
                                    "predictor": jax.tree.map(np.asarray, pp)},
                                   cfg, torch.float32, "cpu")
    vocoder = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu").vocoder
    H = cfg.talker.hidden_size
    rng = np.random.default_rng(7)
    prompt = tuple(rng.standard_normal(s).astype(np.float32) * 0.1
                   for s in ((1, 10, H), (1, 5, H), (1, 1, H)))
    jeng = jengine.Engine(tp, pp, tiny_cfg, max_seq_len=MAX_SEQ)
    jpol, jppol = jengine.GenerationPolicy(**POLICY), JSamplingPolicy(do_sample=False)
    want = [f for f, _ in jloops.fast_generate_streaming(
        jeng, jnp.asarray(prompt[0]), jnp.asarray(prompt[1]), jnp.asarray(prompt[2]),
        key=jax.random.PRNGKey(0), max_new_tokens=STEPS, policy=jpol, pred_policy=jppol,
        chunk_size=CHUNK, bucketed=True)]
    assert [len(f) for f in want] == [CHUNK] * (STEPS // CHUNK)
    return params, cfg, vocoder, prompt, want


def _engine(setup, **kw):
    params, cfg = setup[:2]
    return E.Engine(params["talker"], params["predictor"], cfg, max_seq_len=MAX_SEQ, **kw)


def _policies():
    return E.GenerationPolicy(**POLICY), SamplingPolicy(do_sample=False)


def test_in_place_steps_give_jax_tokens(setup):
    """decode_chunk (trailing-text length an int, then a tensor) and
    decode_step update the state in place and give the JAX tokens; the
    tensors prefill returned stay as they were."""
    *_, prompt, want = setup
    want = np.concatenate(want)
    eng = _engine(setup)
    embeds, tth, tpe = (torch.from_numpy(a) for a in prompt)
    pol, ppol = _policies()
    state = eng.prefill(embeds, None, pol, ppol)
    first = state["token"]
    first_val = first.clone()
    got = []
    _, frames, n, lens, _ = eng.decode_chunk(state, tth, 5, tpe, CHUNK)
    got.append(frames[0, : int(lens[0])])
    token = state["token"]
    _, frames, n, lens, _ = eng.decode_chunk(state, tth, torch.tensor([5]), tpe, CHUNK)
    got.append(frames[0, : int(lens[0])])
    for _ in range(CHUNK):
        _, frame = eng.decode_step(state, tth, 5, tpe)
        got.append(frame)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    assert torch.equal(first, first_val)  # prefill's tensor untouched
    assert state["token"] is token  # updated in place since the first chunk
    assert state["pos_host"] == 10 + STEPS and int(state["pos"]) == 10 + STEPS


def _run_loop(eng, vocoder, prompt, loop):
    pol, ppol = _policies()
    kw = dict(generator=None, max_new_tokens=STEPS, policy=pol, pred_policy=ppol)
    if loop == "fast_generate":
        ids, timing = loops.fast_generate(eng, *prompt, device_chunk=CHUNK, bucketed=True,
                                          **kw)
        assert timing["steps"] == STEPS
        return [ids[i:i + CHUNK] for i in range(0, STEPS, CHUNK)], None
    if loop == "streaming":
        out = list(loops.fast_generate_streaming(eng, *prompt, chunk_size=CHUNK,
                                                 bucketed=True, **kw))
        assert out[-1][1]["is_final"] and out[-1][1]["total_steps_so_far"] == STEPS
        return [f for f, _ in out], None
    depth = int(loop.split("-")[1])
    out = list(loops.fast_generate_streaming_audio(
        eng, vocoder, *prompt, chunk_size=CHUNK, bucketed=True, pipeline_depth=depth, **kw))
    assert out[-1][2]["is_final"] and [t["chunk_index"] for _, _, t in out] == [0, 1, 2]
    return [f for f, _, _ in out], [a for _, a, _ in out]


@pytest.mark.parametrize("loop", ["fast_generate", "streaming", "audio-1", "audio-2",
                                  "audio-3"])
def test_loops_give_jax_frames(setup, loop):
    """Each loop's frames, chunk by chunk, equal the JAX streaming loop's;
    the audio stream gives n * spf samples a chunk and the same audio at
    every pipeline depth; the cache is back in the pool at the end."""
    _, _, vocoder, prompt, want = setup
    eng = _engine(setup)
    frames, audio = _run_loop(eng, vocoder, prompt, loop)
    assert len(frames) == len(want)
    for f, w in zip(frames, want):
        np.testing.assert_array_equal(f, w)
    if audio is not None:
        assert [a.shape for a in audio] == [(len(f) * vocoder.spf,) for f in frames]
        ref = _run_loop(_engine(setup), vocoder, prompt, "audio-1")[1]
        for a, r in zip(audio, ref):
            np.testing.assert_array_equal(a, r)
    assert len(eng._kv_pool) == 1


def test_make_knobs_and_static_policy_match_jax():
    pol = E.GenerationPolicy(temperature=0.7, top_p=0.8, repetition_penalty=1.2,
                             min_new_tokens=5)
    ppol = SamplingPolicy(temperature=1.1, top_p=0.95)
    jpol = jengine.GenerationPolicy(**dataclasses.asdict(pol))
    jppol = JSamplingPolicy(**dataclasses.asdict(ppol))
    np.testing.assert_array_equal(E.make_knobs(pol, ppol, "cpu").numpy(),
                                  np.asarray(jengine.make_knobs(jpol, jppol)))
    assert dataclasses.asdict(pol.static) == dataclasses.asdict(jpol.static)
    assert dataclasses.asdict(ppol.static) == dataclasses.asdict(jppol.static)


def test_policies_differing_in_numbers_share_a_static_policy():
    """Only the structure keys a captured chunk: other numbers, other knobs,
    one StaticPolicy; another top_k, a top_p or penalty switched on or off
    is another."""
    a = E.GenerationPolicy(temperature=0.7, top_p=0.9, repetition_penalty=1.05,
                           min_new_tokens=2)
    b = E.GenerationPolicy(temperature=1.3, top_p=0.5, repetition_penalty=1.4,
                           min_new_tokens=40)
    assert a.static == b.static and hash(a.static) == hash(b.static)
    assert not torch.equal(E.make_knobs(a, SamplingPolicy(), "cpu"),
                           E.make_knobs(b, SamplingPolicy(), "cpu"))
    assert SamplingPolicy(temperature=0.3).static == SamplingPolicy(temperature=1.5).static
    for other in (dataclasses.replace(a, top_k=20), dataclasses.replace(a, top_p=1.0),
                  dataclasses.replace(a, repetition_penalty=1.0),
                  dataclasses.replace(a, do_sample=False)):
        assert other.static != a.static


@pytest.mark.parametrize("temperature,top_k,top_p,penalty", [
    (0.9, 50, 1.0, 1.05), (0.7, 20, 0.8, 1.3), (1.3, 0, 0.5, 0.9)])
def test_tensor_knobs_equal_number_knobs(temperature, top_k, top_p, penalty):
    """filter_logits, apply_repetition_penalty and sample_logits give the
    same bits with 0-d tensor knobs as with Python numbers."""
    rng = np.random.default_rng(11)
    logits = torch.from_numpy(rng.standard_normal((3, 257)).astype(np.float32) * 3)
    seen = torch.from_numpy(rng.random((3, 257)) < 0.3)
    k = {name: torch.tensor(v, dtype=torch.float32)
         for name, v in (("t", temperature), ("p", top_p), ("r", penalty))}
    np.testing.assert_array_equal(
        S.apply_repetition_penalty(logits, seen, penalty).numpy(),
        S.apply_repetition_penalty(logits, seen, k["r"]).numpy())
    use_top_p = top_p < 1.0
    np.testing.assert_array_equal(
        S.filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p).numpy(),
        S.filter_logits(logits, temperature=k["t"], top_k=top_k, top_p=k["p"],
                        use_top_p=use_top_p).numpy())
    draws = []
    for t, p in ((temperature, top_p), (k["t"], k["p"])):
        g = torch.Generator().manual_seed(3)
        draws.append(torch.stack([S.sample_logits(g, logits, temperature=t, top_k=top_k,
                                                  top_p=p, use_top_p=use_top_p,
                                                  do_sample=True) for _ in range(20)]))
    assert torch.equal(*draws)
    with pytest.raises(ValueError, match="use_top_p"):
        S.filter_logits(logits, temperature=k["t"], top_k=top_k, top_p=k["p"])


@pytest.mark.parametrize("T", [0, 5, 16, 17])
def test_pad_tth_matches_jax(T):
    rng = np.random.default_rng(T)
    tth = rng.standard_normal((1, T, 8)).astype(np.float32)
    tpe = rng.standard_normal((1, 1, 8)).astype(np.float32)
    got, n = loops._pad_tth(torch.from_numpy(tth), torch.from_numpy(tpe), True)
    want, jn = jloops._pad_tth(jnp.asarray(tth), jnp.asarray(tpe), True)
    assert n == jn == T
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("depth", [1, 3])
def test_closed_stream_releases_the_newest_cache(setup, depth):
    """A stream closed after its first chunk, with chunks still dispatched
    ahead, hands its cache back; the next request takes that cache."""
    _, _, vocoder, prompt, want = setup
    eng = _engine(setup)
    eng.release({"kv": eng.new_kv()})
    pooled = eng._kv_pool[0]
    pol, ppol = _policies()
    s = loops.fast_generate_streaming_audio(
        eng, vocoder, *prompt, generator=None, max_new_tokens=STEPS, policy=pol,
        pred_policy=ppol, chunk_size=CHUNK, pipeline_depth=depth)
    frames, _, _ = next(s)
    np.testing.assert_array_equal(frames, want[0])
    assert not eng._kv_pool
    s.close()
    assert len(eng._kv_pool) == 1 and eng._kv_pool[0] is pooled
    assert eng.new_kv() is pooled


@pytest.mark.parametrize("use_flash", [None, True, False])
def test_use_flash_decode_selects_the_attention_path(setup, monkeypatch, use_flash):
    """None and True route the talker's decode through the flash wrapper
    (its plain version on the CPU), False through the plain masked
    attention; each gives the JAX tokens."""
    *_, prompt, want = setup
    calls = []
    real = layers_lib.flash_decode

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(layers_lib, "flash_decode", counted)
    eng = _engine(setup, use_flash_decode=use_flash)
    assert eng.use_flash_decode == (use_flash is not False)
    pol, ppol = _policies()
    ids, _ = loops.fast_generate(eng, *prompt, generator=None, max_new_tokens=STEPS,
                                 policy=pol, pred_policy=ppol, device_chunk=CHUNK)
    np.testing.assert_array_equal(ids, np.concatenate(want))
    layers = setup[1].talker.num_hidden_layers
    assert len(calls) == (0 if use_flash is False else STEPS * layers)


def test_warmup_on_cpu_runs_eager_chunks_and_captures_nothing(setup, monkeypatch):
    """warmup and warmup_all run each chunk eagerly (no graphs on CPU
    tensors), release their cache and mark the engine warmed up."""
    vocoder = setup[2]
    eng = _engine(setup)
    assert eng.graphs is None
    chunks = []
    real = eng._eager_chunk

    def counted(state, tth, tth_len, tpe, chunk_size, steps):
        chunks.append((tth.shape[1], chunk_size, steps))
        return real(state, tth, tth_len, tpe, chunk_size, steps)

    monkeypatch.setattr(eng, "_eager_chunk", counted)
    pol, ppol = E.GenerationPolicy(), SamplingPolicy()
    assert not eng.warmed_up
    dt = eng.warmup(12, 5, pol, ppol, chunk_sizes=(4, 8), vocoder=vocoder)
    assert dt > 0 and eng.warmed_up and eng.graphs is None
    assert chunks == [(16, 4, 4), (16, 4, 4), (16, 8, 8), (16, 8, 8)]
    assert len(eng._kv_pool) == 1
    chunks.clear()
    eng.warmup_all(pol, ppol, chunk_sizes=(4,), max_tth=64)
    assert chunks == [(16, 4, 4), (64, 4, 4)]
    assert len(eng._kv_pool) == 1 and eng.graphs is None


@pytest.mark.parametrize("inference", [False, True])
def test_static_input_follows_an_in_place_write(inference):
    """The captured chunks' copy of the trailing text (``ChunkGraphs._input``,
    its bookkeeping alone: no card) is copied in again when the caller writes
    a row of the same tensor in place between two chunks, as a batch does for
    a joining row; an inference tensor, which keeps no version counter, is
    copied at every chunk."""
    from qwen3tts_tpu_torch.runtime.graphs import ChunkGraphs, _Slot

    graphs = ChunkGraphs.__new__(ChunkGraphs)
    slot = _Slot({})
    with torch.inference_mode() if inference else contextlib.nullcontext():
        tth = torch.zeros((2, 16, 8))
    with torch.inference_mode():  # the engine's chunks run in inference mode
        buf = graphs._input(slot, ("tth", 16), tth)
        assert torch.equal(buf, tth)
        tth[1, :5] = 1.0  # a joining row, written in place
        assert graphs._input(slot, ("tth", 16), tth) is buf
        assert torch.equal(buf, tth), "the next chunk would read the old row"
        other = torch.full((2, 16, 8), 2.0)  # another tensor
        assert graphs._input(slot, ("tth", 16), other) is buf
        assert torch.equal(buf, other)
