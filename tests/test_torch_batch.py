"""Batched generation in the PyTorch port, against the JAX package's batched
engine (tiny float32, one set of weights through ``bundle_from_jax_numpy``,
inputs from numpy seeds, greedy talker and predictor).

- A chunk stops when every row is done: after an eager chunk of 8 in which
  the last live row samples its EOS early, ``n``, ``pos``, ``gen_step``,
  ``n_gen``, ``done`` and the token equal the JAX ``decode_chunk``'s.
- ``fast_generate_batch`` at B 3 (prompts of 6, 10 and 8 tokens, left-padded)
  gives each row the JAX ``Engine(batch=3)``'s tokens and the port's own
  batch-1 tokens; with int8 weights, an int8 KV cache and the fused kernels
  too.  A row whose EOS comes early freezes at its batch-1 length.
- The bucketed prefill with the cache roll leaves JAX's state: ``pos`` and
  ``pad_count`` exactly, the live cache slots within 1e-5 (float and int8
  cache), with and without ``pos_floor``.
- ``join_row`` into a running batch gives JAX's tokens after the join and
  the prompt's batch-1 tokens; it refuses what JAX refuses.
- ``chunk_vocode_batched``: frames equal, audio within 1e-5 of JAX's;
  ``stream_state_batched`` / ``scatter_stream_row`` leave JAX's leaves.
- ``generate_voice_clone_batch``: the stacked prompt within 1e-5 of JAX's,
  greedy batch tokens from it equal JAX's, B waveforms of the budget's
  length (x-vector and ICL).
- The micro-step kernel's one gate (``micro_kernel_misfit``): on the CPU,
  above 16 rows, with quantized blocks or a tp group the default engine runs
  the eager chain and ``use_micro_kernel=True`` raises; where the gate lets
  it, the default takes the kernel and ``False`` keeps the chain.  The
  ``predictor_frames.kernel`` / ``.eager`` counters add each dispatched step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu import FasterQwen3TTS as JFasterQwen3TTS  # noqa: E402
from qwen3tts_tpu.audio.vocoder import Vocoder as JVocoder  # noqa: E402
from qwen3tts_tpu.models.predictor import SamplingPolicy as JSamplingPolicy  # noqa: E402
from qwen3tts_tpu.ops.quant import quantize_bundle as jquantize_bundle  # noqa: E402
from qwen3tts_tpu.runtime import loops as jloops  # noqa: E402
from qwen3tts_tpu.runtime.engine import Engine as JEngine  # noqa: E402
from qwen3tts_tpu.runtime.engine import GenerationPolicy as JGenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.audio.vocoder import Vocoder  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models import predictor as TP  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.ops.quant import quantize_bundle  # noqa: E402
from qwen3tts_tpu_torch.runtime import loops  # noqa: E402
from qwen3tts_tpu_torch.runtime import engine as engine_lib  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch.utils.timing import TRACE  # noqa: E402

LENGTHS = (6, 10, 8)
STEPS, CHUNK, MAX_SEQ = 8, 4, 128
POLICY = dict(do_sample=False, repetition_penalty=1.05, min_new_tokens=0)
KEY = jax.random.PRNGKey(11)


def _policies():
    return GenerationPolicy(**POLICY), SamplingPolicy(do_sample=False)


def _jpolicies():
    return JGenerationPolicy(**POLICY), JSamplingPolicy(do_sample=False)


@pytest.fixture(scope="module")
def setup():
    """The JAX model and the port's on the same weights, the rows (prompts
    [1, T, H], trailing texts [1, 4, H]), the left-padded batch of them, a
    shared JAX Engine(batch=3) and its fast_generate_batch frames."""
    jm = JFasterQwen3TTS.from_pretrained("random:tiny", max_seq_len=MAX_SEQ)
    cfg = get_preset("tiny")
    tm = FasterQwen3TTS(cfg, bundle_from_jax_numpy(jax.tree.map(np.asarray, jm.params), cfg,
                                                   torch.float32, "cpu"), max_seq_len=MAX_SEQ)
    H = cfg.talker.hidden_size
    rng = np.random.default_rng(40)
    embeds = [rng.standard_normal((1, T, H)).astype(np.float32) * 0.1 for T in LENGTHS]
    tths = [rng.standard_normal((1, 4, H)).astype(np.float32) * 0.1 for _ in LENGTHS]
    T = max(LENGTHS)
    pads = np.asarray([T - L for L in LENGTHS], np.int32)
    batch = np.zeros((3, T, H), np.float32)
    for b, e in enumerate(embeds):
        batch[b, pads[b]:] = e[0]
    tth = np.concatenate(tths, axis=0)
    tpe = np.zeros((3, 1, H), np.float32)
    jeng = JEngine(jm.params["talker"], jm.params["predictor"], jm.cfg, max_seq_len=MAX_SEQ,
                   batch=3)
    jpol, jppol = _jpolicies()
    want, timing = jloops.fast_generate_batch(
        jeng, jnp.asarray(batch), jnp.asarray(tth), jnp.asarray(tpe), key=KEY, pad_count=pads,
        max_new_tokens=STEPS, policy=jpol, pred_policy=jppol, device_chunk=CHUNK)
    assert timing["batch"] == 3
    return dict(jm=jm, tm=tm, cfg=cfg, embeds=embeds, tths=tths, batch=batch, pads=pads,
                tth=tth, tpe=tpe, jeng=jeng, want=[np.asarray(w) for w in want])


def _engine(setup, **kw):
    tm = setup["tm"]
    kw.setdefault("max_seq_len", MAX_SEQ)
    return Engine(tm.params["talker"], tm.params["predictor"], tm.cfg, **kw)


def _batch(eng, setup, steps=STEPS):
    pol, ppol = _policies()
    return loops.fast_generate_batch(
        eng, setup["batch"], setup["tth"], setup["tpe"], generator=None,
        pad_count=setup["pads"], max_new_tokens=steps, policy=pol, pred_policy=ppol,
        device_chunk=CHUNK)


def _singles(setup, eos_id=None, steps=STEPS):
    pol, ppol = _policies()
    eng = _engine(setup)
    if eos_id is not None:
        eng.eos_id = eos_id
    out = []
    for e, t in zip(setup["embeds"], setup["tths"]):
        ids, _ = loops.fast_generate(eng, e, t, setup["tpe"][:1], generator=None,
                                     max_new_tokens=steps, policy=pol, pred_policy=ppol,
                                     device_chunk=CHUNK)
        out.append(ids if ids is not None else np.zeros((0, 16), np.int32))
    return out


def test_batch_rows_equal_jax_and_batch1(setup):
    got, timing = _batch(_engine(setup, batch=3), setup)
    assert timing["batch"] == 3 and timing["steps"] == sum(len(g) for g in got)
    singles = _singles(setup)
    for b in range(3):
        np.testing.assert_array_equal(got[b], setup["want"][b], err_msg=f"row {b} vs JAX")
        np.testing.assert_array_equal(got[b], singles[b], err_msg=f"row {b} vs batch 1")


def test_int8_kv_quant_fused_batch_equals_jax(setup):
    jm, cfg = setup["jm"], setup["cfg"]
    qb = jquantize_bundle({"talker": jm.params["talker"], "predictor": jm.params["predictor"]},
                          "int8")
    params = bundle_from_jax_numpy(jax.tree.map(np.asarray, qb), cfg, torch.float32, "cpu")
    kw = dict(max_seq_len=MAX_SEQ, batch=3, kv_quant=True, use_fused_kernels=True)
    jeng = JEngine(qb["talker"], qb["predictor"], jm.cfg, **kw)
    jpol, jppol = _jpolicies()
    want, _ = jloops.fast_generate_batch(
        jeng, jnp.asarray(setup["batch"]), jnp.asarray(setup["tth"]),
        jnp.asarray(setup["tpe"]), key=KEY, pad_count=setup["pads"], max_new_tokens=STEPS,
        policy=jpol, pred_policy=jppol, device_chunk=CHUNK)
    got, _ = _batch(Engine(params["talker"], params["predictor"], cfg, **kw), setup)
    for b in range(3):
        np.testing.assert_array_equal(got[b], np.asarray(want[b]), err_msg=f"row {b}")


def test_early_eos_row_freezes(setup):
    """Row 1's step-2 codebook-0 token made the EOS: each row stops where
    its batch-1 run stops, and the others run on."""
    base = _singles(setup)
    eos = int(base[1][2, 0])
    singles = _singles(setup, eos_id=eos)
    eng = _engine(setup, batch=3)
    eng.eos_id = eos
    got, _ = _batch(eng, setup)
    lengths = [len(g) for g in got]
    assert lengths == [len(s) for s in singles]
    assert min(lengths) < max(lengths) == STEPS
    for b in range(3):
        np.testing.assert_array_equal(got[b], singles[b], err_msg=f"row {b}")


@pytest.mark.parametrize("batch", [1, 3])
def test_chunk_stops_when_every_row_is_done(setup, batch):
    """An eager chunk of 8 in which the last live row samples its EOS at
    step 3 or later: the port's state and ``n`` after it equal the JAX
    chunk's (the JAX loop stops when every row is done).  At batch 3 rows 0
    and 2 are done before the chunk."""
    base = _singles(setup, steps=8)[1]
    first = {}
    for i, t in enumerate(base[:, 0].tolist()):
        first.setdefault(t, i)
    k = min(i for i in first.values() if i >= 3)  # the token step k - 1 samples
    assert k < 8, "no token first sampled within the chunk"
    eos = int(base[k, 0])
    jm = setup["jm"]
    jeng = JEngine(jm.params["talker"], jm.params["predictor"], jm.cfg, max_seq_len=MAX_SEQ,
                   batch=batch)
    jeng.eos_id = eos
    eng = _engine(setup, batch=batch)
    eng.eos_id = eos
    if batch == 1:
        embeds, tth, tpe, pads = setup["embeds"][1], setup["tths"][1], setup["tpe"][:1], None
    else:
        embeds, tth, tpe, pads = setup["batch"], setup["tth"], setup["tpe"], setup["pads"]
    jpol, jppol = _jpolicies()
    kw = {} if pads is None else dict(pad_count=pads)
    js = jeng.prefill(jnp.asarray(embeds), KEY, jpol, jppol, **kw)
    pol, ppol = _policies()
    ts = eng.prefill(embeds, None, pol, ppol, **kw)
    if batch == 3:
        js["done"] = js["done"].at[0].set(True).at[2].set(True)
        with torch.inference_mode():  # the engine's tensors are inference tensors
            ts["done"][0] = ts["done"][2] = True
    js, jf, jn, jlens, _ = jeng.decode_chunk(js, jnp.asarray(tth), 4, jnp.asarray(tpe), jpol,
                                             jppol, 8)
    ts, f, n, lens, done = eng.decode_chunk(ts, torch.from_numpy(tth), 4,
                                            torch.from_numpy(tpe), 8)
    assert int(n) == int(jn) == k
    assert int(ts["pos"]) == int(js["pos"])
    for name in ("gen_step", "n_gen", "done", "token"):
        np.testing.assert_array_equal(ts[name].numpy(), np.asarray(js[name]), err_msg=name)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))  # zeros past n on both
    eng.settle(ts, int(n))
    assert ts["pos_host"] == int(ts["pos"])


@pytest.mark.parametrize("kv_quant,pos_floor", [(False, None), (False, 20), (True, None)])
def test_prefill_roll_equals_jax(setup, kv_quant, pos_floor):
    """Left-padded to the bucket (32) and rolled by the shared pad: pos,
    pad_count, token exactly, hidden and the live slots [pad_b, pos) of
    every layer within 1e-5 (an int8 entry within one step of its scale)."""
    jm = setup["jm"]
    jeng = (setup["jeng"] if not kv_quant else
            JEngine(jm.params["talker"], jm.params["predictor"], jm.cfg, max_seq_len=MAX_SEQ,
                    batch=3, kv_quant=True))
    jpol, jppol = _jpolicies()
    js = jeng.prefill(jnp.asarray(setup["batch"]), KEY, jpol, jppol, pad_count=setup["pads"],
                      pos_floor=pos_floor)
    pol, ppol = _policies()
    ts = _engine(setup, batch=3, kv_quant=kv_quant).prefill(
        setup["batch"], None, pol, ppol, pad_count=setup["pads"], pos_floor=pos_floor)
    pos = int(js["pos"])
    assert pos == (max(LENGTHS) if pos_floor is None else pos_floor)
    assert int(ts["pos"]) == ts["pos_host"] == pos
    np.testing.assert_array_equal(ts["pad_count"].numpy(), np.asarray(js["pad_count"]))
    np.testing.assert_array_equal(ts["token"].numpy(), np.asarray(js["token"]))
    np.testing.assert_allclose(ts["past_hidden"].numpy(), np.asarray(js["past_hidden"]),
                               rtol=0, atol=1e-5)
    jkv = {k: np.asarray(v) for k, v in js["kv"].items()}
    tkv = {k: v.numpy() for k, v in ts["kv"].items()}
    for b, pad in enumerate(np.asarray(js["pad_count"])):
        live = slice(int(pad), pos)
        for name in ("k", "v"):
            got, want = tkv[name][:, b, live], jkv[name][:, b, live]
            if kv_quant:  # [L, S, KVH, D] times the scales [L, KVH, S]
                s = name + "s"
                scale = tkv[s][:, b, :, live].transpose(0, 2, 1)[..., None]
                got = got * scale
                want = want * jkv[s][:, b, :, live].transpose(0, 2, 1)[..., None]
                assert np.all(np.abs(got - want) <= 1e-5 + 1.01 * scale), name
                np.testing.assert_allclose(tkv[s][:, b, :, live], jkv[s][:, b, :, live],
                                           rtol=1e-4, atol=1e-7)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


def _join_inputs(setup):
    H = setup["cfg"].talker.hidden_size
    rng = np.random.default_rng(72)
    return (rng.standard_normal((1, 7, H)).astype(np.float32) * 0.1,
            rng.standard_normal((1, 5, H)).astype(np.float32) * 0.1)


def _joined_tokens(eng, state, decode, read, e_join, tth_join, join, steps=12):
    """Decode to a position past the smallest bucket, join ``e_join`` into
    row 1, retire rows 0 and 2, and collect row 1's codebook-0 tokens."""
    H = e_join.shape[2]
    pos = int(np.asarray(state["pos"]).reshape(-1)[0])
    while pos < 32:
        state, n = decode(state, np.zeros((3, 4, H), np.float32), 0)
        pos += n
    state = join(state, pos)
    tth2 = np.zeros((3, 8, H), np.float32)
    tth2[1, :5] = tth_join[0]
    got = []
    while len(got) < steps:
        state, out = read(state, tth2, np.asarray([0, 5, 0]))
        frames, lens, done = out
        got.extend(frames[1, : int(lens[1]), 0].tolist())
        if bool(np.all(done)):
            break
    return np.asarray(got[:steps])


def test_join_row_equals_jax_and_batch1(setup):
    e_join, tth_join = _join_inputs(setup)
    jeng, jm = setup["jeng"], setup["jm"]
    jpol, jppol = _jpolicies()
    pol, ppol = _policies()
    tpe = setup["tpe"]

    def jdecode(state, tth, tth_len):
        state, _, n, _, _ = jeng.decode_chunk(state, jnp.asarray(tth), tth_len,
                                              jnp.asarray(tpe), jpol, jppol, CHUNK)
        return state, int(n)

    def jjoin(state, pos):
        state = jeng.join_row(state, 1, jnp.asarray(e_join), policy=jpol, pred_policy=jppol,
                              pos_hint=pos)
        state["done"] = state["done"].at[0].set(True).at[2].set(True)
        return state

    def jread(state, tth, tth_len):
        state, f, _, lens, done = jeng.decode_chunk(state, jnp.asarray(tth),
                                                    jnp.asarray(tth_len, jnp.int32),
                                                    jnp.asarray(tpe), jpol, jppol, CHUNK)
        return state, (np.asarray(f), np.asarray(lens), np.asarray(done))

    js = jeng.prefill(jnp.asarray(setup["batch"]), KEY, jpol, jppol, pad_count=setup["pads"])
    want = _joined_tokens(jeng, js, jdecode, jread, e_join, tth_join, jjoin)

    eng = _engine(setup, batch=3)

    def tdecode(state, tth, tth_len):
        state, _, n, _, _ = eng.decode_chunk(state, torch.from_numpy(tth), tth_len,
                                             torch.from_numpy(tpe), CHUNK)
        eng.settle(state, int(n))
        return state, int(n)

    def tjoin(state, pos):
        assert eng.warm_join(7) == 32
        state = eng.join_row(state, 1, e_join, policy=pol, pred_policy=ppol, pos_hint=pos)
        with torch.inference_mode():
            state["done"][0] = state["done"][2] = True
        return state

    def tread(state, tth, tth_len):
        state, f, n, lens, done = eng.decode_chunk(state, torch.from_numpy(tth),
                                                   torch.from_numpy(tth_len),
                                                   torch.from_numpy(tpe), CHUNK)
        eng.settle(state, int(n))
        return state, (f.numpy(), lens.numpy(), done.numpy())

    ts = eng.prefill(setup["batch"], None, pol, ppol, pad_count=setup["pads"])
    got = _joined_tokens(eng, ts, tdecode, tread, e_join, tth_join, tjoin)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got, want)
    single, _ = loops.fast_generate(_engine(setup), e_join, tth_join, tpe[:1], generator=None,
                                    max_new_tokens=len(got), policy=pol, pred_policy=ppol,
                                    device_chunk=CHUNK)
    np.testing.assert_array_equal(got, single[: len(got), 0])


def test_join_row_refuses_as_jax(setup):
    e_join, _ = _join_inputs(setup)
    pol, ppol = _policies()
    eng = _engine(setup, batch=3)
    state = eng.prefill(setup["batch"], None, pol, ppol, pad_count=setup["pads"])
    with pytest.raises(ValueError, match="cannot join"):
        eng.join_row(state, 1, e_join, policy=pol, pos_hint=8)
    with pytest.raises(ValueError, match="cannot join"):  # the device's position: 10 < 32
        eng.join_row(state, 1, e_join, policy=pol)
    with pytest.raises(ValueError, match="not a prefill bucket"):
        eng.join_row(state, 1, e_join, policy=pol, pad_inner=0)
    with pytest.raises(ValueError, match="one request"):
        eng.join_row(state, 1, setup["batch"][:2], policy=pol)


def _leaves(tree):
    """A stream state's leaves as numpy, in key order; the port's conv
    carries [B, C, K] in JAX's layout [B, K, C]."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.transpose(1, 2).numpy() if tree.dim() == 3 else tree.numpy()]
    return [np.asarray(tree)]


def test_chunk_vocode_batched_equals_jax(setup):
    """Two chunks of every row through the batched codec stream (float32
    codec on both sides): frames equal, audio within 1e-5; then a primed
    batch-1 stream state scattered into row 1."""
    jm, tm, cfg = setup["jm"], setup["tm"], setup["cfg"]
    jvoc = JVocoder(jm.params["codec"], jm.cfg.codec, compute_dtype=jnp.float32)
    voc = Vocoder(tm.params["codec"], cfg.codec, compute_dtype=None)
    jeng = setup["jeng"]
    jpol, jppol = _jpolicies()
    pol, ppol = _policies()
    js = jeng.prefill(jnp.asarray(setup["batch"]), KEY, jpol, jppol, pad_count=setup["pads"])
    eng = _engine(setup, batch=3)
    ts = eng.prefill(setup["batch"], None, pol, ppol, pad_count=setup["pads"])
    jvs, tvs = jvoc.stream_state_batched(3), voc.stream_state_batched(3)
    for g, w in zip(_leaves(tvs), _leaves(jvs), strict=True):
        assert g.shape == w.shape and not g.any() and not w.any()
    tth, tpe = setup["tth"], setup["tpe"]
    for _ in range(2):
        js, jf, _, jlens, _, jaudio, jvs = jeng.chunk_vocode_batched(
            jvoc, js, jnp.asarray(tth), 4, jnp.asarray(tpe), jpol, jppol, CHUNK, jvs)
        ts, f, n, lens, _, audio, tvs = eng.chunk_vocode_batched(
            voc, ts, torch.from_numpy(tth), 4, torch.from_numpy(tpe), CHUNK, tvs)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
        assert audio.shape == (3, CHUNK * voc.spf)
        np.testing.assert_allclose(audio.numpy(), np.asarray(jaudio), rtol=0, atol=1e-5)
    codes = np.asarray(jf)[0, :3]
    jrow = jvoc.stream_feed(jvoc.stream_state(), codes, collect_audio=False)[1]
    trow = voc.stream_feed(voc.stream_state(), codes, collect_audio=False)[1]
    jvs = jvoc.scatter_stream_row(jvs, jrow, 1)
    assert voc.scatter_stream_row(tvs, trow, 1) is tvs
    for g, w in zip(_leaves(tvs), _leaves(jvs), strict=True):
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=0,
                                   atol=1e-5)


def _record(module, calls):
    real = module.fast_generate_batch

    def recorded(engine, embeds, trailing, tpe, **kw):
        calls.append((np.asarray(embeds), np.asarray(trailing), np.asarray(tpe),
                      np.asarray(kw["pad_count"]), np.asarray(kw["tth_lens"])))
        return real(engine, embeds, trailing, tpe, **kw)

    return real, recorded


TEXTS = ["first utterance", "a second much longer utterance to vary length"]


def test_voice_clone_batch_api_equals_jax(setup, ref_wav, monkeypatch):
    """From one voice prompt (the port's x-vector, given to JAX's cache: the
    two speaker encoders differ by more than the stacking is held to), both
    APIs stack the same prompt (within 1e-5); greedy batch tokens from it
    equal JAX's; each returns one waveform of the budget a text."""
    jm, tm = setup["jm"], setup["tm"]
    key = (str(ref_wav), "ref", True, True)
    jm._voice_prompt_cache[key] = tm._voice_prompt(ref_wav, "ref", True, True)
    calls = {"jax": [], "port": []}
    for name, module in (("jax", jloops), ("port", loops)):
        real, recorded = _record(module, calls[name])
        monkeypatch.setattr(module, "fast_generate_batch", recorded)
    kw = dict(max_new_tokens=6, min_new_tokens=6)
    jwavs, _ = jm.generate_voice_clone_batch(TEXTS, "english", ref_wav, "ref", **kw)
    wavs, sr = tm.generate_voice_clone_batch(TEXTS, "english", ref_wav, "ref", **kw)
    assert sr == 24_000 and len(wavs) == len(jwavs) == 2
    assert [len(w) for w in wavs] == [len(w) for w in jwavs] == [6 * tm.vocoder.spf] * 2
    (je, jt, jp, jpad, jlen), (e, t, p, pad, tlen) = calls["jax"][0], calls["port"][0]
    for g, w in ((e, je), (t, jt), (p, jp)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pad, jpad)
    np.testing.assert_array_equal(tlen, jlen)
    monkeypatch.undo()
    jpol, jppol = _jpolicies()
    pol, ppol = _policies()
    want, _ = jloops.fast_generate_batch(
        jm._batch_engine(2), jnp.asarray(e), jnp.asarray(t), jnp.asarray(p), key=KEY,
        pad_count=pad, tth_lens=tlen, max_new_tokens=STEPS, policy=jpol, pred_policy=jppol)
    got, _ = loops.fast_generate_batch(tm._batch_engine(2), e, t, p, generator=None,
                                       pad_count=pad, tth_lens=tlen, max_new_tokens=STEPS,
                                       policy=pol, pred_policy=ppol)
    assert tm._batch_engine(2) is tm._batch_engines[2] and tm._batch_engine(1) is tm.engine
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(want[b]), err_msg=f"row {b}")
    icl, _ = tm.generate_voice_clone_batch(TEXTS, "english", ref_wav, "a reference",
                                           xvec_only=False, **kw)
    assert [len(w) for w in icl] == [6 * tm.vocoder.spf] * 2
    assert all(np.isfinite(w).all() for w in icl)
    assert tm.generate_voice_clone_batch([], "english", ref_wav, "ref") == ([], 24_000)


def test_micro_kernel_is_batch_1_only(setup, monkeypatch):
    """One gate decides the path, at any batch up to 16.  On the CPU the
    default is the eager chain and True raises, naming every reason (above
    16 rows, quantized blocks); False is the chain.  Where the gate lets it
    (patched to, as on the card), the default and True take the kernel at
    any batch up to 16 and False keeps the chain."""
    with pytest.raises(ValueError, match="at least 1"):
        _engine(setup, batch=0)
    eng = _engine(setup, batch=2)
    assert not eng.use_micro_kernel and eng._micro_weights is None
    with pytest.raises(ValueError, match="batch 2"):
        eng.prefill(setup["embeds"][0], None, *_policies())
    with pytest.raises(ValueError, match="use_micro_kernel=True: the tensors are on cpu"):
        _engine(setup, batch=2, use_micro_kernel=True)
    with pytest.raises(ValueError, match="17 rows"):
        _engine(setup, batch=17, use_micro_kernel=True)
    tm = setup["tm"]
    q = quantize_bundle(tm.params, "int8-predictor")
    with pytest.raises(ValueError, match="quantized"):
        Engine(q["talker"], q["predictor"], tm.cfg, max_seq_len=MAX_SEQ, use_micro_kernel=True)
    assert not Engine(q["talker"], q["predictor"], tm.cfg, max_seq_len=MAX_SEQ).use_micro_kernel
    assert "tp group" in TP.micro_kernel_misfit(tm.params["predictor"], tm.cfg.predictor, 2,
                                                torch.device("cpu"), object())
    assert not _engine(setup, batch=2, use_micro_kernel=False).use_micro_kernel

    real = TP.micro_kernel_misfit
    monkeypatch.setattr(engine_lib.predictor_lib, "micro_kernel_misfit",
                        lambda p, c, rows, device=None, group=None: real(p, c, rows, None, group))
    for batch in (1, 2, 16):
        assert _engine(setup, batch=batch).use_micro_kernel
        assert _engine(setup, batch=batch, use_micro_kernel=True)._micro_weights is not None
        assert not _engine(setup, batch=batch, use_micro_kernel=False).use_micro_kernel
    assert not Engine(q["talker"], q["predictor"], tm.cfg, max_seq_len=MAX_SEQ).use_micro_kernel


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_predictor_frame_counters_add_dispatched_steps(setup, monkeypatch, path):
    """Each dispatched frame step adds one to its engine's path counter: a
    chunk of n steps n (an eager engine here; a captured chunk books the
    same n), ``decode_step`` one.  The kernel path on the CPU runs the
    micro-step's plain version (the gate patched to let it)."""
    if path == "kernel":
        real = TP.micro_kernel_misfit
        monkeypatch.setattr(engine_lib.predictor_lib, "micro_kernel_misfit",
                            lambda p, c, rows, device=None, group=None: real(p, c, rows, None, group))
    eng = _engine(setup, batch=3)
    assert eng.use_micro_kernel == (path == "kernel")
    pol, ppol = _policies()
    state = eng.prefill(setup["batch"], None, pol, ppol, pad_count=setup["pads"])
    tth, tpe = (torch.from_numpy(setup[k]) for k in ("tth", "tpe"))
    before = dict(TRACE.counters)
    state, frames, n, lens, done = eng.decode_chunk(state, tth, 4, tpe, 3)
    state, _ = eng.decode_step(state, tth, 4, tpe)
    got = {k: TRACE.counters.get(k, 0) - before.get(k, 0)
           for k in ("predictor_frames.kernel", "predictor_frames.eager")}
    other = "eager" if path == "kernel" else "kernel"
    assert got == {f"predictor_frames.{path}": 4, f"predictor_frames.{other}": 0}
    assert frames.shape == (3, 3, 16) and int(n) == 3