"""The port's tracer (``qwen3tts_tpu_torch/utils/timing.py:TRACE``).

On the CPU, on ``random:tiny``: the spans of one streaming call and one
batch call (nesting, parent links, one request id a call), the loops'
timing dicts against their spans, the continuous batcher's spans and
counters, ``ttfa_ms`` counting the prompt build, the two-anchor clock
mapping and the stamp layout on synthetic numbers, and span sites that cost
nothing while the tracer is off.

The last case needs an NVIDIA card and nvcc and skips elsewhere: a
recording graph's device stamps on the 0.6B.  This file imports no JAX, so
on the card it runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""
import itertools
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.runtime import loops  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime.scheduler import ContinuousBatcher  # noqa: E402
from qwen3tts_tpu_torch.utils import timing  # noqa: E402
from qwen3tts_tpu_torch.utils.timing import TRACE, Tracer, to_host  # noqa: E402

SR = 24_000
NO_EOS = GenerationPolicy(do_sample=False, min_new_tokens=10_000)
PORT = Path(__file__).resolve().parents[1] / "qwen3tts_tpu_torch"


@pytest.fixture(scope="module")
def tts():
    return FasterQwen3TTS.from_pretrained("random:tiny", device="cpu")


@pytest.fixture()
def ref():
    t = np.linspace(0, 1.0, SR, dtype=np.float32)
    return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), SR


@pytest.fixture()
def traced():
    """The process's tracer on and empty for the test, off after it."""
    TRACE.clear()
    TRACE.enable()
    yield TRACE
    TRACE.disable()
    TRACE.clear()


def _inside(child, parent) -> bool:
    return parent.start <= child.start and child.end <= parent.end


def _check_tree(spans):
    """Every parent link names a recorded span that encloses its child."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None and s.parent in by_id:
            assert _inside(s, by_id[s.parent]), (s, by_id[s.parent])
    return by_id


def test_stream_and_batch_calls_nest_and_share_request_ids(tts, ref, traced):
    caller = []
    for _audio, _sr, _timing in tts.generate_voice_clone_streaming(
            "Hello there, tracer.", "English", ref, "", max_new_tokens=12, min_new_tokens=12,
            chunk_size=4):
        with traced.span("caller") as sp:  # the caller's code between chunks
            caller.append(sp)
    stream = [s for s in traced.spans() if s.name != "caller"]
    tts.generate_voice_clone_batch(["One text.", "A second, longer text."], "English", ref, "",
                                   max_new_tokens=8, min_new_tokens=8)
    batch = [s for s in traced.spans() if s.name != "caller"][len(stream):]

    for spans, names in ((stream, {"prompt", "warmup", "prefill", "decode", "dispatch",
                                   "read_wait"}),
                         (batch, {"prompt", "prefill", "decode", "dispatch", "read_wait",
                                  "vocode"})):
        assert names <= {s.name for s in spans}, {s.name for s in spans}
        rids = {s.rid for s in spans}
        assert len(rids) == 1 and None not in rids, rids
        by_id = _check_tree(spans)
        for s in spans:
            if s.name in ("dispatch", "read_wait"):
                assert by_id[s.parent].name == "decode"
    assert stream[0].rid != batch[0].rid
    assert len(caller) == 3 and {s.rid for s in traced.spans("caller")} == {None}
    assert len([s for s in stream if s.name == "decode"]) == 3  # 12 frames, chunks of 4
    assert len([s for s in batch if s.name == "vocode"]) == 2
    assert len([s for s in batch if s.name == "decode"]) == 1  # the whole chunk loop


def _prompt(tts, ref):
    embeds, trailing, tpe, _ = tts._prepare_clone("Timing dicts.", ref, "", "English", True,
                                                  True, True, None)
    return embeds, trailing, tpe


def test_loop_timings_equal_their_spans(tts, ref, traced):
    embeds, trailing, tpe = _prompt(tts, ref)
    kw = dict(generator=torch.Generator().manual_seed(0), max_new_tokens=8, policy=NO_EOS)
    traced.clear()
    _, timing_ = loops.fast_generate(tts.engine, embeds, trailing, tpe, device_chunk=4, **kw)
    (pre,), (dec,) = traced.spans("prefill"), traced.spans("decode")
    assert timing_["prefill_ms"] == (pre.end - pre.start) * 1000
    assert timing_["decode_s"] == dec.end - dec.start

    traced.clear()
    chunks = list(loops.fast_generate_streaming_audio(tts.engine, tts.vocoder, embeds,
                                                      trailing, tpe, chunk_size=4, **kw))
    (pre,), decs = traced.spans("prefill"), traced.spans("decode")
    assert chunks[0][2]["prefill_ms"] == (pre.end - pre.start) * 1000
    assert [c[2]["decode_ms"] for c in chunks] == [(d.end - d.start) * 1000 for d in decs]

    traced.clear()
    rows = np.concatenate([embeds, embeds]), np.concatenate([trailing, trailing]), \
        np.concatenate([tpe, tpe])
    _, timing_ = loops.fast_generate_batch(tts._batch_engine(2), *rows, device_chunk=4, **kw)
    (pre,), (dec,) = traced.spans("prefill"), traced.spans("decode")
    assert timing_["prefill_ms"] == (pre.end - pre.start) * 1000
    assert timing_["decode_s"] == dec.end - dec.start


def _drain(handles):
    out = {}

    def read(k, h):
        out[k] = [t for _, _, t in h.chunks()]

    threads = [threading.Thread(target=read, args=kv) for kv in handles.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "a stream never ended"
    return out


def test_scheduler_spans_and_counters(tts, ref, traced):
    b = ContinuousBatcher(tts, max_batch=2, chunk_size=4, max_new_tokens=64, policy=NO_EOS)
    b.warmup(prefill_buckets=(32, 64), max_tth=16)
    try:
        lengths = [8, 20, 8, 12]
        handles = {i: b.submit(f"Served utterance {i}.", "English", ref, "", max_new_tokens=n)
                   for i, n in enumerate(lengths)}
        reqs = {i: h._req for i, h in handles.items()}
        out = _drain(handles)
        assert [sum(t["chunk_steps"] for t in out[i]) for i in range(4)] == lengths
    finally:
        b.close()
    stats = b.stats
    spans = traced.spans()
    by_id = _check_tree(spans)
    names = {s.name for s in spans}
    assert {"prompt", "batch_setup", "embeds", "prefill", "tth", "vocinit", "prime",
            "dispatch", "fetch", "emit", "read_wait"} <= names, names
    for s in spans:
        if s.name in ("embeds", "prefill", "tth", "vocinit", "prime"):
            assert by_id[s.parent].name == "batch_setup"
    prompts = {s.rid for s in traced.spans("prompt")}
    assert prompts == {r.rid for r in reqs.values()} and None not in prompts
    joins = traced.spans("join")
    assert stats["joined_mid_batch"] >= 1 and len(joins) == stats["joined_mid_batch"]
    assert {s.rid for s in joins} <= prompts
    batch_rids = {s.rid for s in traced.spans({"batch_setup", "dispatch", "fetch", "emit"})}
    assert not batch_rids & prompts and None not in batch_rids
    assert stats["batches"] >= 1
    assert stats["max_batch_pos"] >= max(lengths) and stats["batch_pos"] == 0
    hits = [p for p in PORT.rglob("*.py") if "QWEN3TTS_BATCH_TRACE" in p.read_text()]
    assert not hits


def test_ttfa_counts_the_prompt_build(tts, ref, monkeypatch):
    build = tts._prepare_clone

    def slow(*a, **k):
        time.sleep(0.2)
        return build(*a, **k)

    monkeypatch.setattr(tts, "_prepare_clone", slow)
    b = ContinuousBatcher(tts, max_batch=2, chunk_size=4, max_new_tokens=8, policy=NO_EOS)
    try:
        before = time.perf_counter()
        h = b.submit("A slow prompt.", "English", ref, "", max_new_tokens=4)
        first = next(iter(h.chunks()))[2]
        waited = (time.perf_counter() - before) * 1000
        for _ in h.chunks():
            pass
    finally:
        b.close()
    assert first["queue_ms"] >= 200 and first["ttfa_ms"] >= first["queue_ms"]
    assert first["ttfa_ms"] <= waited


def test_clock_mapping_between_two_anchors():
    d0 = 1_760_000_000_123_456_789  # a globaltimer reading, ns
    anchors = [(100.0, d0), (110.0, d0 + 10_000_001_000)]  # the device 100 ppb fast
    got = to_host(np.array([d0, d0 + 10_000_001_000, d0 + 5_000_000_500, d0 - 1_000_000_100,
                            d0 + 20_000_002_000, d0 + 1], np.int64), anchors)
    rate = 10.0 / 10_000_001_000
    want = [100.0, 110.0, 105.0, 100.0 - 1_000_000_100 * rate, 120.0, 100.0 + rate]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[-1] > got[0]  # one nanosecond apart stays apart
    # one anchor: its offset alone
    np.testing.assert_allclose(to_host([d0 + 2_500_000_000], anchors[:1]), [102.5], atol=1e-12)
    # the anchors' order does not matter
    np.testing.assert_allclose(to_host([d0 + 5_000_000_500], anchors[::-1]), [105.0],
                               atol=1e-12)
    with pytest.raises(ValueError, match="anchor"):
        to_host([d0], [])


def test_device_parts_from_synthetic_stamps():
    """The stamp layout read back: four stamps a step that ran (0 where a
    step did not), the codec's two after the steps, ``n`` after them."""
    ns = 1_000_000_000
    reads = itertools.count()

    def clock():  # the device timer at 5 s when the host's reads 10 s, both at 1 s/s
        k = next(reads)
        return 10.0 + 10 * k, (5 + 10 * k) * ns

    tr = Tracer()
    tr.enable(clock=clock)
    stamps = torch.tensor([6 * ns, 6 * ns + 700, 6 * ns + 900, 6 * ns + 1000,  # step 0
                           6 * ns + 1100, 6 * ns + 1800, 6 * ns + 1950, 6 * ns + 2000,  # 1
                           0, 0, 0, 0,  # step 2 did not run
                           6 * ns + 2100, 6 * ns + 2600], dtype=torch.int64)  # codec
    with tr.scope(7):
        tr.device_replay(stamps, torch.tensor(2), steps=3, codec=True)
    parts = tr.device_spans()
    assert [p.name for p in parts] == ["predictor_frame", "talker_step", "step"] * 2 + [
        "codec_stream"]
    assert {p.rid for p in parts} == {7}
    np.testing.assert_allclose([(p.end - p.start) * 1e9 for p in parts],
                               [700, 200, 1000, 700, 150, 900, 500], atol=1e-3)
    assert abs(parts[0].start - 11.0) < 1e-9
    assert [p.name for p in tr.device_spans("talker_step", lo=11.0 + 1e-6)] == ["talker_step"]
    assert tr.counters["stamped_replays"] == 1
    # the summary: each part's count, median, largest and total ms
    dev = tr.summary()["device"]
    assert dev["step"]["n"] == 2 and dev["codec_stream"]["n"] == 1
    np.testing.assert_allclose([dev["talker_step"][k] for k in ("p50_ms", "max_ms", "total_ms")],
                               [175e-6, 200e-6, 350e-6], rtol=1e-6)


def test_spans_cost_nothing_while_off(tts, ref, monkeypatch):
    TRACE.disable()
    TRACE.clear()
    tr = Tracer()
    a, b = tr.span("a"), TRACE.span("b")
    assert a is b is timing._OFF  # one shared object: no allocation a site
    assert tr.scope(3) is timing._OFF

    def no_clock():
        raise AssertionError("a span site read the clock while the tracer was off")

    with monkeypatch.context() as m:
        m.setattr(timing.time, "perf_counter", no_clock)
        with tr.span("a") as sp:
            assert sp is None
        assert tr.begin("b") is None
        tr.end(None)
        tr.end(tr.begin("c", 0.0), 1.0)
        tr.device_replay(torch.zeros(4, dtype=torch.int64), torch.tensor(1), 1, False)
    assert tr.spans() == [] and tr.stamped_replays() == []
    tr.count("kept")
    assert tr.counters == {"kept": 1}  # counters are kept while off
    wavs, _ = tts.generate_voice_clone("Untraced.", "English", ref, "", max_new_tokens=4,
                                       min_new_tokens=4)
    assert wavs[0].shape == (4 * tts.vocoder.spf,)
    assert TRACE.spans() == []


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the stamp kernel has no CPU mode")


@pytest.mark.cuda
def test_stamps_on_the_card(monkeypatch):
    """A recording graph with stamps walks to the same kernel nodes as one
    without; its stamps are ordered within each step (and the steps in
    order); the stamped parts of a replay (steps and codec) sum to within
    3 % of its CUDA-event time."""
    _need_card()
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.ops.cuda_build import KERNEL_SYMBOLS
    from qwen3tts_tpu_torch.runtime import graphs as graphs_lib

    cfg = get_preset("qwen3-tts-0.6b")
    m = FasterQwen3TTS(cfg, init_random(cfg, seed=3, dtype=torch.bfloat16, device="cuda"),
                       max_seq_len=256)
    gen = torch.Generator(device="cuda")
    H = cfg.talker.hidden_size
    prompt = (np.random.default_rng(0).standard_normal((1, 40, H)) * 0.05).astype(np.float32)
    trailing = np.zeros((1, 8, H), np.float32)
    tpe = np.zeros((1, 1, H), np.float32)
    walked = {}
    for stamps in (False, True):
        if not stamps:  # a recording graph with no stamp captured
            monkeypatch.setattr(graphs_lib, "_Stamps", lambda *a: None)
        m.engine.graphs = graphs = graphs_lib.ChunkGraphs(m.engine, record=True)
        TRACE.clear()
        for _ in loops.fast_generate_streaming_audio(
                m.engine, m.vocoder, prompt, trailing, tpe, generator=gen.manual_seed(1),
                max_new_tokens=32, policy=NO_EOS, chunk_size=8):
            pass
        torch.cuda.synchronize()
        g = graphs.log[0][0]
        assert (g.stamps is not None) == stamps
        walked[stamps] = graphs.kernel_nodes(g, list(KERNEL_SYMBOLS.values()))
        monkeypatch.undo()
    assert walked[True] == walked[False]
    replays = TRACE.stamped_replays()
    assert len(replays) == len(graphs.log) == 4
    # the first replay of a graph also uploads it: compare the later three
    for (rec, raw, n), (_g, n_log, start, end) in list(zip(replays, graphs.log))[1:]:
        assert n == int(n_log) == rec.steps == 8 and rec.codec
        steps = raw[:4 * n].reshape(n, 4)
        assert (steps > 0).all() and (np.diff(steps.reshape(-1)) >= 0).all()
        assert raw[-2] >= steps[-1, 3] and raw[-1] >= raw[-2]
        stamped_ms = ((steps[:, 3] - steps[:, 0]).sum() + raw[-1] - raw[-2]) * 1e-6
        event_ms = start.elapsed_time(end)
        assert abs(stamped_ms - event_ms) <= 0.03 * event_ms, (stamped_ms, event_ms)
    TRACE.disable()
    TRACE.clear()
