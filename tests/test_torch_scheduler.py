"""The port's continuous batcher (``qwen3tts_tpu_torch/runtime/scheduler.py``)
on the CPU, against the JAX package.

The model is the JAX ``random:tiny`` (float32) carried across by
``bundle_from_jax_numpy``, its codec computing in float32.

- Parity: a greedy batcher (talker and predictor greedy, EOS suppressed) of
  two rows serves three requests; the third waits for a row and joins the
  running batch when the first retires.  Each request's audio equals the
  JAX ``Engine``'s batch-1 streamed audio (``fast_generate_streaming_audio``
  with a float32 codec) for the same prompt within 1e-5, and
  ``joined_mid_batch`` is at least 1.
- Each non-slow test of ``tests/test_scheduler.py``, on the port: a third
  request submitted while the batch runs joins it; more requests than rows;
  cancel; the freed row; FIFO; the final chunk; a stalled consumer; warmup
  below the smallest trailing-text bucket; the timing dict; a failed chunk;
  the ``first_chunks`` ramp; the unwarmed-bucket warning; admission past a
  blocked head and by window budget; the start burst and ``arriving()``;
  the post-join ramp; ``QWEN3TTS_SERVE_PCM16``.
"""
import logging
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.audio.vocoder import Vocoder as JVocoder  # noqa: E402
from qwen3tts_tpu.models.predictor import SamplingPolicy as JSamplingPolicy  # noqa: E402
from qwen3tts_tpu.runtime import loops as jloops  # noqa: E402
from qwen3tts_tpu.runtime.engine import GenerationPolicy as JGenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime import scheduler as S  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime.scheduler import ContinuousBatcher  # noqa: E402

# deterministic: greedy, EOS suppressed past the step budget so every row
# runs to its own max_new_tokens
NO_EOS = GenerationPolicy(do_sample=False, min_new_tokens=10_000)
AUDIO_ATOL = 1e-5  # float32 codec, batched vs batch-1: summation order only


@pytest.fixture(scope="module")
def port_tts(tiny_tts):
    """The JAX ``random:tiny`` weights in the port, codec in float32."""
    cfg = get_preset("tiny")
    params = bundle_from_jax_numpy(jax.tree.map(np.asarray, tiny_tts.params), cfg,
                                   torch.float32, "cpu")
    return FasterQwen3TTS(cfg, params, vocoder_compute_dtype=None)


@pytest.fixture()
def batcher(port_tts):
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=8,
                          max_new_tokens=40, policy=NO_EOS)
    b.warmup(prefill_buckets=(32, 64), max_tth=16)
    yield b
    b.close()


def _collect(handle):
    chunks = [a for a, _, _ in handle.chunks()]
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def _drain_all(handles) -> dict:
    """Each handle's audio, read on a thread of its own."""
    outs = {}
    threads = [threading.Thread(target=lambda k, h: outs.__setitem__(k, _collect(h)),
                                args=(k, h)) for k, h in handles.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "a stream never ended"
    return outs


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------

def test_served_audio_equals_jax_batch1_stream(port_tts, tiny_tts, ref_wav, monkeypatch):
    monkeypatch.setenv("QWEN3TTS_SERVE_PCM16", "0")  # float32 audio from the card side
    budgets = {"First utterance.": 16, "A different second text.": 40,
               "Late third arrival.": 24}
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=8, max_new_tokens=40,
                          policy=NO_EOS, pred_policy=SamplingPolicy(do_sample=False))
    try:
        # the third finds both rows busy and joins when the first retires
        handles = {t: b.submit(t, "English", ref_wav, "ref", max_new_tokens=n)
                   for t, n in budgets.items()}
        served = _drain_all(handles)
        assert b.stats["served"] == 3
        assert b.stats["joined_mid_batch"] >= 1
    finally:
        b.close()

    jvoc = JVocoder(tiny_tts.params["codec"], tiny_tts.cfg.codec, compute_dtype=jnp.float32)
    for text, n in budgets.items():
        embeds, trailing, tpe, _ = port_tts._prepare_clone(
            text, ref_wav, "ref", "English", True, True, True, None)
        want = np.concatenate([a for _, a, _ in jloops.fast_generate_streaming_audio(
            tiny_tts.engine, jvoc, embeds, jnp.asarray(trailing), jnp.asarray(tpe),
            key=jax.random.PRNGKey(0), max_new_tokens=n,
            policy=JGenerationPolicy(do_sample=False, min_new_tokens=10_000),
            pred_policy=JSamplingPolicy(do_sample=False), chunk_size=8)])
        got = served[text]
        assert got.shape == want.shape == (n * port_tts.vocoder.spf,), text
        np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL, err_msg=text)


# ---------------------------------------------------------------------------
# tests/test_scheduler.py, on the port
# ---------------------------------------------------------------------------

def test_two_requests_batch_and_third_joins(batcher, port_tts, ref_wav):
    spf = port_tts.vocoder.spf
    h1 = batcher.submit("First utterance.", "English", ref_wav, "ref")
    h2 = batcher.submit("A different second text.", "English", ref_wav, "ref")
    results = {}
    first_chunk = threading.Event()

    def drain(name, h):
        chunks = []
        for a, _, _ in h.chunks():
            chunks.append(a)
            first_chunk.set()
        results[name] = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    t1 = threading.Thread(target=drain, args=("a", h1))
    t2 = threading.Thread(target=drain, args=("b", h2))
    t1.start()
    t2.start()
    # submitted once the batch has provably started streaming: it must join
    # the running batch (both rows busy until their budget)
    assert first_chunk.wait(timeout=300), "batch never produced a chunk"
    h3 = batcher.submit("Late third arrival.", "English", ref_wav, "ref")
    results["c"] = _collect(h3)
    t1.join(timeout=600)
    t2.join(timeout=600)

    for name in ("a", "b", "c"):
        wav = results[name]
        assert len(wav) == 40 * spf, f"row {name}: {len(wav)} samples"
        assert np.isfinite(wav).all()
    assert batcher.stats["served"] == 3
    assert batcher.stats["joined_mid_batch"] >= 1, (
        "third request was not admitted into the running batch")


def test_more_requests_than_rows_all_served(batcher, port_tts, ref_wav):
    spf = port_tts.vocoder.spf
    handles = {i: batcher.submit(f"Utterance number {i}.", "English", ref_wav, "ref",
                                 max_new_tokens=16) for i in range(5)}
    outs = _drain_all(handles)
    assert len(outs) == 5
    for wav in outs.values():
        assert len(wav) == 16 * spf
    assert batcher.stats["served"] == 5


def test_cancel_stops_stream_early(batcher, ref_wav):
    h = batcher.submit("A long cancelled utterance.", "English", ref_wav, "ref")
    got = []
    for audio, _, _ in h.chunks():
        got.append(audio)
        h.cancel()
    total = sum(len(a) for a in got)
    assert 0 < total < 40 * batcher.model.vocoder.spf


def test_cancel_releases_row_for_pending_request(port_tts, ref_wav):
    """Cancelling a running request frees its row (and marks it done on the
    device), so a queued request is served without waiting out the budget."""
    spf = port_tts.vocoder.spf
    b = ContinuousBatcher(port_tts, max_batch=1, chunk_size=8,
                          max_new_tokens=400, policy=NO_EOS)
    try:
        ha = b.submit("A very long utterance to be cancelled.", "English", ref_wav, "ref")
        it = ha.chunks()
        next(it)  # A occupies the only row
        hb = b.submit("Short follower.", "English", ref_wav, "ref", max_new_tokens=16)
        ha.cancel()
        wav_b = _collect(hb)  # completes: the row was released
        assert len(wav_b) == 16 * spf
        for _ in it:  # drain A to its end
            pass
        assert b.stats["cancelled"] == 1
        assert b.stats["served"] == 2
    finally:
        b.close()


def test_pending_requests_admitted_fifo(port_tts, ref_wav):
    """With every row busy, queued requests are admitted in submission
    order."""
    b = ContinuousBatcher(port_tts, max_batch=1, chunk_size=4,
                          max_new_tokens=12, policy=NO_EOS)
    try:
        ha = b.submit("Occupies the row.", "English", ref_wav, "ref")
        hc = b.submit("Queued first.", "English", ref_wav, "ref")
        hd = b.submit("Queued second.", "English", ref_wav, "ref")
        results = _drain_all({"a": ha, "c": hc, "d": hd})
        assert sorted(results) == ["a", "c", "d"]
        assert 0 < hc._req.started_at < hd._req.started_at
    finally:
        b.close()


def test_join_during_final_chunk(port_tts, ref_wav):
    """A request submitted while the batch is inside its final chunk is
    served (by joining it or by a new batch) with exactly its length."""
    spf = port_tts.vocoder.spf
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=8,
                          max_new_tokens=16, policy=NO_EOS)
    try:
        ha = b.submit("Two chunk utterance.", "English", ref_wav, "ref")
        it = ha.chunks()
        next(it)  # chunk 1 of 2 received: the batch is in its final chunk
        hb = b.submit("Late joiner.", "English", ref_wav, "ref")
        wav_b = _collect(hb)
        rest = sum(len(a) for a, _, _ in it)
        assert rest + 8 * spf == 16 * spf
        assert len(wav_b) == 16 * spf
        assert b.stats["served"] == 2
    finally:
        b.close()


def test_queue_full_fails_stream_not_drops(port_tts, ref_wav, monkeypatch):
    """A consumer that stops pulling gets a failed stream (an error and the
    row retired), never silently gapped audio."""
    monkeypatch.setattr(S, "OUT_QUEUE_SIZE", 2)
    monkeypatch.setattr(S, "EMIT_TIMEOUT_S", 0.2)
    b = ContinuousBatcher(port_tts, max_batch=1, chunk_size=4,
                          max_new_tokens=200, policy=NO_EOS)
    try:
        h = b.submit("A stream nobody reads.", "English", ref_wav, "ref")
        deadline = time.time() + 120
        while time.time() < deadline and b.stats["cancelled"] < 1:
            time.sleep(0.1)
        assert b.stats["cancelled"] == 1, "stalled stream was never failed"
        with pytest.raises(RuntimeError, match="stalled"):
            for _ in h.chunks():
                pass
        # the scheduler keeps serving after the failure
        h2 = b.submit("Healthy follower.", "English", ref_wav, "ref", max_new_tokens=8)
        assert len(_collect(h2)) == 8 * b.model.vocoder.spf
    finally:
        b.close()


def test_warmup_below_smallest_tth_bucket(batcher):
    """warmup(max_tth=8) with TTH_BUCKETS starting at 16 warms the smallest
    bucket instead of failing on an empty list."""
    batcher.warmup(max_tth=8)
    assert batcher._tth_floor == 16


def test_timing_contract(batcher, ref_wav):
    h = batcher.submit("Check the timing dict.", "English", ref_wav, "ref", max_new_tokens=16)
    timings = [t for _, _, t in h.chunks()]
    assert timings, "no chunks emitted"
    assert "ttfa_ms" in timings[0] and timings[0]["ttfa_ms"] > 0
    assert timings[0]["chunk_index"] == 0
    assert timings[-1]["total_steps_so_far"] == 16
    for t in timings:
        assert t["chunk_steps"] > 0 and "queue_ms" in t


def test_worker_failure_fails_live_streams_not_hangs(port_tts, ref_wav, monkeypatch):
    """An unexpected error mid-batch surfaces as an error on every live
    stream, and the worker survives to serve the next batch."""
    calls = {"n": 0}
    real = Engine.chunk_vocode_batched

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:  # let the batch get rolling, then fail
            raise RuntimeError("injected device fault")
        return real(self, *a, **k)

    monkeypatch.setattr(Engine, "chunk_vocode_batched", flaky)
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=400, policy=NO_EOS)
    try:
        h = b.submit("Doomed stream.", "English", ref_wav, "ref")
        with pytest.raises(RuntimeError, match="batch serving failed"):
            for _ in h.chunks():
                pass
        h2 = b.submit("Recovery stream.", "English", ref_wav, "ref", max_new_tokens=8)
        assert len(_collect(h2)) == 8 * b.model.vocoder.spf
    finally:
        b.close()


def test_first_chunks_ramp_cuts_first_audio_size(port_tts, ref_wav, monkeypatch):
    """``first_chunks``: after the batch starts and after a mid-batch join
    the dispatch sizes run the ramp again, so the newest row's first audio
    is ramp[0] frames, while every stream delivers exactly its budget."""
    monkeypatch.setattr(S, "RAMP_FRESH_S", 60.0)  # the joiner counts as fresh
    spf = port_tts.vocoder.spf
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=24, policy=NO_EOS, first_chunks=(1, 2))
    b.warmup(prefill_buckets=(32, 64), max_tth=16)
    try:
        h1 = b.submit("Ramp seed one.", "English", ref_wav, "ref")
        h2 = b.submit("Ramp seed two.", "English", ref_wav, "ref")
        sizes, totals = {}, {}
        first_chunk = threading.Event()

        def drain(name, h):
            chunks = []
            for a, _, _ in h.chunks():
                chunks.append(a)
                first_chunk.set()  # the batch is running
            sizes[name] = [len(a) for a in chunks]
            totals[name] = sum(len(a) for a in chunks)

        t1 = threading.Thread(target=drain, args=("a", h1))
        t2 = threading.Thread(target=drain, args=("b", h2))
        t1.start()
        t2.start()
        assert first_chunk.wait(timeout=300)
        h3 = b.submit("Ramp joiner.", "English", ref_wav, "ref")
        drain("c", h3)
        t1.join(timeout=600)
        t2.join(timeout=600)

        for name in ("a", "b", "c"):
            assert totals[name] == 24 * spf, (name, totals[name])
            assert sizes[name][0] == 1 * spf, (name, sizes[name])
            assert sizes[name][1] == 2 * spf, (name, sizes[name])
        assert b.stats["joined_mid_batch"] >= 1
    finally:
        b.close()


def test_unwarmed_bucket_warns(port_tts, ref_wav, caplog):
    """A batch at a prefill bucket that warmup() did not run logs a warning
    naming the bucket, once; warmed buckets stay silent."""
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=8, policy=NO_EOS)
    try:
        b.warmup(prefill_buckets=(32,), max_tth=16)
        with caplog.at_level(logging.WARNING, logger="qwen3tts_tpu_torch.runtime.scheduler"):
            b._check_warmed(32)
            assert not caplog.records
            b._check_warmed(256)
            assert any("256" in r.message and "not warmed" in r.message
                       for r in caplog.records)
            n = len(caplog.records)
            b._check_warmed(256)  # once per bucket
            assert len(caplog.records) == n
        h = b.submit("Post-warn sanity.", "English", ref_wav, "ref", max_new_tokens=8)
        assert len(_collect(h)) == 8 * port_tts.vocoder.spf
    finally:
        b.close()


# ---------------------------------------------------------------------------
# admission policy units (the worker is stopped and the internals driven
# directly; no engine work runs)
# ---------------------------------------------------------------------------

def _stopped_batcher(port_tts):
    """A batcher whose worker has exited cleanly."""
    b = ContinuousBatcher(port_tts, max_batch=4, chunk_size=8,
                          max_new_tokens=40, policy=NO_EOS)
    b._pending.put(S._SENTINEL)
    b._worker.join(timeout=10)
    assert not b._worker.is_alive()
    b._stop.clear()  # re-arm the internals for direct driving
    return b


def _req(port_tts, prompt_len, max_new_tokens=40):
    H = port_tts.cfg.talker.hidden_size
    return S._Request(
        embeds=np.zeros((1, prompt_len, H), np.float32),
        trailing=np.zeros((1, 4, H), np.float32),
        tpe=np.zeros((1, 1, H), np.float32),
        ref_codes=None, max_new_tokens=max_new_tokens)


def test_admission_skips_blocked_head(port_tts):
    """A long-prompt head whose bucket exceeds the batch position does not
    block admissible requests queued behind it."""
    b = _stopped_batcher(port_tts)
    long_req = _req(port_tts, 100)  # bucket 128
    short_req = _req(port_tts, 20)  # bucket 32
    b._waiting[:] = [long_req, short_req]
    got = b._peek_admissible(pos_lb=40, pos_ub=40, limit=2047)
    assert got is short_req, "short request was blocked behind the long head"
    assert b._waiting == [long_req]
    # once the position clears the head's bucket, FIFO order resumes
    b._waiting[:] = [long_req, short_req]
    assert b._peek_admissible(pos_lb=128, pos_ub=128, limit=2047) is long_req


def test_admission_respects_window_budget_per_request(port_tts):
    """A head that cannot fit its budget into the remaining window is
    skipped for one that can."""
    b = _stopped_batcher(port_tts)
    big_budget = _req(port_tts, 20, max_new_tokens=2048)
    tiny_budget = _req(port_tts, 20, max_new_tokens=8)
    b._waiting[:] = [big_budget, tiny_budget]
    got = b._peek_admissible(pos_lb=2000, pos_ub=2000, limit=2047)
    assert got is tiny_budget, "fit-able request was blocked behind the big one"


def test_start_burst_collects_concurrent_arrivals(port_tts):
    """With >= 2 requests waiting the batch-start window keeps collecting
    arrivals; a lone request starts with no added wait."""
    b = _stopped_batcher(port_tts)
    b._waiting[:] = [_req(port_tts, 20)]
    t0 = time.time()
    b._collect_start_burst()
    assert time.time() - t0 < S.START_WINDOW_S, "lone request waited"
    assert len(b._waiting) == 1

    b._waiting[:] = [_req(port_tts, 20), _req(port_tts, 20)]
    late = _req(port_tts, 20)

    def put_late():
        time.sleep(S.START_WINDOW_S / 2)
        b._pending.put(late)

    threading.Thread(target=put_late).start()
    b._collect_start_burst()
    assert any(r is late for r in b._waiting), "in-window arrival missed the batch start"
    assert len(b._waiting) == 3


def test_arriving_hint_holds_batch_start_for_preparing_flood(port_tts):
    """While arrivals advertised by ``arriving()`` are still preparing, the
    collector keeps waiting (bounded by the cap), past the point where a
    lone request would start."""
    b = _stopped_batcher(port_tts)
    b._waiting[:] = [_req(port_tts, 20)]
    late = _req(port_tts, 20)
    cm = b.arriving()
    cm.__enter__()

    def put_late():
        time.sleep(S.START_WINDOW_S * 3)
        b._pending.put(late)
        cm.__exit__(None, None, None)

    threading.Thread(target=put_late).start()
    b._collect_start_burst()
    assert any(r is late for r in b._waiting), "advertised arrival missed the batch start"
    assert len(b._waiting) == 2


def test_post_join_ramp_skips_saturated_joiners(port_tts):
    """The post-join ramp runs again only for joiners that waited less than
    RAMP_FRESH_S."""
    b = _stopped_batcher(port_tts)
    b.first_chunks = (2, 4)
    now = time.time()
    fresh = _req(port_tts, 20)
    fresh.submitted_at, fresh.started_at = now - 0.01, now
    stale = _req(port_tts, 20)
    stale.submitted_at, stale.started_at = now - 10.0, now
    assert b._ramp_after_join([fresh])
    assert not b._ramp_after_join([stale])
    assert b._ramp_after_join([stale, fresh])  # one fresh joiner is enough
    b.first_chunks = ()
    assert not b._ramp_after_join([fresh])  # no ramp configured at all


def test_pcm16_flag_honoured(port_tts, monkeypatch):
    """QWEN3TTS_SERVE_PCM16 is read at construction: on by default, '0'
    off."""
    monkeypatch.delenv("QWEN3TTS_SERVE_PCM16", raising=False)
    b = ContinuousBatcher(port_tts, max_batch=1, chunk_size=8)
    try:
        assert b._pcm16 is True
    finally:
        b.close()
    monkeypatch.setenv("QWEN3TTS_SERVE_PCM16", "0")
    b = ContinuousBatcher(port_tts, max_batch=1, chunk_size=8)
    try:
        assert b._pcm16 is False
    finally:
        b.close()
