"""The port's continuous batcher under load, on the CPU: the five
``tests/test_scheduler.py`` tests that the JAX package marks ``slow``
(compile-heavy there; the port compiles nothing), with their request counts,
budgets, seeds and cancel points.

- 8 concurrent requests of mixed lengths through a 4-row batch;
- pipeline depths 1 and 4, with a mid-batch join;
- a seeded fuzz of staggered submits, mixed budgets and cancels at depth 5;
- predictive budget retirement: a row whose budget an in-flight chunk
  exhausts frees its slot at dispatch;
- a short request submitted after a long-prompt one starts first.

The model is the JAX ``random:tiny`` (float32) carried across by
``bundle_from_jax_numpy``, as in ``tests/test_torch_scheduler.py``.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402

from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime.scheduler import ContinuousBatcher  # noqa: E402

# deterministic: greedy, EOS suppressed past the step budget so every row
# runs to its own max_new_tokens
NO_EOS = GenerationPolicy(do_sample=False, min_new_tokens=10_000)


@pytest.fixture(scope="module")
def port_tts(tiny_tts):
    """The JAX ``random:tiny`` weights in the port, codec in float32."""
    cfg = get_preset("tiny")
    params = bundle_from_jax_numpy(jax.tree.map(np.asarray, tiny_tts.params), cfg,
                                   torch.float32, "cpu")
    return FasterQwen3TTS(cfg, params, vocoder_compute_dtype=None)


def _collect(handle):
    chunks = [a for a, _, _ in handle.chunks()]
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def _drain_all(handles: dict) -> dict:
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


def test_eight_concurrent_mixed_lengths(port_tts, ref_wav):
    """8 concurrent requests with mixed text and budget lengths through a
    4-row batch: every stream completes with exactly its own budget."""
    spf = port_tts.vocoder.spf
    b = ContinuousBatcher(port_tts, max_batch=4, chunk_size=4,
                          max_new_tokens=64, policy=NO_EOS)
    try:
        lengths = [8, 12, 16, 8, 20, 12, 8, 16]
        handles = {
            i: b.submit(f"Mixed load utterance number {i} with extra words "
                        + "padding " * (i % 3), "English", ref_wav, "ref",
                        max_new_tokens=n)
            for i, n in enumerate(lengths)
        }
        outs = _drain_all(handles)
        assert sorted(outs) == list(range(8))
        for i, n in enumerate(lengths):
            assert len(outs[i]) == n * spf, (i, n, len(outs[i]))
            assert np.isfinite(outs[i]).all()
        assert b.stats["served"] == 8
        # the worker zeroes active_rows a moment after the final sentinel
        deadline = time.time() + 30
        while time.time() < deadline and b.stats["active_rows"] != 0:
            time.sleep(0.05)
        assert b.stats["active_rows"] == 0
    finally:
        b.close()


@pytest.mark.parametrize("depth", [1, 4])
def test_pipeline_depth_invariants(port_tts, ref_wav, monkeypatch, depth):
    """At any pipeline depth (joins and forces written at the tail, a join
    visible from the first chunk dispatched after it) every request, seed
    or mid-batch joiner, gets exactly its budget of finite audio."""
    monkeypatch.setenv("QWEN3TTS_BATCH_PIPELINE", str(depth))
    spf = port_tts.vocoder.spf
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=64, policy=NO_EOS)
    b.warmup(prefill_buckets=(32, 64), max_tth=16)
    try:
        lengths = [8, 20, 8, 12, 16]
        handles = {
            i: b.submit(f"Depth {depth} utterance {i}.", "English", ref_wav, "ref",
                        max_new_tokens=n)
            for i, n in enumerate(lengths)
        }
        outs = _drain_all(handles)
        assert sorted(outs) == list(range(5))
        for i, n in enumerate(lengths):
            assert len(outs[i]) == n * spf, (depth, i, n, len(outs[i]))
            assert np.isfinite(outs[i]).all()
        assert b.stats["served"] == 5
        assert b.stats["joined_mid_batch"] >= 1
    finally:
        b.close()


def test_randomized_stress_mixed_cancels_and_budgets(port_tts, ref_wav, monkeypatch):
    """Seeded fuzz at pipeline depth 5: staggered submits, mixed budgets,
    cancels at random points (before the first chunk too).  Every request
    not cancelled gets exactly its budget of finite audio, every cancelled
    stream still ends, and the batcher retires everything."""
    rng = np.random.default_rng(1337)
    monkeypatch.setenv("QWEN3TTS_BATCH_PIPELINE", "5")
    spf = port_tts.vocoder.spf
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=64, policy=NO_EOS, first_chunks=(1, 2))
    b.warmup(prefill_buckets=(32, 64), max_tth=16)
    N = 12
    plans = []  # (n_tokens, cancel_after_chunks or None, submit_delay_s)
    for _ in range(N):
        n = int(rng.integers(4, 41))
        cancel_after = int(rng.integers(0, 3)) if rng.random() < 0.3 else None
        plans.append((n, cancel_after, float(rng.random()) * 0.3))
    outs, errs = {}, {}

    def run(i, n, cancel_after, delay):
        time.sleep(delay)
        try:
            h = b.submit(f"Stress utterance {i}.", "English", ref_wav, "ref",
                         max_new_tokens=n)
            if cancel_after == 0:
                h.cancel()  # possibly before admission
            chunks = []
            for k, (a, _, _) in enumerate(h.chunks()):
                chunks.append(a)
                if cancel_after is not None and k + 1 >= cancel_after:
                    h.cancel()
            outs[i] = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        except Exception as e:  # pragma: no cover - reported below
            errs[i] = e

    try:
        threads = [threading.Thread(target=run, args=(i, *p)) for i, p in enumerate(plans)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not errs, errs
        assert sorted(outs) == list(range(N)), "a stream never ended"
        for i, (n, cancel_after, _) in enumerate(plans):
            assert np.isfinite(outs[i]).all(), i
            if cancel_after is None:
                assert len(outs[i]) == n * spf, (i, n, len(outs[i]))
            else:
                assert len(outs[i]) <= n * spf, (i, n, len(outs[i]))
        assert b.stats["served"] == N
        assert b.stats["active_rows"] == 0
        assert b.stats["queue_depth"] == 0
        # the batcher is still healthy after the storm
        h = b.submit("Post-storm sanity.", "English", ref_wav, "ref", max_new_tokens=8)
        assert len(_collect(h)) == 8 * spf
    finally:
        b.close()


def test_predictive_budget_retirement_frees_slot_early(port_tts, ref_wav):
    """A row whose budget an in-flight chunk exhausts is retired at dispatch
    (the read only confirms it), so its replacement joins earlier; every
    stream still delivers exactly its budget, the retiring row's last frames
    riding chunks still in flight when its slot is handed over."""
    spf = port_tts.vocoder.spf
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=64, policy=NO_EOS)
    b.warmup(prefill_buckets=(32,), max_tth=16)
    try:
        budgets = {"a": 8, "b": 16, "c": 12}
        handles = {
            "a": b.submit("Seed one.", "English", ref_wav, "ref", max_new_tokens=budgets["a"]),
            "b": b.submit("Seed two.", "English", ref_wav, "ref", max_new_tokens=budgets["b"]),
        }
        results = {}
        first_chunk = threading.Event()

        def drain(name, h):
            total = 0
            for a, _, _ in h.chunks():
                total += len(a)
                first_chunk.set()
            results[name] = total

        threads = [threading.Thread(target=drain, args=(n, h)) for n, h in handles.items()]
        for t in threads:
            t.start()
        assert first_chunk.wait(timeout=300)
        # joins into the slot that "a" vacates predictively at budget 8
        hc = b.submit("Late joiner.", "English", ref_wav, "ref", max_new_tokens=budgets["c"])
        drain("c", hc)
        for t in threads:
            t.join(timeout=600)
        for name, budget in budgets.items():
            assert results[name] == budget * spf, (name, results[name])
        assert b.stats["retired_predictively"] >= 1, b.stats
        assert b.stats["served"] == 3
    finally:
        b.close()


def test_long_head_does_not_delay_short_joiner_end_to_end(port_tts, ref_wav):
    """With the only free row gated, a short request submitted after a
    long-prompt request still starts first (out-of-order admission), and
    both are served in full."""
    spf = port_tts.vocoder.spf
    b = ContinuousBatcher(port_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=200, policy=NO_EOS)
    try:
        first_chunk = threading.Event()
        results = {}

        def drain(name, h):
            total = 0
            for a, _, _ in h.chunks():
                total += len(a)
                first_chunk.set()
            results[name] = total

        # row A retires early (frees a row while pos is still small); row B
        # keeps the batch alive long enough for every admission
        ha = b.submit("A.", "English", ref_wav, "ref", max_new_tokens=24)
        hb = b.submit("B.", "English", ref_wav, "ref", max_new_tokens=160)
        ta = threading.Thread(target=drain, args=("a", ha))
        tb = threading.Thread(target=drain, args=("b", hb))
        ta.start()
        tb.start()
        assert first_chunk.wait(timeout=300)
        long_text = " ".join(["lengthy, deliberately padded clause"] * 3)
        hl = b.submit(long_text, "English", ref_wav, "ref", max_new_tokens=8)
        hs = b.submit("Short.", "English", ref_wav, "ref", max_new_tokens=8)
        drain("long", hl)
        drain("short", hs)
        ta.join(timeout=600)
        tb.join(timeout=600)
        assert results["short"] == 8 * spf
        assert results["long"] == 8 * spf
        assert 0 < hs._req.started_at < hl._req.started_at, (
            "short request should start before the gated long head")
    finally:
        b.close()
