"""The port's replica pool (``qwen3tts_tpu_torch/runtime/replicas.py``) on
the CPU: the JAX ``random:tiny`` weights (float32) carried across by
``bundle_from_jax_numpy``, two replicas on the one CPU device (the source
model serves the first, ``replicate_to`` makes the second).

- ``tests/test_replicas.py``'s non-slow test: requests spread over both
  replicas and complete;
- ``replicate_to`` shares the host-side helpers and nothing mutable;
  identical greedy requests give identical audio on both replicas;
- a dead replica is routed around, and the pool raises when none is left;
- ``--replicas`` beyond the cards there are warns and uses what there is.
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402

from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime import replicas as R  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime.replicas import ReplicaPool  # noqa: E402

# both heads greedy (the replicas' generators differ), EOS suppressed
NO_EOS = GenerationPolicy(do_sample=False, min_new_tokens=10_000)
GREEDY_PRED = SamplingPolicy(do_sample=False)
MAX_NEW = 16


@pytest.fixture(scope="module")
def port_tts(tiny_tts):
    cfg = get_preset("tiny")
    return FasterQwen3TTS(cfg, bundle_from_jax_numpy(jax.tree.map(np.asarray, tiny_tts.params),
                                                     cfg, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def pool(port_tts):
    p = ReplicaPool(port_tts, ["cpu", "cpu"], max_batch=2, chunk_size=8,
                    max_new_tokens=MAX_NEW, policy=NO_EOS, pred_policy=GREEDY_PRED)
    p.warmup(prefill_buckets=(32,), max_tth=16)
    yield p
    p.close()


def _collect(handle):
    chunks = [a for a, _, _ in handle.chunks()]
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def test_replicas_share_host_helpers_only(pool, port_tts):
    assert len(pool.models) == 2
    m0, m1 = pool.models
    assert m0 is port_tts and m1 is not port_tts
    for m, dev in zip(pool.models, pool.devices):
        assert m.device == dev
        assert m.params["talker"]["codec_embedding"].device == dev
    assert m0.tokenizer is m1.tokenizer
    assert m0.prompt_builder is m1.prompt_builder
    assert m0.engine is not m1.engine
    assert m0.vocoder is not m1.vocoder
    assert m0._voice_prompt_cache is not m1._voice_prompt_cache
    assert m0._gen is not m1._gen
    assert pool.batchers[0].engine is not pool.batchers[1].engine


def test_requests_spread_and_complete(pool, port_tts, ref_wav):
    spf = port_tts.vocoder.spf
    handles = [pool.submit(f"Utterance number {i}.", "English", ref_wav, "ref")
               for i in range(4)]
    for h in handles:
        audio = _collect(h)
        assert len(audio) == MAX_NEW * spf
        assert np.isfinite(audio).all()
    st = pool.stats
    assert st["served"] == 4
    assert len(st["replicas"]) == 2
    # least-loaded + round-robin routing uses both replicas
    assert all(r["served"] >= 1 for r in st["replicas"])
    assert all(r["inflight"] == 0 for r in st["replicas"])


def test_identical_requests_give_identical_audio_across_replicas(pool, ref_wav):
    # greedy + identical weights: the same request gives the same audio on
    # either replica (least-loaded routing with round-robin ties alternates)
    before = [r["served"] for r in pool.stats["replicas"]]
    a0 = _collect(pool.submit("Cross replica parity.", "English", ref_wav, "ref"))
    a1 = _collect(pool.submit("Cross replica parity.", "English", ref_wav, "ref"))
    assert [r["served"] - n for r, n in zip(pool.stats["replicas"], before)] == [1, 1]
    np.testing.assert_array_equal(a0, a1)


def test_replica_devices_warns_beyond_the_cards(monkeypatch, caplog):
    from qwen3tts_tpu_torch.apps import openai_server

    class Card:
        device = torch.device("cuda")

    monkeypatch.setattr(R, "local_devices", lambda: [torch.device("cuda", 0)])
    with caplog.at_level(logging.WARNING, logger="qwen3tts_tpu_torch.openai_server"):
        devs = openai_server.replica_devices(Card(), 3)
    assert devs == [torch.device("cuda", 0)]
    assert any("requested 3 replicas but only 1" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# failover: these kill the shared pool's replicas, so they run last
# ---------------------------------------------------------------------------

def _kill(pool, i, ref_wav):
    """Fail replica i's worker and wait until it is marked dead."""
    b = pool.batchers[i]

    def boom(batch):
        raise RuntimeError("injected replica fault")

    b._serve_batch = boom
    h = b.submit("Doomed.", "English", ref_wav, "ref")
    with pytest.raises(RuntimeError, match="worker died"):
        for _ in h.chunks():
            pass
    b._worker.join(timeout=10)
    assert not b.alive


def test_dead_replica_is_routed_around(pool, port_tts, ref_wav):
    _kill(pool, 0, ref_wav)
    with pytest.raises(RuntimeError, match="dead|closed"):
        pool.batchers[0].submit("x", "English", ref_wav, "ref")
    spf = port_tts.vocoder.spf
    before = pool.batchers[1]._stats["served"]
    handles = [pool.submit(f"Failover {i}.", "English", ref_wav, "ref") for i in range(3)]
    for h in handles:
        assert len(_collect(h)) == MAX_NEW * spf
    assert pool.batchers[1]._stats["served"] == before + 3
    assert [r["alive"] for r in pool.stats["replicas"]] == [False, True]


def test_all_replicas_dead_raises(pool, ref_wav):
    _kill(pool, 1, ref_wav)
    with pytest.raises(RuntimeError, match="all 2 replicas are dead"):
        pool.submit("No survivors.", "English", ref_wav, "ref")
