"""Serving on the card: the continuous batcher's captured chunks.

- A chunk captured on the batcher's worker thread while another thread runs
  the speaker encoder on the card: the capture holds (thread-local), both
  threads' results are right, and the captured request gives the greedy
  audio of its replay.
- A row joined into a running batch, its trailing text written in place
  into the batch's tensor: the captured chunks read the new row (greedy
  tokens equal an eager engine's on the same sequence).
- A B 4 batcher's sampled audio replays the same under a seed.

These need an NVIDIA card and nvcc, and skip elsewhere.  The card's machine
has no JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda_serve.py -q
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

NO_EOS = dict(do_sample=False, min_new_tokens=10_000)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _model(seed: int = 8):
    """A small float32 model whose talker has a flash-decode instance on the
    card (head_dim 128), through the public API class."""
    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset

    base = get_preset("tiny")
    cfg = dataclasses.replace(
        base, talker=dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20)))
    return FasterQwen3TTS(cfg, init_random(cfg, seed=seed, dtype=torch.float32, device="cuda"),
                          max_seq_len=256)


@pytest.fixture()
def ref_wav(tmp_path):
    from qwen3tts_tpu_torch.audio.wav import write_wav

    t = np.linspace(0, 1.0, 24_000, dtype=np.float32)
    path = tmp_path / "ref.wav"
    write_wav(path, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 24_000)
    return str(path)


def _collect(handle):
    return np.concatenate([a for a, _, _ in handle.chunks()])


@pytest.mark.cuda
def test_capture_on_worker_survives_concurrent_speaker_encoder(ref_wav):
    _need_card()
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy
    from qwen3tts_tpu_torch.runtime.scheduler import ContinuousBatcher

    m = _model()
    rng = np.random.default_rng(0)
    clips = [rng.standard_normal(16_000).astype(np.float32) * 0.1 for _ in range(4)]
    alone = [m.extract_speaker_embedding(c, 16_000) for c in clips]
    b = ContinuousBatcher(m, max_batch=2, chunk_size=8, max_new_tokens=24,
                          policy=GenerationPolicy(**NO_EOS),
                          pred_policy=SamplingPolicy(do_sample=False))
    stop, errors, during = threading.Event(), [], []

    def encode():  # the HTTP threads' speaker encoder, on the card
        try:
            while not stop.is_set():
                during.append([m.extract_speaker_embedding(c, 16_000) for c in clips])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    try:
        m._voice_prompt(ref_wav, "", True, True)  # its own encoder call, before
        t = threading.Thread(target=encode)
        t.start()
        try:
            first = _collect(b.submit("Captured while encoding.", "English", ref_wav, ""))
            captures = b.engine.graphs.captures
        finally:
            stop.set()
            t.join(timeout=120)
        assert not t.is_alive() and not errors, errors
        assert captures >= 1 and during
        for embs in during:
            for got, want in zip(embs, alone):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        again = _collect(b.submit("Captured while encoding.", "English", ref_wav, ""))
        assert b.engine.graphs.captures == captures  # replayed only
        assert first.shape == (24 * m.vocoder.spf,) and np.isfinite(first).all()
        np.testing.assert_array_equal(first, again)
    finally:
        b.close()


@pytest.mark.cuda
def test_joined_row_trailing_text_reaches_captured_chunk():
    _need_card()
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m = _model()
        cfg, H = m.cfg, m.cfg.talker.hidden_size
        g = torch.Generator().manual_seed(4)
        batch = (torch.randn((2, 10, H), generator=g) * 0.1).numpy()
        join = (torch.randn((1, 7, H), generator=g) * 0.1).numpy()
        tth0 = torch.randn((2, 16, H), generator=g) * 0.1
        row = torch.randn((16, H), generator=g) * 0.1
        pol, ppol = GenerationPolicy(**NO_EOS), SamplingPolicy(do_sample=False)

        def run(graphs: bool):
            eng = Engine(m.params["talker"], m.params["predictor"], cfg, max_seq_len=128,
                         batch=2, use_cuda_graphs=graphs)
            tth = tth0.cuda()  # the batch's tensor, written in place below
            tpe = torch.zeros((2, 1, H), device="cuda")
            lens = torch.tensor([16, 16], device="cuda")
            state = eng.prefill(batch, None, pol, ppol)
            frames = []
            for i in range(5):
                _, f, n, _, _ = eng.decode_chunk(state, tth, lens, tpe, 8)
                eng.settle(state, int(n))
                frames.append(f.cpu().clone())
                if i == 2:  # pos 34: past the joining prompt's bucket (32)
                    eng.join_row(state, 1, join, policy=pol, pred_policy=ppol,
                                 pos_hint=state["pos_host"])
                    tth[1].copy_(row.cuda())
            return torch.cat(frames, dim=1), eng.graphs.replays if graphs else 0

        (captured, replays), (eager, _) = run(True), run(False)
        assert replays == 5
        assert torch.equal(captured, eager), (captured != eager).any(dim=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_b4_served_audio_replays_under_a_seed(ref_wav):
    _need_card()
    from qwen3tts_tpu_torch.runtime.scheduler import ContinuousBatcher

    m = _model()
    b = ContinuousBatcher(m, max_batch=4, chunk_size=8, max_new_tokens=32)
    texts = ["One.", "Two words.", "A third, longer text.", "And the fourth one here."]
    try:
        b.warmup(prefill_buckets=(32,), max_tth=16)
        m._voice_prompt(ref_wav, "", True, True)
        runs = []
        for _ in range(2):
            b.generator.manual_seed(7)
            with b.arriving():  # one burst: the batch starts with all four
                handles = [b.submit(t, "English", ref_wav, "") for t in texts]
            runs.append([_collect(h) for h in handles])
        assert b.stats["batches"] == 2 and b.stats["joined_mid_batch"] == 0
        for a, c in zip(*runs):
            assert len(a) > 0 and np.isfinite(a).all()
            np.testing.assert_array_equal(a, c)
    finally:
        b.close()
