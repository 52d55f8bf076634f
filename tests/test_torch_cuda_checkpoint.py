"""Checkpoints, the command line and the traced request on the card.

- The bf16 ``random:qwen3-tts-0.6b`` saved with ``save_pretrained`` and
  loaded with ``from_pretrained`` (no device: the card) gives every leaf
  equal to the source model's, on the card.
- ``qwen3tts-tpu-torch clone --model <that dir>`` on the card (no
  ``--device``) writes whole codec frames of finite audio.
- ``QWEN3TTS_PROFILE_DIR``: a traced request on a captured engine runs its
  chunks eagerly (no graph replay while the profiler is active) and writes
  its trace; the untraced captured requests after it give the greedy tokens
  of the eager engine.

These need an NVIDIA card and nvcc, and skip elsewhere.  The card's machine
has no JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda_checkpoint.py -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

NO_EOS = dict(do_sample=False, min_new_tokens=10_000)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.fixture()
def ref_wav(tmp_path):
    from qwen3tts_tpu_torch.audio.wav import write_wav

    t = np.linspace(0, 1.0, 24_000, dtype=np.float32)
    path = tmp_path / "ref.wav"
    write_wav(path, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 24_000)
    return str(path)


@pytest.fixture(scope="module")
def saved_06b(tmp_path_factory):
    """(source model, its canonical dir): the bf16 0.6B, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from qwen3tts_tpu_torch import FasterQwen3TTS

    m = FasterQwen3TTS.from_pretrained("random:qwen3-tts-0.6b", device="cuda",
                                       dtype="bfloat16")
    d = tmp_path_factory.mktemp("ckpt") / "canon"
    m.save_pretrained(d)
    return m, str(d)


@pytest.mark.cuda
def test_06b_save_load_leaves_equal_on_card(saved_06b):
    _need_card()
    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.core.loader import flatten

    src, d = saved_06b
    m = FasterQwen3TTS.from_pretrained(d)
    fa, fb = flatten(m.params), flatten(src.params)
    assert set(fa) == set(fb) and len(fa) == 365
    for k in fa:
        assert fa[k].device.type == "cuda" and fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k
    assert m.cfg == src.cfg and m.engine.graphs is not None


@pytest.mark.cuda
def test_cli_clone_on_card(saved_06b, ref_wav, tmp_path, capsys):
    _need_card()
    from qwen3tts_tpu_torch.apps import cli
    from qwen3tts_tpu_torch.audio.wav import read_wav

    out = tmp_path / "o.wav"
    cli.main(["clone", "--model", saved_06b[1], "--ref-audio", ref_wav, "--text",
              "Hello from the card.", "--max-new-tokens", "16", "-o", str(out)])
    audio, sr = read_wav(out)
    assert sr == 24_000 and len(audio) % 2000 == 0 and 0 < len(audio) <= 16 * 2000
    assert np.isfinite(audio).all()
    assert "RTF" in capsys.readouterr().out


def _model():
    """A small float32 model whose talker has a flash-decode instance on the
    card (head_dim 128)."""
    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset

    base = get_preset("tiny")
    cfg = dataclasses.replace(
        base, talker=dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20)))
    return FasterQwen3TTS(cfg, init_random(cfg, seed=8, dtype=torch.float32, device="cuda"),
                          max_seq_len=256)


@pytest.mark.cuda
def test_traced_request_then_captured_replays_give_eager_tokens(ref_wav, tmp_path,
                                                                 monkeypatch):
    _need_card()
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    m = _model()
    prompt = m._prepare_clone("Traced, then captured.", ref_wav, "", "English", True, True,
                              True, None)
    pol, ppol = GenerationPolicy(**NO_EOS), SamplingPolicy(do_sample=False)
    ids, real = [], loops.fast_generate

    def recorded(*a, **k):
        out = real(*a, **k)
        ids.append(out[0])
        return out

    monkeypatch.setattr(loops, "fast_generate", recorded)
    m._generate(*prompt, pol, ppol, 24)  # captures (warm-up and this key), replays
    graphs = m.engine.graphs
    runs, run = [0], graphs.run

    def counted(*a, **k):
        runs[0] += 1
        return run(*a, **k)

    monkeypatch.setattr(graphs, "run", counted)
    monkeypatch.setenv("QWEN3TTS_PROFILE_DIR", str(tmp_path / "prof"))
    m._generate(*prompt, pol, ppol, 24)
    assert runs[0] == 0 and len(list((tmp_path / "prof").glob("trace_*.json"))) == 1
    monkeypatch.delenv("QWEN3TTS_PROFILE_DIR")
    for _ in range(2):
        m._generate(*prompt, pol, ppol, 24)
    torch.cuda.synchronize()
    assert runs[0] > 0
    m.engine = Engine(m.params["talker"], m.params["predictor"], m.cfg, max_seq_len=256,
                      use_cuda_graphs=False)
    m._generate(*prompt, pol, ppol, 24)
    assert ids[-1].shape == (24, 16)
    for got in ids[:-1]:
        np.testing.assert_array_equal(got, ids[-1])
