"""The PyTorch port's voice-clone slice as a whole.

- The port's Engine with greedy talker and predictor, through prefill and
  three chunks of 8, gives exactly the JAX Engine's tokens on ``tiny``
  float32 (weights through ``bundle_from_jax_numpy``): with the default
  path, with ``use_fused_kernels=True``, and with an int8 bundle plus
  ``kv_quant=True`` plus the fused kernels.
- FasterQwen3TTS (``random:tiny``, CPU) returns steps x samples-per-frame
  audio, streaming and not, also with ``quantize="int8", kv_quant=True``
  and for an ICL clone.
- A subprocess that cannot import JAX, the JAX package, ``safetensors``,
  ``ml_dtypes`` or ``tokenizers`` imports qwen3tts_tpu_torch and runs tiny
  generations (x-vector and ICL clone, custom voice), imports long form and
  serving (the scheduler, the replica pool, the OpenAI-compatible server,
  timing, mp3), saves and loads a checkpoint, imports the CLI and the
  fixtures, and runs a predictor
  frame through the micro-step, the matvec probes' and the w8a8 kernels
  (plain versions), and imports the quality gate.
- With no card and no device given, the entry points raise instead of
  running on the CPU.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tier-1 run has several pytest-xdist workers on one
# host, each importing every test module, and a full-width torch thread pool
# in each of them oversubscribes the cores (tiny models gain nothing from it).
torch.set_num_threads(1)

import jax  # noqa: E402

from qwen3tts_tpu.models.predictor import SamplingPolicy as JSamplingPolicy  # noqa: E402
from qwen3tts_tpu.ops.quant import quantize_bundle as jquantize_bundle  # noqa: E402
from qwen3tts_tpu.runtime.engine import Engine as JEngine  # noqa: E402
from qwen3tts_tpu.runtime.engine import GenerationPolicy as JGenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy, bucket_for  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _greedy_tokens_both(tiny_cfg, tp, pp, **engine_kw):
    """Greedy tokens of the JAX and the port's Engine (same weights and
    options): prefill then three chunks of 8."""
    rng = np.random.default_rng(0)
    H = tiny_cfg.talker.hidden_size
    embeds = rng.standard_normal((1, 10, H)).astype(np.float32) * 0.1
    tth = rng.standard_normal((1, 5, H)).astype(np.float32) * 0.1
    tpe = rng.standard_normal((1, 1, H)).astype(np.float32) * 0.1

    jeng = JEngine(tp, pp, tiny_cfg, max_seq_len=64, **engine_kw)
    jpol, jppol = JGenerationPolicy(do_sample=False), JSamplingPolicy(do_sample=False)
    jstate = jeng.prefill(embeds, jax.random.PRNGKey(0), jpol, jppol)
    want = [np.asarray(jstate["token"])]
    for _ in range(3):
        jstate, frames, n, lens, done = jeng.decode_chunk(
            jstate, jax.numpy.asarray(tth), 5, jax.numpy.asarray(tpe), jpol, jppol, 8)
        want.append(np.asarray(frames)[0, : int(np.asarray(lens)[0])])

    cfg = get_preset("tiny")
    params = bundle_from_jax_numpy({"talker": jax.tree.map(np.asarray, tp),
                                    "predictor": jax.tree.map(np.asarray, pp)},
                                   cfg, torch.float32, "cpu")
    eng = Engine(params["talker"], params["predictor"], cfg, max_seq_len=64, **engine_kw)
    assert eng.use_flash_decode  # CPU: the flash wrapper's plain version
    state = eng.prefill(embeds, None, GenerationPolicy(do_sample=False),
                        SamplingPolicy(do_sample=False))
    got = [state["token"].numpy()]
    for _ in range(3):
        state, frames, n, lens, done = eng.decode_chunk(
            state, torch.from_numpy(tth), 5, torch.from_numpy(tpe), 8)
        got.append(frames[0, : int(lens[0])].numpy())
    assert sum(len(g) for g in got[1:]) > 0
    return eng, got, want


def test_greedy_engine_tokens_equal_jax(tiny_cfg, tiny_models):
    _, got, want = _greedy_tokens_both(tiny_cfg, *tiny_models)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("int8", [False, True])
def test_fused_engine_greedy_tokens_equal_jax(tiny_cfg, tiny_models, int8):
    """use_fused_kernels=True on both sides; with ``int8`` the bundle is
    quantized by the JAX package, carried across by bundle_from_jax_numpy,
    and both engines keep an int8 KV cache."""
    tp, pp = tiny_models
    if int8:
        qb = jquantize_bundle({"talker": tp, "predictor": pp}, "int8")
        tp, pp = qb["talker"], qb["predictor"]
    eng, got, want = _greedy_tokens_both(tiny_cfg, tp, pp, use_fused_kernels=True,
                                         kv_quant=int8)
    assert eng.use_fused_kernels and eng.kv_quant == int8
    assert (eng.new_kv()["k"].dtype == torch.int8) == int8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_prefill_rejects_over_long_prompt(tiny_cfg):
    with pytest.raises(ValueError, match="max bucket"):
        bucket_for(4096)
    cfg = get_preset("tiny")
    m = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        Engine(m.params["talker"], m.params["predictor"], cfg, max_seq_len=64).prefill(
            np.zeros((1, 70, cfg.talker.hidden_size), np.float32), None, GenerationPolicy())


@pytest.fixture(scope="module")
def tiny_port():
    return FasterQwen3TTS.from_pretrained("random:tiny", device="cpu")


@pytest.fixture()
def ref_wav_path(tmp_path):
    from qwen3tts_tpu_torch.audio.wav import write_wav

    t = np.linspace(0, 1.0, 24_000, dtype=np.float32)
    path = tmp_path / "ref.wav"
    write_wav(path, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 24_000)
    return str(path)


@pytest.mark.parametrize("steps,chunk", [(16, 8), (13, 4)])
def test_api_streaming_audio_length(tiny_port, ref_wav_path, steps, chunk):
    spf = tiny_port.vocoder.spf
    out = list(tiny_port.generate_voice_clone_streaming(
        "hello there", "English", ref_wav_path, "", max_new_tokens=steps,
        min_new_tokens=steps, chunk_size=chunk))
    assert len(out) == -(-steps // chunk)
    audio = np.concatenate([a for a, _, _ in out])
    assert audio.shape == (steps * spf,)
    assert np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
    assert out[-1][2]["is_final"] and out[-1][2]["total_steps_so_far"] == steps
    assert set(out[0][2]) == {"chunk_index", "chunk_steps", "prefill_ms", "decode_ms",
                              "total_steps_so_far", "is_final"}


def test_api_non_streaming_audio_length(tiny_port, ref_wav_path):
    wavs, sr = tiny_port.generate_voice_clone(
        "hello there", "English", ref_wav_path, "", max_new_tokens=12, min_new_tokens=12)
    assert sr == 24_000 and wavs[0].shape == (12 * tiny_port.vocoder.spf,)
    # ICL clone: the reference's frames are decoded with the output and cut off
    wavs, _ = tiny_port.generate_voice_clone("x", "English", ref_wav_path, "ref",
                                             xvec_only=False, max_new_tokens=12,
                                             min_new_tokens=12)
    assert wavs[0].shape == (12 * tiny_port.vocoder.spf,)


def test_api_int8_and_kv_quant_audio_length(ref_wav_path):
    m = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu", quantize="int8",
                                       kv_quant=True)
    assert m.kv_quant and m.engine.kv_quant and not m.engine.use_fused_kernels
    assert m.params["talker"]["blocks"]["qkv_proj"]["q"].dtype == torch.int8
    assert m.params["predictor"]["lm_heads"]["q"].dtype == torch.int8
    spf = m.vocoder.spf
    m.engine = Engine(m.params["talker"], m.params["predictor"], m.cfg,
                      max_seq_len=m.max_seq_len, use_fused_kernels=True, kv_quant=True)
    wavs, _ = m.generate_voice_clone("hello there", "English", ref_wav_path, "",
                                     max_new_tokens=12, min_new_tokens=12)
    assert wavs[0].shape == (12 * spf,) and np.isfinite(wavs[0]).all()
    out = list(m.generate_voice_clone_streaming(
        "hello there", "English", ref_wav_path, "", max_new_tokens=16, min_new_tokens=16,
        chunk_size=8))
    audio = np.concatenate([a for a, _, _ in out])
    assert len(out) == 2 and audio.shape == (16 * spf,)
    assert np.isfinite(audio).all() and np.abs(audio).max() <= 1.0


def test_api_quantize_modes():
    """The selective modes quantize one component (w8a8 as ``{"q8",
    "scale"}``, which raised NotImplementedError before the w8a8 modes were
    ported); unknown modes raise."""
    for mode in ("int8-talker", "int8-predictor", "w8a8-talker", "w8a8-predictor"):
        m = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu", quantize=mode)
        key = "q8" if mode.startswith("w8a8") else "q"
        talker_q, pred_q = (isinstance(w, dict) and key in w for w in (
            m.params["talker"]["blocks"]["o_proj"], m.params["predictor"]["blocks"]["o_proj"]))
        assert (talker_q, pred_q) == (mode.endswith("-talker"), mode.endswith("-predictor"))
    with pytest.raises(ValueError, match="unknown quantize mode"):
        FasterQwen3TTS.from_pretrained("random:tiny", device="cpu", quantize="int4")
    m = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu", quantize="w8a8")
    assert set(m.params["talker"]["blocks"]["qkv_proj"]) == {"q8", "scale"}
    assert set(m.params["predictor"]["lm_heads"]) == {"q", "scale"}


def test_chunk_vocode_pcm16_matches_f32(tiny_port):
    eng, voc = tiny_port.engine, tiny_port.vocoder
    H = tiny_port.cfg.talker.hidden_size
    rng = np.random.default_rng(6)
    embeds = rng.standard_normal((1, 8, H)).astype(np.float32) * 0.1
    tpe = torch.zeros((1, 1, H))
    outs = {}
    for pcm16 in (False, True):
        state = eng.prefill(embeds, None, GenerationPolicy(do_sample=False, min_new_tokens=99),
                            SamplingPolicy(do_sample=False))
        out = eng.chunk_vocode(voc, state, tpe, 1, tpe, 8, voc.stream_state(), pcm16=pcm16)
        outs[pcm16] = (out[1].numpy(), out[5].numpy())
    np.testing.assert_array_equal(outs[False][0], outs[True][0])
    assert outs[True][1].dtype == np.int16
    np.testing.assert_allclose(outs[True][1].astype(np.float32) / 32767.0,
                               np.clip(outs[False][1], -1, 1), atol=1.0 / 32767)


def test_package_runs_without_jax(tmp_path):
    script = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "qwen3tts_tpu", "safetensors",
                                          "ml_dtypes", "tokenizers"):
                    raise ImportError("blocked: " + name)

        # scipy probes sys.modules for jax, so block at import time rather
        # than by planting None in sys.modules
        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch

        torch.set_num_threads(1)  # the tier-1 run's workers share the host's cores
        from qwen3tts_tpu_torch import FasterQwen3TTS
        from qwen3tts_tpu_torch.audio.wav import write_wav

        write_wav(sys.argv[1], (0.2 * np.sin(np.arange(16000) / 9)).astype(np.float32), 16000)
        m = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu")
        wavs, sr = m.generate_voice_clone("hi", "English", sys.argv[1], "",
                                          max_new_tokens=4, min_new_tokens=4)
        assert wavs[0].shape == (4 * m.vocoder.spf,), wavs[0].shape
        wavs, sr = m.generate_voice_clone("hi", "English", sys.argv[1], "ref words",
                                          max_new_tokens=4, min_new_tokens=4,
                                          xvec_only=False)
        assert wavs[0].shape == (4 * m.vocoder.spf,), wavs[0].shape
        c = FasterQwen3TTS.from_pretrained("random:tiny-custom", device="cpu")
        wavs, sr = c.generate_custom_voice("hi", "aiden", "English", max_new_tokens=4,
                                           min_new_tokens=4)
        assert wavs[0].shape == (4 * c.vocoder.spf,), wavs[0].shape
        from qwen3tts_tpu_torch.api import longform
        assert longform.split_sentences("One. Two!") == ["One. Two!"]
        from qwen3tts_tpu_torch.apps import openai_server
        from qwen3tts_tpu_torch.audio import mp3
        from qwen3tts_tpu_torch.runtime import replicas, scheduler
        from qwen3tts_tpu_torch.utils import timing
        assert callable(m.replicate_to) and callable(openai_server.serve)
        assert scheduler.ContinuousBatcher and replicas.ReplicaPool and timing.TRACE
        assert isinstance(mp3.is_available(), bool)
        m.save_pretrained(sys.argv[1] + ".ckpt")  # the port's own safetensors code
        again = FasterQwen3TTS.from_pretrained(sys.argv[1] + ".ckpt", device="cpu")
        assert torch.equal(again.params["talker"]["codec_embedding"],
                           m.params["talker"]["codec_embedding"])
        from qwen3tts_tpu_torch.apps import cli
        from qwen3tts_tpu_torch.core import fixtures
        assert callable(cli.main) and fixtures.FIXTURE_VERSION == 1

        from qwen3tts_tpu_torch.models import predictor as P
        from qwen3tts_tpu_torch.ops import matvec as mv
        from qwen3tts_tpu_torch.ops import w8a8
        from qwen3tts_tpu_torch.utils import quality

        x8 = torch.randn((3, 64))
        y8 = w8a8.w8a8_matmul(x8, {"q8": torch.ones((64, 32), dtype=torch.int8),
                                   "scale": torch.ones((1, 32))})
        assert y8.shape == (3, 32) and w8a8.quantize_act(x8)[0].dtype == torch.int8
        assert quality.waveform_snr_db(np.ones(8), np.ones(8)) == 99.0

        pin = torch.randn((1, 2, m.cfg.talker.hidden_size))
        toks, emb = P.predict_frame(m.params["predictor"], m.cfg.predictor, pin, None,
                                    P.SamplingPolicy(do_sample=False), micro_kernel=True)
        assert toks.shape == (1, 15) and torch.isfinite(emb).all()
        x, w = torch.randn((1, 64)), torch.randn((64, 32))
        assert mv.matvec(x, w).shape == (1, 32)
        assert mv.matvec_kt(x, w.t().contiguous()).shape == (32, 1)
        from qwen3tts_tpu_torch.apps import demo_server
        from qwen3tts_tpu_torch.models import asr
        rec = asr.CTCRecognizer.from_pretrained(asr.default_checkpoint(), device="cpu")
        assert rec.cfg.channels == 96  # the committed checkpoint, not random weights
        assert isinstance(rec.transcribe(np.zeros(16000, np.float32), 16000), str)
        assert callable(demo_server.serve) and callable(demo_server.resolve_asr)
        assert not any(k.split(".")[0] in ("jax", "qwen3tts_tpu") for k in sys.modules)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path / "r.wav")],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr


@pytest.mark.parametrize("entry", ["from_pretrained", "load_pretrained", "init_random",
                                   "bundle_from_jax_numpy", "CTCRecognizer",
                                   "asr_params_from_jax_numpy", "DemoState", "serve",
                                   "resolve_asr", "make_mesh", "launch"])
def test_entry_points_never_fall_back_to_cpu(monkeypatch, tiny_models, entry):
    """With no card, an entry point given no device raises and names
    device="cpu"; it never builds on the CPU by itself."""
    from qwen3tts_tpu_torch.apps import demo_server
    from qwen3tts_tpu_torch.core import loader
    from qwen3tts_tpu_torch.models import asr
    from qwen3tts_tpu_torch.parallel import sharding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_preset("tiny")
    calls = {
        "from_pretrained": lambda: FasterQwen3TTS.from_pretrained("random:tiny"),
        "load_pretrained": lambda: loader.load_pretrained("random:tiny"),
        "init_random": lambda: loader.init_random(cfg),
        "bundle_from_jax_numpy": lambda: loader.bundle_from_jax_numpy(
            {"predictor": jax.tree.map(np.asarray, tiny_models[1])}, cfg),
        "CTCRecognizer": lambda: asr.CTCRecognizer.from_pretrained(asr.default_checkpoint()),
        "asr_params_from_jax_numpy": lambda: asr.asr_params_from_jax_numpy(
            {"down1": {"w": np.zeros((3, 2, 2)), "b": np.zeros(2)}}),
        "DemoState": lambda: demo_server.DemoState(["random:tiny"]),
        "serve": lambda: demo_server.serve(["random:tiny"], host="127.0.0.1", port=0),
        "resolve_asr": lambda: demo_server.resolve_asr("builtin:random:ctc-tiny"),
        "make_mesh": lambda: sharding.make_mesh(),
        "launch": lambda: sharding.launch(sharding.sharded_inference_check, 1),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
