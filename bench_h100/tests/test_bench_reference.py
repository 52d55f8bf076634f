"""The plain reference against the port on the tiny preset (float32, CPU),
and whole runs of the three drivers at a tiny size: correct as served,
not correct with the timed path broken underneath or on the control."""
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import harness
from reference import logits_processed
from reference.qwen3tts import Reference

BASE = {"text_tokens_per_frame": 0.3333, "language": "English", "check": {"requests": 3},
        "schedule_seed": 1,
        "voices": {"count": 3, "zipf_s": 1.1, "min_s": 1, "max_s": 2, "sample_rate": 16000}}
MIXES = {
    "serve": dict(BASE, driver="serve", greedy_share=0, warm_s=1,
                  batcher={"max_batch": 2, "chunk_size": 4, "first_chunks": [2],
                           "prefill_buckets": [32], "max_tth": 16},
                  arrivals={"kind": "poisson", "rate_per_s": 3.0},
                  frames={"kind": "lognormal", "median": 8, "sigma": 0.5, "min": 4, "max": 12}),
    "stream": dict(BASE, driver="stream", chunk_size=4, greedy_share=0.5,
                   arrivals={"kind": "closed"},
                   frames={"kind": "lognormal", "median": 8, "sigma": 0.5, "min": 4, "max": 12,
                           "cycle": 4}),
    "batch": dict(BASE, driver="batch", batch=2, greedy_share=0.5, arrivals={"kind": "closed"},
                  frames={"kind": "uniform", "min": 4, "max": 12, "cycle": 2}),
}
# float32 on the CPU: the port and the reference agree to rounding; the
# codec computes in bfloat16 (the API's default), hence the audio's room
LIMITS = {"talker_greedy_gap_mean": 1e-5, "sampled_topk_gap_mean": 1e-5, "audio_rel_err": 0.05,
          "unfinished": 0}
SEED = 2**31 + 17


def tiny_cfg():
    from qwen3tts_tpu_torch.core.presets import get_preset

    cfg = get_preset("tiny").to_hf_dict()
    cfg["bench"] = {"max_seq_len": 256, "counts": "qwen3tts", "reference": "qwen3tts",
                    "path": {}}
    return cfg


# every reader in metrics/, run on each tiny cell's window: those that find
# nothing to read there (no trace on the CPU) return None
READERS = sorted(p.stem for p in (Path(harness.__file__).parent / "metrics").glob("*.py"))


def tiny_run(kind, control=None, fp8_audio=False, limits=None, cfg=None):
    """One tiny cell's run.  A closed loop serves the first cycle of its plan
    (both sampling policies in it) whatever the CPU's speed: its window
    outlasts the cycle, which ends the loop.  The limits are ``LIMITS``, less
    the greedy gap where the mix has no greedy request; the configuration
    is ``tiny_cfg()`` unless given."""
    mix = MIXES[kind]
    if limits is None:
        limits = {k: v for k, v in LIMITS.items()
                  if mix["greedy_share"] or k != "talker_greedy_gap_mean"}
    bench = {"end_to_end": [{"name": n, "unit": "x"} for n in READERS], "per_layer": []}
    closed = mix["arrivals"]["kind"] == "closed"
    orig = harness.plan
    if closed:
        harness.plan = lambda m, seed, s: orig(m, seed, s)[: m["frames"]["cycle"]]
    try:
        return harness.run(bench, None, "tiny-" + kind, SEED, 600.0 if closed else 3.0, False,
                           time.perf_counter(), device="cpu", control=control,
                           fp8_audio=fp8_audio, cell_parts=(cfg or tiny_cfg(), mix, limits))
    finally:
        harness.plan = orig


def test_reference_matches_the_port_step_by_step():
    from qwen3tts_tpu_torch.api.model import FasterQwen3TTS
    from qwen3tts_tpu_torch.core.config import TTSModelConfig
    from qwen3tts_tpu_torch.runtime import loops
    from weights import make_weights

    cfg = tiny_cfg()
    cobj = TTSModelConfig.from_dict(cfg)
    params = make_weights(cobj, SEED, "cpu")
    model = FasterQwen3TTS(cobj, params)
    wav = (0.1 * np.random.default_rng(0).standard_normal(24000)).astype(np.float32)
    got = []
    orig = loops.fast_generate_streaming_audio

    def tap(*a, **k):
        for codes, audio, timing in orig(*a, **k):
            got.append(codes)
            yield codes, audio, timing

    loops.fast_generate_streaming_audio = tap
    try:
        audio = np.concatenate([a for a, _, _ in model.generate_voice_clone_streaming(
            "hello there", "English", (wav, 16000), "", max_new_tokens=18,
            min_new_tokens=18, do_sample=False, chunk_size=4)])
    finally:
        loops.fast_generate_streaming_audio = orig
    codes = torch.as_tensor(np.concatenate(got)).long()
    ref = Reference(params, cfg)
    xv = ref.xvector(wav)
    np.testing.assert_allclose(xv.numpy(), model.extract_speaker_embedding(wav, 16000),
                               atol=1e-6)
    prompt, pad = ref.prompt("hello there", xv)
    want, *_ = model._prepare_clone("hello there", (wav, 16000), "", "English", True, True,
                                    True, None)
    np.testing.assert_allclose(prompt.numpy(), want[0], atol=1e-5)
    logits, hidden = ref.talker(prompt, codes, pad)
    lp = logits_processed(logits, codes[:, 0], cobj.talker.vocab_size, 1.05)
    assert torch.equal(lp.argmax(-1), codes[:, 0])
    pl = ref.predictor(hidden, codes)
    assert (pl.gather(2, codes[:, 1:, None])[..., 0] >= pl.topk(50, -1).values[..., -1]).all()
    wave = ref.decode(codes)
    assert wave.shape[0] == audio.shape[0] == 18 * cobj.codec.total_upsample
    assert (torch.as_tensor(audio) - wave).norm() / wave.norm() < 0.05


@pytest.mark.parametrize("kind", sorted(MIXES))
def test_tiny_cell_is_correct(kind):
    out = tiny_run(kind)
    assert out["correct"], out["numbers"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert out["numbers"]["checked_requests"] >= 2
    m = out["metrics"]
    assert m["setup_s"]["value"] > 0 and m["step_mfu"]["value"] > 0
    assert m["ttfa_p50_ms"]["value"] > 0
    assert "device_idle_share" not in m  # no trace on the CPU: nothing to read


def test_a_limit_with_nothing_to_read_fails():
    """A cell with no greedy request cannot pass a greedy-gap limit."""
    out = tiny_run("serve")
    assert out["correct"] and "talker_greedy_gap_mean" not in out["numbers"]
    assert not harness.check_lib.verdict(out["numbers"], LIMITS)


def test_the_configured_path_reaches_the_engines():
    """``bench.path`` keys that are not the API's defaults build the model's
    engines with them; an unknown key raises."""
    from qwen3tts_tpu_torch.core.config import TTSModelConfig
    from qwen3tts_tpu_torch.ops.quant import is_quantized
    from weights import make_weights

    cfg = tiny_cfg()
    cfg["bench"]["path"] = {"flash_decode": False, "cuda_graphs": False, "quantize": "int8",
                            "kv_quant": True}
    cobj = TTSModelConfig.from_dict(cfg)
    params = make_weights(cobj, SEED, "cpu")
    model = harness.build_model(cfg, cobj, params, SEED, 2)
    for eng in (model.engine, model._batch_engine(2)):
        assert eng.use_flash_decode is False and eng.graphs is None and eng.kv_quant
        assert eng.batch in (1, 2) and is_quantized(eng.talker_params["blocks"]["qkv_proj"])
    assert model._batch_engine(2) is model._batch_engines[2]
    default = harness.build_model(tiny_cfg(), cobj, params, SEED, 2)
    assert default.engine.use_flash_decode and not default.kv_quant
    assert not is_quantized(default.engine.talker_params["blocks"]["qkv_proj"])
    cfg["bench"]["path"] = {"fused": True}
    with pytest.raises(ValueError, match="unknown bench.path keys"):
        harness.build_model(cfg, cobj, params, SEED, 1)


def test_pieces_found_by_name_or_refused():
    import drivers

    assert harness.reader_file("frames_per_s.b1").name == "frames_per_s.py"
    assert harness.reader_file("prefill_ms_p50.b1").name == "prefill_ms_p50.b1.py"
    with pytest.raises(ValueError, match="no reader"):
        harness.reader_file("no_such_metric.b1")
    with pytest.raises(ValueError, match="no driver"):
        drivers.load("http")
    with pytest.raises(ValueError, match="no counts"):
        harness.load_counts({"bench": {"counts": "other_model"}})
    for bench in ({"reference": "other_model"}, {}):
        with pytest.raises(ValueError, match="no reference"):
            harness.load_reference({"bench": bench})
    cfg = tiny_cfg()
    del cfg["bench"]["reference"]
    with pytest.raises(ValueError, match="no reference"):  # before any set-up
        harness.run(None, None, "tiny-batch", SEED, 1.0, False, time.perf_counter(),
                    device="cpu", cell_parts=(cfg, MIXES["batch"], LIMITS))


# a reference module of another talker, as a configuration would name it:
# the base's x-vector, prompt, predictor and codec, the talker's logits moved
# by one id
ALTERED = """
from reference.qwen3tts import Reference as Base


class Reference(Base):
    def talker(self, prompt, codes, tts_pad):
        logits, hidden = super().talker(prompt, codes, tts_pad)
        return logits.roll(1, -1), hidden
"""


@pytest.mark.parametrize("name,correct", [("qwen3tts", True), ("altered", False)])
def test_the_named_reference_judges(name, correct, tmp_path, monkeypatch):
    """The configuration's ``bench.reference`` picks the module that judges
    the cell, through the loader's folder: the plain reference passes the
    tiny batch cell, a subclass whose talker logits alone differ fails it."""
    shutil.copy(harness.REFERENCES / "qwen3tts.py", tmp_path / "qwen3tts.py")
    (tmp_path / "altered.py").write_text(ALTERED)
    monkeypatch.setattr(harness, "REFERENCES", tmp_path)
    cfg = tiny_cfg()
    cfg["bench"]["reference"] = name
    out = tiny_run("batch", cfg=cfg)
    assert out["correct"] is correct, out["numbers"]
    assert out["failed"] == 0


def _alter_talker_tokens(monkeypatch):
    from qwen3tts_tpu_torch.runtime import engine

    orig = engine.sample_logits

    def altered(*a, **k):
        tok = orig(*a, **k)
        return torch.where(tok < 2047, tok + 1, tok)

    monkeypatch.setattr(engine, "sample_logits", altered)


def _state_unchanged(monkeypatch):
    from qwen3tts_tpu_torch.runtime.engine import Engine

    orig = Engine._one_step

    def stuck(self, state, *a, **k):
        pos = state["pos"].clone()
        frame = orig(self, state, *a, **k)
        state["pos"].copy_(pos)
        return frame

    monkeypatch.setattr(Engine, "_one_step", stuck)


def _predictor_token_altered(monkeypatch):
    from qwen3tts_tpu_torch.models import predictor

    orig = predictor.sample_logits

    def altered(*a, **k):
        tok = orig(*a, **k)
        return (tok + 977) % 2048

    monkeypatch.setattr(predictor, "sample_logits", altered)


@pytest.mark.parametrize("fault", [_alter_talker_tokens, _state_unchanged,
                                   _predictor_token_altered],
                         ids=["talker token altered", "step state unchanged",
                              "predictor token altered"])
@pytest.mark.parametrize("kind", sorted(MIXES))
def test_broken_timed_path_is_not_correct(kind, fault, monkeypatch):
    fault(monkeypatch)
    out = tiny_run(kind)
    assert not out["correct"], out["numbers"]


def test_sampled_tokens_catch_an_altered_talker_token(monkeypatch):
    """b1-stream compares no greedy gap: its sampled codebook-0 tokens must
    catch a talker token altered where it is produced."""
    _alter_talker_tokens(monkeypatch)
    out = tiny_run("stream", limits={k: v for k, v in LIMITS.items()
                                     if k != "talker_greedy_gap_mean"})
    assert not out["correct"], out["numbers"]


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """The batch loop hands back only its first half of rows."""
    from qwen3tts_tpu_torch.runtime import loops

    orig = loops.fast_generate_batch

    def half(*a, **k):
        rows, timing = orig(*a, **k)
        keep = len(rows) // 2
        return rows[:keep] + [r[:0] for r in rows[keep:]], timing

    monkeypatch.setattr(loops, "fast_generate_batch", half)
    out = tiny_run("batch")
    assert not out["correct"] and out["failed"] > 0, out["numbers"]


@pytest.mark.parametrize("kind", sorted(MIXES))
def test_control_is_not_correct(kind):
    """The program on its own int8 path (weights and activations) in place of
    the configuration's precision fails the check; so does the codec in
    float8 in place of its bfloat16."""
    out = tiny_run(kind, control="w8a8", fp8_audio=True)
    assert not out["correct"], out["numbers"]
    assert out["numbers"]["audio_rel_err_fp8"] > LIMITS["audio_rel_err"]


def test_run_refuses_without_a_card(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    root = Path(harness.__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, str(root / "bench_h100" / "run.py"), "--workload",
                        "xvec17-b1-stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True, text=True,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}, timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()
    with pytest.raises(json.JSONDecodeError):
        json.loads(r.stdout or "x")
