"""The PyTorch port's checkpoints against the JAX package's, on the CPU.

- The port's safetensors reader and writer (``core/safetensors_io.py``,
  torch and json only) and the ``safetensors`` package read each other's
  files bit for bit.
- ``random:tiny`` in float32 and in bfloat16: a canonical checkpoint the
  JAX package wrote loads in the port as ``bundle_from_jax_numpy`` of the
  JAX parameters, and the port's ``save_pretrained`` loads in JAX's
  ``load_checkpoint`` as the original leaves; the same both ways for the
  upstream torch layout in three shards (``export_torch_checkpoint``).
  Every leaf bit-equal, atol 0.
- ``expected_bundle_shapes`` and the config dicts equal JAX's for every
  preset; ``diagnose_torch_checkpoint``'s report (and the strict loader's
  error) equal JAX's on the mutilated directories of
  ``tests/test_torch_checkpoint.py``.
- Repairs: the sample-rate chain (``tests/test_sample_rate.py``'s cases
  through both packages), a checkpoint's ``tokenizer.json`` reaching the
  text tokenizer, and a traced generation (``QWEN3TTS_PROFILE_DIR``) that
  never replays a captured chunk.
- A greedy Engine-level generation of the loaded float32 model equals the
  JAX engine's from the same directory.
"""
import dataclasses
import json
import logging
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from safetensors import numpy as st_numpy  # noqa: E402
from safetensors import torch as st_torch  # noqa: E402

from qwen3tts_tpu.api.model import _infer_sample_rate as j_infer_sample_rate  # noqa: E402
from qwen3tts_tpu.core import loader as JL  # noqa: E402
from qwen3tts_tpu.core.config import TTSModelConfig as JConfig  # noqa: E402
from qwen3tts_tpu.core.presets import PRESETS  # noqa: E402
from qwen3tts_tpu.core.presets import get_preset as j_preset  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.api.model import _infer_sample_rate  # noqa: E402
from qwen3tts_tpu_torch.core import loader as PL  # noqa: E402
from qwen3tts_tpu_torch.core import safetensors_io  # noqa: E402
from qwen3tts_tpu_torch.core.config import TTSModelConfig  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy  # noqa: E402

DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def jax_dirs(tiny_tts, tmp_path_factory):
    """{dtype: (cfg, JAX host bundle, canonical dir, sharded torch dir)},
    written by the JAX package: float32 is ``random:tiny`` through
    ``save_pretrained``; bfloat16 is the same weights with the talker and
    predictor cast (codec and speaker float32, as ``init_random`` makes
    them), through ``save_checkpoint``."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    host = jax.tree.map(np.asarray, tiny_tts.params)
    out = {}
    for dt in DTYPES:
        cfg, bundle = tiny_tts.cfg, host
        if dt == "bfloat16":
            cfg = dataclasses.replace(cfg, dtype="bfloat16")
            bundle = dict(host, **{k: jax.tree.map(lambda a: np.asarray(jnp.asarray(
                a, jnp.bfloat16)), host[k]) for k in ("talker", "predictor")})
        canon, tdir = root / f"{dt}_canonical", root / f"{dt}_torch"
        if dt == "float32":
            tiny_tts.save_pretrained(canon)
        else:
            JL.save_checkpoint(canon, cfg, bundle)
        JL.export_torch_checkpoint(tdir, cfg, bundle, num_shards=3)
        out[dt] = (cfg, bundle, canon, tdir)
    return out


def _port_equal(got, want):
    fa, fb = PL.flatten(got), PL.flatten(want)
    assert set(fa) == set(fb), set(fa) ^ set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, (k, fa[k].dtype, fb[k].dtype)
        assert torch.equal(fa[k], fb[k]), k


def _jax_equal(got, want):
    fa, fb = JL.flatten(got), JL.flatten(want)
    assert set(fa) == set(fb), set(fa) ^ set(fb)
    for k in fa:
        a, b = np.asarray(fa[k]), np.asarray(fb[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def _bridge(cfg, bundle):
    return PL.bundle_from_jax_numpy(bundle, get_preset("tiny"), getattr(torch, cfg.dtype), "cpu")


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


def test_safetensors_io_reads_and_writes_as_the_package(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
        "f16": torch.randn((7,), generator=g).half(),
        "f32": torch.randn((2, 3, 4), generator=g),
        "view": torch.randn((4, 6), generator=g).T,  # non-contiguous: its own elements
        "i8": torch.tensor([-127, 0, 5], dtype=torch.int8),
        "i32": torch.tensor([1, -2], dtype=torch.int32),
        "i64": torch.tensor(9, dtype=torch.int64),
        "u8": torch.tensor([0, 255], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "empty": torch.zeros((0, 4)),
    }
    mine, theirs = tmp_path / "port.safetensors", tmp_path / "package.safetensors"
    safetensors_io.save_file(tensors, mine)
    st_torch.save_file({k: v.contiguous() for k, v in tensors.items()}, str(theirs))
    for path in (mine, theirs):
        ours, pkg = safetensors_io.load_file(path), st_torch.load_file(str(path))
        assert list(ours) == list(pkg)  # the same order: JAX iterates it
        for k, want in tensors.items():
            assert ours[k].dtype == want.dtype and torch.equal(ours[k], want), (path, k)
            assert pkg[k].dtype == want.dtype and torch.equal(pkg[k], want), (path, k)
    # and the numpy flavour the JAX package writes (bf16 through ml_dtypes)
    arrays = {"a": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)),
              "b": np.arange(4, dtype=np.float32)}
    st_numpy.save_file(arrays, str(tmp_path / "np.safetensors"))
    ours = safetensors_io.load_file(tmp_path / "np.safetensors")
    assert torch.equal(ours["a"], torch.arange(6, dtype=torch.bfloat16).reshape(2, 3))
    assert torch.equal(ours["b"], torch.arange(4, dtype=torch.float32))


# ---------------------------------------------------------------------------
# both layouts, both ways, float32 and bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
def test_jax_canonical_checkpoint_loads_in_port(jax_dirs, dt):
    cfg, bundle, canon, _ = jax_dirs[dt]
    m = FasterQwen3TTS.from_pretrained(str(canon), device="cpu")
    assert m.cfg == TTSModelConfig.from_dict(cfg.to_hf_dict()) and m.cfg.dtype == dt
    _port_equal(m.params, _bridge(cfg, bundle))


@pytest.mark.parametrize("dt", DTYPES)
def test_port_save_pretrained_loads_in_jax(jax_dirs, dt, tmp_path):
    cfg, bundle, canon, _ = jax_dirs[dt]
    m = FasterQwen3TTS.from_pretrained(str(canon), device="cpu")
    m.save_pretrained(tmp_path / "port")
    jcfg, jbundle = JL.load_checkpoint(tmp_path / "port")
    assert jcfg == cfg
    _jax_equal(jax.tree.map(np.asarray, jbundle), bundle)


@pytest.mark.parametrize("dt", DTYPES)
def test_jax_torch_layout_loads_in_port(jax_dirs, dt):
    cfg, bundle, _, tdir = jax_dirs[dt]
    pcfg, params = PL.load_checkpoint(tdir, device="cpu")
    assert pcfg.to_dict() == cfg.to_dict()
    _port_equal(params, _bridge(cfg, bundle))


@pytest.mark.parametrize("dt", DTYPES)
def test_port_torch_layout_loads_in_jax(jax_dirs, dt, tmp_path):
    cfg, bundle, canon, _ = jax_dirs[dt]
    pcfg, params = PL.load_checkpoint(canon, device="cpu")
    d = tmp_path / "torch"
    PL.export_torch_checkpoint(d, pcfg, PL.bundle_to_jax_layout(params), num_shards=3)
    assert sorted(p.name for p in d.glob("model-*-of-*.safetensors")) == [
        f"model-0000{i}-of-00003.safetensors" for i in (1, 2, 3)]
    index = json.loads((d / "model.safetensors.index.json").read_text())["weight_map"]
    assert "talker.model.layers.0.self_attn.q_proj.weight" in index
    assert json.loads((d / "config.json").read_text()) == json.loads(
        json.dumps(cfg.to_hf_dict()))
    _, jbundle = JL.load_checkpoint(d)
    _jax_equal(jax.tree.map(np.asarray, jbundle), bundle)


def test_quantized_round_trip_keeps_int8_and_float32_scales(jax_dirs, tmp_path):
    """A quantized model saves its int8 ``q`` and float32 ``scale`` and loads
    them back bit for bit (the JAX loader would round ``scale`` to bf16)."""
    _, _, canon, _ = jax_dirs["bfloat16"]
    m = FasterQwen3TTS.from_pretrained(str(canon), device="cpu", quantize="int8")
    m.save_pretrained(tmp_path / "q")
    _, params = PL.load_checkpoint(tmp_path / "q", device="cpu")
    qkv = params["talker"]["blocks"]["qkv_proj"]
    assert qkv["q"].dtype == torch.int8 and qkv["scale"].dtype == torch.float32
    _port_equal(params, m.params)


# ---------------------------------------------------------------------------
# shapes, configs, reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_expected_bundle_shapes_equal_jax(preset):
    assert PL.expected_bundle_shapes(get_preset(preset)) == JL.expected_bundle_shapes(
        j_preset(preset))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_config_dicts_equal_jax(preset, tmp_path):
    jc, pc = j_preset(preset), get_preset(preset)
    assert pc.to_dict() == jc.to_dict()
    assert pc.to_hf_dict() == jc.to_hf_dict()
    hf = json.loads(json.dumps(jc.to_hf_dict()))
    assert TTSModelConfig.from_dict(hf).to_dict() == JConfig.from_dict(hf).to_dict()
    (tmp_path / "config.json").write_text(json.dumps(hf))
    assert TTSModelConfig.from_json(tmp_path / "config.json") == pc
    canon = json.loads(json.dumps(jc.to_dict()))
    assert PL._cfg_from_canonical(canon).to_dict() == JL._cfg_from_canonical(canon).to_dict()


def _mutilate(case, cfg, host):
    """The torch-layout tensors of one of tests/test_torch_checkpoint.py's
    broken or variant directories (numpy, the JAX package's export)."""
    if case == "missing_half":
        return JL.export_torch_layout({"talker": host["talker"],
                                       "predictor": host["predictor"]}, cfg)
    named = JL.export_torch_layout(host, cfg)
    if case == "strict_names":
        named["talker.bogus_unknown.weight"] = named.pop(
            "talker.model.layers.0.mlp.gate_proj.weight")
        del named["talker.model.layers.1.self_attn.q_proj.weight"]
    elif case == "aliases":
        variant = {}
        for k, v in named.items():
            if k == "talker.codec_head.weight":
                k = "talker.lm_head.weight"
            elif k.startswith("speech_tokenizer."):
                k = "speech_tokenizer.model." + k[len("speech_tokenizer."):]
            elif k.startswith("speaker_encoder."):
                k = "spk_encoder." + k[len("speaker_encoder."):]
            else:
                k = "model." + k
            variant[k] = v
        named = variant
    elif case == "junk_aux":
        named["speech_tokenizer.quantizer.codebook_ema.weight"] = np.zeros((4, 4), np.float32)
    elif case == "nonweight":
        named["speaker_encoder.block1.bn.num_batches_tracked"] = np.zeros((), np.int64)
        named["talker.model.layers.0.self_attn.rotary_emb.inv_freq"] = np.zeros(
            (8,), np.float32)
    elif case == "collision":
        w = np.asarray(named.pop("talker.text_projection.weight"))
        named["model.talker.text_projection.weight"] = w
        named["talker.text_proj.weight"] = w + 1.0
    elif case == "wrong_shape":
        named["talker.model.norm.weight"] = np.zeros((3,), np.float32)
    return named


@pytest.mark.parametrize("case", ["complete", "missing_half", "strict_names", "aliases",
                                  "junk_aux", "nonweight", "collision", "wrong_shape"])
def test_diagnose_report_and_strict_load_equal_jax(jax_dirs, case, tmp_path):
    cfg, host, _, _ = jax_dirs["float32"]
    d = tmp_path / case
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    st_numpy.save_file({k: np.ascontiguousarray(v)
                        for k, v in _mutilate(case, cfg, host).items()},
                       str(d / "model.safetensors"))
    jrep, prep = JL.diagnose_torch_checkpoint(d), PL.diagnose_torch_checkpoint(d)
    assert prep.summary() == jrep.summary()
    assert prep.summary(limit=2) == jrep.summary(limit=2)
    assert prep.ok == jrep.ok == (case in ("complete", "aliases", "nonweight"))
    try:
        _, jbundle = JL.load_checkpoint(d)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            PL.load_checkpoint(d, device="cpu")
        assert str(ei.value) == str(e)
        return
    _, params = PL.load_checkpoint(d, device="cpu")
    _port_equal(params, PL.bundle_from_jax_numpy(jax.tree.map(np.asarray, jbundle),
                                                 get_preset("tiny"), torch.float32, "cpu"))


# ---------------------------------------------------------------------------
# repairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec_sr,model_sr,want", [(22_050, 48_000, 22_050),
                                                    (None, 48_000, 48_000),
                                                    (None, None, 24_000),
                                                    ("preset", "preset", 24_000)])
def test_sample_rate_chain_equals_jax(codec_sr, model_sr, want, caplog):
    if codec_sr == "preset":
        codec, model = get_preset("tiny").codec, get_preset("tiny")
        jcodec, jmodel = j_preset("tiny").codec, j_preset("tiny")
    else:
        codec = jcodec = types.SimpleNamespace(sample_rate=codec_sr)
        model = jmodel = types.SimpleNamespace(sample_rate=model_sr)
    with caplog.at_level(logging.WARNING):
        got = _infer_sample_rate(codec, model)
    assert got == j_infer_sample_rate(jcodec, jmodel) == want
    assert ("defaulting to 24000" in caplog.text) == (model_sr is None)


def _write_tokenizer_json(path):
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {w: i for i, w in enumerate(
        ["<unk>", "<|im_start|>", "<|im_end|>", "\n", "assistant", "user", "ref",
         "hello", "world", "again"])}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path))


def test_from_pretrained_threads_tokenizer_json(jax_dirs, tmp_path, caplog):
    import shutil

    from qwen3tts_tpu import FasterQwen3TTS as JFasterQwen3TTS

    _, _, canon, _ = jax_dirs["float32"]
    with caplog.at_level(logging.WARNING):
        plain = FasterQwen3TTS.from_pretrained(str(canon), device="cpu")
    assert "no tokenizer.json" in caplog.text
    d = tmp_path / "with_tok"
    shutil.copytree(canon, d)
    _write_tokenizer_json(d / "tokenizer.json")
    m = FasterQwen3TTS.from_pretrained(str(d), device="cpu")
    jm = JFasterQwen3TTS.from_pretrained(str(d))
    for text in ("hello world", "hello again world"):
        got = m.tokenizer.build_assistant_ids(text)
        np.testing.assert_array_equal(got, jm.tokenizer.build_assistant_ids(text))
        assert not np.array_equal(got, plain.tokenizer.build_assistant_ids(text))
    assert m.tokenizer.vocab_size == 10


class _ReplayRefused:
    """A ``graphs`` stand-in: any replay raises."""

    def run(self, *a, **k):
        raise AssertionError("a captured chunk was replayed under the profiler")

    def has_graphs(self, kv):
        return False


def test_traced_generation_never_replays(jax_dirs, tmp_path, monkeypatch):
    """With QWEN3TTS_PROFILE_DIR set, the generation runs the engine's eager
    chunk and never ``ChunkGraphs.run``: it completes, writes its trace and
    gives the untraced eager run's tokens under the same seed."""
    from qwen3tts_tpu_torch.audio.wav import write_wav
    from qwen3tts_tpu_torch.runtime import loops

    _, _, canon, _ = jax_dirs["float32"]
    m = FasterQwen3TTS.from_pretrained(str(canon), device="cpu")
    ref = tmp_path / "ref.wav"
    write_wav(ref, (0.3 * np.sin(np.arange(24_000) / 7)).astype(np.float32), 24_000)
    ids = []
    real = loops.fast_generate

    def recorded(*a, **k):
        out = real(*a, **k)
        ids.append(out[0])
        return out

    monkeypatch.setattr(loops, "fast_generate", recorded)
    m.engine.warmed_up = True  # nothing to capture
    wavs = []
    for traced in (False, True):
        m._gen.manual_seed(5)
        m.engine.graphs = _ReplayRefused() if traced else None
        if traced:
            monkeypatch.setenv("QWEN3TTS_PROFILE_DIR", str(tmp_path / "prof"))
        wavs.append(m.generate_voice_clone("Hello there.", "English", str(ref), "",
                                           max_new_tokens=10, min_new_tokens=10)[0][0])
    assert len(list((tmp_path / "prof").glob("trace_*.json"))) == 1
    assert ids[0].shape == (10, 16)
    np.testing.assert_array_equal(ids[1], ids[0])
    np.testing.assert_array_equal(wavs[1], wavs[0])
    assert m.engine._eager_depth == 0


# ---------------------------------------------------------------------------
# the loaded model generates as JAX's
# ---------------------------------------------------------------------------


def test_loaded_model_greedy_engine_tokens_equal_jax(jax_dirs):
    from qwen3tts_tpu.models.predictor import SamplingPolicy as JSamplingPolicy
    from qwen3tts_tpu.runtime.engine import Engine as JEngine
    from qwen3tts_tpu.runtime.engine import GenerationPolicy as JGenerationPolicy

    _, _, canon, _ = jax_dirs["float32"]
    jcfg, jb = JL.load_checkpoint(canon)
    cfg, params = PL.load_checkpoint(canon, device="cpu")
    rng = np.random.default_rng(1)
    H = cfg.talker.hidden_size
    embeds = rng.standard_normal((1, 12, H)).astype(np.float32) * 0.1
    tth = rng.standard_normal((1, 5, H)).astype(np.float32) * 0.1
    tpe = rng.standard_normal((1, 1, H)).astype(np.float32) * 0.1

    jeng = JEngine(jb["talker"], jb["predictor"], jcfg, max_seq_len=64)
    jpol, jppol = JGenerationPolicy(do_sample=False), JSamplingPolicy(do_sample=False)
    jstate = jeng.prefill(embeds, jax.random.PRNGKey(0), jpol, jppol)
    want = [np.asarray(jstate["token"])]
    for _ in range(2):
        jstate, frames, n, lens, done = jeng.decode_chunk(
            jstate, jnp.asarray(tth), 5, jnp.asarray(tpe), jpol, jppol, 8)
        want.append(np.asarray(frames)[0, : int(np.asarray(lens)[0])])

    eng = Engine(params["talker"], params["predictor"], cfg, max_seq_len=64)
    state = eng.prefill(embeds, None, GenerationPolicy(do_sample=False),
                        SamplingPolicy(do_sample=False))
    got = [state["token"].numpy()]
    for _ in range(2):
        state, frames, n, lens, done = eng.decode_chunk(
            state, torch.from_numpy(tth), 5, torch.from_numpy(tpe), 8)
        got.append(frames[0, : int(lens[0])].numpy())
    assert sum(len(g) for g in got[1:]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
