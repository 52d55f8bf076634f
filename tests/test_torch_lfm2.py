"""The hybrid (LFM2) talker on the port's normal path, on the CPU: the tiny
hybrid preset (conv, conv, attention twice; one dense layer, then 8 routed
experts at top 2; head_dim 16) against the plain float32 reference
``models/lfm2_plain.py``, its caches (KV of the attention layers, the
convolution state per row), padding, joins, the API, the configuration and
what refuses it.  No JAX: the JAX package has no hybrid talker.
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen3tts_tpu_torch.api.model import FasterQwen3TTS
from qwen3tts_tpu_torch.core.config import TTSModelConfig
from qwen3tts_tpu_torch.core.loader import init_random
from qwen3tts_tpu_torch.core.presets import get_preset
from qwen3tts_tpu_torch.models import lfm2, lfm2_plain
from qwen3tts_tpu_torch.models import talker as talker_lib
from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
from qwen3tts_tpu_torch.ops import flash_decode as fd
from qwen3tts_tpu_torch.ops import routed_experts as re_ops
from qwen3tts_tpu_torch.ops.quant import is_quantized, quantize_bundle
from qwen3tts_tpu_torch.runtime import engine as engine_lib
from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy
from qwen3tts_tpu_torch.utils.timing import TRACE

ROOT = Path(__file__).resolve().parents[1]
# float32 on both sides: the port and the plain reference differ only in
# summation order (matmul blocking, the per-expert sums, the convolution's
# taps) and in the port's RMSNorm dividing through rsqrt the same way; over
# 6 layers that stays below 1e-5 of logits of order 1
ATOL = 1e-5


def _params(seed=0, bias_scale=0.3):
    """tiny-lfm2 float32 weights with norms, taps and expert bias away from
    their initial constants (so that none is right by accident)."""
    cfg = get_preset("tiny-lfm2")
    p = init_random(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    blocks = p["talker"]["blocks"]
    for group in blocks.values():
        for name, t in group.items():
            if "norm" in name:
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))
    blocks["moe"]["expert_bias"].copy_(bias_scale * torch.randn(
        blocks["moe"]["expert_bias"].shape, generator=g))
    return cfg, p


def _embeds(T, H, seed, B=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, T, H), generator=g) * 0.5


def _port_logits(params, cfg, prompt, steps):
    """Prefill ``prompt`` [1, T, H], then decode ``steps`` [1, n, H] a token
    at a time through the caches: logits [T_last + n, V] (the prompt's
    last position, then each step's)."""
    tc = cfg.talker
    T, n = prompt.shape[1], steps.shape[1]
    kv = talker_lib.new_kv_cache(tc, 1, T + n + 1, torch.float32, "cpu")
    pad = torch.zeros((1,), dtype=torch.int32)
    last, logits, kv = talker_lib.prefill(params, tc, prompt, pad, kv)
    out = [logits[0]]
    for i in range(n):
        pos = torch.tensor([T + i], dtype=torch.int32)
        h, kv = talker_lib.decode_step(params, tc, steps[:, i: i + 1], pos, pad, kv,
                                       use_flash=True)
        out.append(talker_lib.codec_head(params, h[:, 0])[0])
    return torch.stack(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_then_decode_equals_plain_forward(seed):
    cfg, p = _params(seed)
    H = cfg.talker.hidden_size
    prompt, steps = _embeds(9, H, seed + 10), _embeds(6, H, seed + 20)
    got = _port_logits(p["talker"], cfg, prompt, steps)
    full = lfm2_plain.logits(p["talker"], cfg.talker, torch.cat([prompt, steps], 1))[0]
    want = full[prompt.shape[1] - 1:]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def _batched_logits(params, cfg, prompts, steps, unmasked=False, monkeypatch=None):
    """The prompts left-padded into one batch, prefilled and decoded
    together: each row's logits [1 + n, V]."""
    tc, H = cfg.talker, cfg.talker.hidden_size
    B, T = len(prompts), max(e.shape[1] for e in prompts)
    batch = torch.zeros((B, T, H))
    pads = torch.tensor([T - e.shape[1] for e in prompts], dtype=torch.int32)
    for b, e in enumerate(prompts):
        batch[b, int(pads[b]):] = e[0]
    if unmasked:  # the convolutions shown no pads
        orig = lfm2._conv
        monkeypatch.setattr(lfm2, "_conv", lambda p, x, st, pc, eps, dec: orig(
            p, x, st, torch.zeros_like(pc), eps, dec))
    n = steps.shape[1]
    kv = talker_lib.new_kv_cache(tc, B, T + n + 1, torch.float32, "cpu")
    _, logits, kv = talker_lib.prefill(params, tc, batch, pads, kv)
    out = [logits]
    for i in range(n):
        pos = torch.tensor([T + i], dtype=torch.int32)
        h, kv = talker_lib.decode_step(params, tc, steps[:, i: i + 1], pos, pads, kv,
                                       use_flash=True)
        out.append(talker_lib.codec_head(params, h[:, 0]))
    return torch.stack(out, 1)


@pytest.mark.parametrize("masked", [True, False], ids=["pads masked", "pads unmasked"])
def test_left_padded_batch_equals_each_row_alone(masked, monkeypatch):
    """A batch of 3 prompts of 5, 9 and 7 tokens, left-padded: each row's
    logits equal its batch-1 run; with the convolutions' pad mask taken
    away (the attention layer gives pad positions a nonzero hidden, and the
    3-tap window reaches two positions back) they do not."""
    cfg, p = _params(3)
    H = cfg.talker.hidden_size
    prompts = [_embeds(T, H, 30 + T) for T in (5, 9, 7)]
    steps = _embeds(4, H, 40, B=3)
    got = _batched_logits(p["talker"], cfg, prompts, steps, unmasked=not masked,
                          monkeypatch=monkeypatch)
    worst = 0.0
    for b, e in enumerate(prompts):
        solo = _port_logits(p["talker"], cfg, e, steps[b: b + 1])
        worst = max(worst, (got[b] - solo).abs().max().item())
    if masked:
        assert worst <= ATOL, worst
    else:
        assert worst > 1e-3, worst


def test_expert_bias_chooses_but_does_not_weight():
    """The bias changes which experts a token takes and not their weights:
    the port's routed FFN equals the plain reference's, and a reference
    mutated to weight by ``s + bias`` differs."""
    cfg, p = _params(5, bias_scale=0.5)
    tc = cfg.talker
    moe = p["talker"]["blocks"]["moe"]
    h = _embeds(40, tc.hidden_size, 50)[0]
    x = torch.zeros_like(h)
    args = (moe["router"][0], moe["expert_bias"][0], moe["experts_gateup"][0],
            moe["experts_down"][0], tc.num_experts_per_tok)
    idx, g = re_ops.route(h, args[0], args[1], tc.num_experts_per_tok, True, 1.0)
    idx0, _ = re_ops.route(h, args[0], None, tc.num_experts_per_tok, True, 1.0)
    assert (idx != idx0).any(), "the bias chose no other expert"
    s = torch.sigmoid(h @ args[0])
    torch.testing.assert_close(g, s.gather(-1, idx) / (s.gather(-1, idx).sum(-1, keepdim=True)
                                                       + 1e-6))
    port = re_ops.routed_experts(x, h, *args, norm=True)
    plain = lfm2_plain.routed(h, *args, norm=True, scale=1.0)
    torch.testing.assert_close(port, plain, atol=ATOL, rtol=0)

    def mutated(h, router, bias, w13, w2, top_k):
        s = torch.sigmoid(h @ router) + bias
        idx = torch.topk(s, top_k, dim=-1).indices
        gm = s.gather(-1, idx)
        gm = gm / (gm.sum(-1, keepdim=True) + 1e-6)
        out = torch.zeros_like(h)
        I = w2.shape[1]
        for r in range(h.shape[0]):
            for k in range(top_k):
                gu = h[r] @ w13[idx[r, k]]
                out[r] += gm[r, k] * ((torch.nn.functional.silu(gu[:I]) * gu[I:]) @ w2[idx[r, k]])
        return out

    assert (port - mutated(h, *args)).abs().max().item() > 1e-3


def test_routing_counters_count_every_decode_call():
    cfg, p = _params(6)
    eng = Engine(p["talker"], p["predictor"], cfg, max_seq_len=64, batch=2)
    pol, ppol = GenerationPolicy(do_sample=False), SamplingPolicy(do_sample=False)
    H = cfg.talker.hidden_size
    state = eng.prefill(_embeds(6, H, 60, B=2), None, pol, ppol)
    tpe = torch.zeros((2, 1, H))
    for _ in range(3):
        state, _ = eng.decode_step(state, tpe, 0, tpe)
    c = eng.route_stats.counts
    moe_layers, E, k = lfm2.counts(cfg.talker)["moe"], cfg.talker.num_experts, \
        cfg.talker.num_experts_per_tok
    assert c.shape == (moe_layers, E + 2)
    assert (c[:, -1] == 3).all() and (c[:, :E].sum(1) == 3 * 2 * k).all()
    assert ((c[:, E] >= 3 * k) & (c[:, E] <= 3 * min(E, 2 * k))).all()
    read = eng.route_stats.read()
    assert read["calls"] == 3 * moe_layers
    counters = TRACE.summary()["counters"]
    assert k <= counters["moe.experts_touched"] <= 2 * k
    assert counters["moe.load_max_over_mean"] >= 1.0
    assert eng.route_stats in TRACE.route_stats()


def test_roll_out_leaves_the_conv_state():
    cfg, _ = _params(7)
    kv = talker_lib.new_kv_cache(cfg.talker, 2, 32, torch.float32, "cpu")
    g = torch.Generator().manual_seed(7)
    for t in kv.values():
        t.copy_(torch.randn(t.shape, generator=g))
    before = {k: t.clone() for k, t in kv.items()}
    talker_lib.roll_cache(kv, 3, 12)
    assert torch.equal(kv["conv"], before["conv"])
    assert torch.equal(kv["k"][:, :, :9], before["k"][:, :, 3:12])
    assert kv["conv"].shape == (4, 2, cfg.talker.hidden_size, 3)
    assert kv["k"].shape[0] == 2  # the attention layers only


def test_join_row_equals_its_solo_run():
    """A request joined into row 1 of a running batch of 2 gives the tokens
    of its batch-1 run (greedy talker and predictor, the eager chain on both
    sides), its convolution state copied whole into the row."""
    cfg, p = _params(8)
    H = cfg.talker.hidden_size
    pol = GenerationPolicy(do_sample=False, repetition_penalty=1.05, min_new_tokens=0)
    ppol = SamplingPolicy(do_sample=False)
    kw = dict(max_seq_len=128, use_micro_kernel=False)
    tpe = torch.zeros((1, 1, H))
    e_join = _embeds(7, H, 80)
    steps = 6
    solo = Engine(p["talker"], p["predictor"], cfg, **kw)
    st = solo.prefill(e_join, None, pol, ppol)
    want = []
    for _ in range(steps):
        st, frame = solo.decode_step(st, tpe, 0, tpe)
        want.append(frame[0].clone())
    eng = Engine(p["talker"], p["predictor"], cfg, batch=2, **kw)
    batch = _embeds(40, H, 81, B=2)
    state = eng.prefill(batch, None, pol, ppol)
    tpe2 = torch.zeros((2, 1, H))
    for _ in range(3):
        state, _ = eng.decode_step(state, tpe2, 0, tpe2)
    tiny = talker_lib.new_kv_cache(cfg.talker, 1, 32, torch.float32, "cpu")
    state = eng.join_row(state, 1, e_join, policy=pol, pred_policy=ppol)
    _, _, tiny = talker_lib.prefill(p["talker"], cfg.talker, torch.cat(
        [torch.zeros((1, 32 - 7, H)), e_join], 1), torch.tensor([25], dtype=torch.int32), tiny)
    torch.testing.assert_close(state["kv"]["conv"][:, 1], tiny["conv"][:, 0], atol=ATOL, rtol=0)
    got = []
    for _ in range(steps):
        state, frame = eng.decode_step(state, tpe2, 0, tpe2)
        got.append(frame[1].clone())
    assert torch.equal(torch.stack(got), torch.stack(want))


def test_api_batch_and_stream_run():
    m = FasterQwen3TTS.from_pretrained("random:tiny-lfm2", device="cpu")
    wav = (0.1 * np.random.default_rng(0).standard_normal(16000)).astype(np.float32)
    wavs, sr = m.generate_voice_clone_batch(["hello", "a longer text here", "x"], "English",
                                            (wav, 16000), "", max_new_tokens=8,
                                            min_new_tokens=8)
    spf = m.cfg.codec.total_upsample
    assert sr == 24000 and [w.shape for w in wavs] == [(8 * spf,)] * 3
    chunks = list(m.generate_voice_clone_streaming("hi", "English", (wav, 16000), "",
                                                   max_new_tokens=6, min_new_tokens=6,
                                                   chunk_size=4))
    assert sum(len(a) for a, _, _ in chunks) == 6 * spf


# LFM2-8B-A1B's config.json (LiquidAI/LFM2-8B-A1B): the numbers the preset takes
CATALOG = {"conv_L_cache": 3, "conv_bias": False, "hidden_size": 2048,
           "intermediate_size": 7168, "max_position_embeddings": 128000,
           "moe_intermediate_size": 1792, "norm_eps": 1e-05, "norm_topk_prob": True,
           "num_attention_heads": 32, "num_dense_layers": 2, "num_experts": 32,
           "num_experts_per_tok": 4, "num_hidden_layers": 24, "num_key_value_heads": 8,
           "rope_theta": 1000000, "routed_scaling_factor": 1, "use_expert_bias": True}
ATTENTION_LAYERS = (2, 6, 10, 14, 18, 21)


@pytest.mark.parametrize("preset", ["lfm2-8b-a1b-tts", "tiny-lfm2"])
def test_config_round_trips(preset, tmp_path):
    cfg = get_preset(preset)
    hf = json.loads(json.dumps(cfg.to_hf_dict()))
    assert TTSModelConfig.from_dict(hf) == cfg
    (tmp_path / "config.json").write_text(json.dumps(hf))
    assert TTSModelConfig.from_json(tmp_path / "config.json") == cfg
    assert hf["talker_config"]["num_experts"] == cfg.talker.num_experts > 0
    # a Qwen3 talker's dicts carry no hybrid key
    assert "num_experts" not in get_preset("qwen3-tts-1.7b").to_hf_dict()["talker_config"]
    assert "num_experts" not in get_preset("tiny").to_dict()["talker"]


def test_preset_has_the_published_sizes():
    tc = get_preset("lfm2-8b-a1b-tts").talker
    got = dataclasses.asdict(tc)
    got["norm_eps"] = got.pop("rms_norm_eps")
    for key, value in CATALOG.items():
        assert got[key] == value, key
    assert tc.layer_types == tuple("full_attention" if i in ATTENTION_LAYERS else "conv"
                                   for i in range(24))
    assert tc.head_dim * tc.num_attention_heads == tc.hidden_size == 2048
    assert sum(tc.mrope_section) == tc.head_dim // 2
    # the TTS side is the 1.7B's, and so is the predictor
    q17 = get_preset("qwen3-tts-1.7b")
    for key in ("vocab_size", "text_vocab_size", "text_hidden_size", "speaker_embed_dim",
                "codec_eos_token_id", "codec_bos_id", "codec_pad_id"):
        assert getattr(tc, key) == getattr(q17.talker, key), key
    assert get_preset("lfm2-8b-a1b-tts").predictor == q17.predictor
    n = lfm2.counts(tc)
    assert n == {"conv": 18, "attn": 6, "dense": 2, "moe": 22}


def test_parameter_shapes_and_count():
    """The published widths on the meta device: 7.75B expert parameters,
    about 8.5B in all."""
    tc = get_preset("lfm2-8b-a1b-tts").talker
    p = talker_lib.init_params(None, tc, torch.bfloat16, "meta")
    moe = p["blocks"]["moe"]
    assert tuple(moe["experts_gateup"].shape) == (22, 32, 2048, 2 * 1792)
    assert tuple(moe["experts_down"].shape) == (22, 32, 1792, 2048)
    assert tuple(moe["router"].shape) == (22, 2048, 32)
    assert tuple(p["blocks"]["conv"]["conv_w"].shape) == (18, 3, 2048)
    assert tuple(p["blocks"]["attn"]["qkv_proj"].shape) == (6, 2048, (32 + 16) * 64)
    experts = moe["experts_gateup"].numel() + moe["experts_down"].numel()
    assert experts == 22 * 32 * 3 * 2048 * 1792
    total = sum(t.numel() for t in torch.utils._pytree.tree_leaves(p))
    assert 8.3e9 < total < 8.6e9


def test_what_refuses_the_hybrid_talker():
    from qwen3tts_tpu_torch.parallel import sharding

    cfg, p = _params(9)
    for kw in ({"use_fused_kernels": True}, {"kv_quant": True}):
        with pytest.raises(ValueError, match="hybrid LFM2"):
            Engine(p["talker"], p["predictor"], cfg, max_seq_len=32, **kw)
    with pytest.raises(ValueError, match="hybrid LFM2"):
        talker_lib.new_kv_cache(cfg.talker, 1, 32, torch.float32, "cpu", kv_quant=True)
    kv = talker_lib.new_kv_cache(cfg.talker, 1, 32, torch.float32, "cpu")
    x = torch.zeros((1, 1, cfg.talker.hidden_size))
    pos, pad = torch.tensor([3], dtype=torch.int32), torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="hybrid LFM2"):
        talker_lib.decode_step(p["talker"], cfg.talker, x, pos, pad, kv, fused=True)
    with pytest.raises(ValueError, match="hybrid LFM2"):
        sharding.make_train_step(cfg.talker, device="cpu")
    with pytest.raises(ValueError, match="hybrid LFM2"):
        sharding.talker_param_specs(cfg.talker)


def test_w8a8_control_leaves_experts_router_and_taps():
    cfg, p = _params(10)
    q = quantize_bundle(p, "w8a8")["talker"]["blocks"]
    for group, name in (("conv", "in_proj"), ("conv", "out_proj"), ("attn", "qkv_proj"),
                        ("attn", "o_proj"), ("dense", "gateup_proj"), ("dense", "down_proj")):
        assert is_quantized(q[group][name]) and "q8" in q[group][name], (group, name)
    for name in ("experts_gateup", "experts_down", "router", "expert_bias"):
        assert torch.equal(q["moe"][name], p["talker"]["blocks"]["moe"][name])
    assert torch.equal(q["conv"]["conv_w"], p["talker"]["blocks"]["conv"]["conv_w"])
    m = FasterQwen3TTS(cfg, quantize_bundle(p, "w8a8"), max_seq_len=64)
    wav = (0.1 * np.random.default_rng(1).standard_normal(16000)).astype(np.float32)
    wavs, _ = m.generate_voice_clone_batch(["hi", "there"], "English", (wav, 16000), "",
                                           max_new_tokens=4, min_new_tokens=4)
    assert len(wavs) == 2


def test_flash_decode_has_the_hybrid_head_layout():
    assert fd.kernel_supports(64, 32, 8)  # LFM2: 32 heads over 8, head_dim 64
    assert not fd.kernel_supports(64, 32, 8, kv_int8=True)  # float cache only
    assert fd.kernel_supports(128, 16, 8) and fd.kernel_supports(128, 16, 8, kv_int8=True)


def _bench_reference():
    here = ROOT / "bench_h100"
    sys.path.insert(0, str(here))
    try:
        spec = importlib.util.spec_from_file_location("bench_reference_lfm2",
                                                      here / "reference" / "lfm2.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(here))
    return mod


def test_bench_reference_equals_plain():
    """The benchmark's copy of the reference (loaded by path: it imports
    nothing of the program) gives the plain reference's stack, its experts
    in blocks."""
    cfg, p = _params(11)
    mod = _bench_reference()
    ref = mod.Reference(p, json.loads(json.dumps(cfg.to_hf_dict())))
    x = _embeds(12, cfg.talker.hidden_size, 110)
    pos = torch.arange(12)
    got = ref.talker_stack(x, pos)
    want = lfm2_plain.talker_stack(p["talker"]["blocks"], cfg.talker, x, pos)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_prefill_experts_span_is_a_child_of_prefill():
    """The eager prefill's routed layers run under a host span ``experts``
    whose parent is the loops' ``prefill`` span; decode steps open none."""
    from qwen3tts_tpu_torch.runtime import loops

    cfg, p = _params(12)
    H = cfg.talker.hidden_size
    eng = Engine(p["talker"], p["predictor"], cfg, max_seq_len=64)
    was_on = TRACE.on
    TRACE.enable()
    try:
        t0 = __import__("time").perf_counter()
        loops.fast_generate(eng, _embeds(6, H, 120).numpy(), _embeds(2, H, 121).numpy(),
                            np.zeros((1, 1, H), np.float32), generator=None,
                            max_new_tokens=3, policy=GenerationPolicy(do_sample=False),
                            pred_policy=SamplingPolicy(do_sample=False), device_chunk=2)
        prefill = [s for s in TRACE.spans("prefill", t0) if s.start >= t0]
        experts = [s for s in TRACE.spans("experts", t0) if s.start >= t0]
    finally:
        if not was_on:
            TRACE.disable()
    assert len(prefill) == 1
    moe_layers = lfm2.counts(cfg.talker)["moe"]
    assert len(experts) == moe_layers  # one a routed layer of the prefill, none a step
    assert all(s.parent == prefill[0].id for s in experts)


def _bench_module(rel, name):
    here = ROOT / "bench_h100"
    sys.path.insert(0, str(here))
    try:
        spec = importlib.util.spec_from_file_location(name, here / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(here))
    return mod


def test_lfm2_counts_by_hand():
    """The benchmark's counts of the LFM2 configuration, worked by hand."""
    c = _bench_module("counts/lfm2.py", "bench_counts_lfm2")
    cfg = json.loads((ROOT / "bench_h100/configs/lfm2-8b-a1b-tts.json").read_text())
    Hh, V = 2048, 3072
    assert c.decode_attention_layers(cfg) == 6
    assert c.flash_decode_call(cfg, 16, 300) == (4.0 * 16 * 32 * 64 * 300,
                                                 2 * 16 * (2 * 300 * 8 * 64 + 2 * 32 * 64))
    talker = 18 * (Hh * 3 * Hh + Hh * Hh) + 6 * (Hh * 3072 + 2048 * Hh) + 2 * (
        Hh * 2 * 7168 + 7168 * Hh) + Hh * V
    pred = Hh * 1024 + 5 * (1024 * 2048 + 1024 * 1024 + 1024 * 6144 + 3072 * 1024)
    ops, nbytes = c.step_products(cfg, 1)
    assert ops == pytest.approx(2 * (talker + 16 * pred + 15 * 1024 * 2048))
    weights = talker + 15 * pred + 15 * 1024 * 2048
    assert 2 * weights < nbytes < 2 * weights * 1.01
    e_ops, e_bytes = c.expert_call(cfg, 16, 28.0)
    assert e_ops == 2.0 * 16 * Hh * 32 + 2.0 * 16 * 4 * 3 * Hh * 1792
    assert e_bytes == 2 * (Hh * 32 + 28.0 * 3 * Hh * 1792 + 3 * 16 * Hh)
    assert e_bytes == pytest.approx(616.6e6, rel=1e-3)  # a layer's touched experts at B 16
    f = c.frame_ops(cfg, 100)
    assert f > ops + 22 * 2 * 4 * 3 * Hh * 1792


def test_moe_roofline_reads_the_counted_experts():
    """``moe_roofline`` takes the touched experts from the newest routing
    counters of the profile's batch (the program's, not an expectation),
    and reads nothing without them."""
    from qwen3tts_tpu_torch.ops.routed_experts import RouteStats

    c = _bench_module("counts/lfm2.py", "bench_counts_lfm2")
    here = str(ROOT / "bench_h100")
    sys.path.insert(0, here)
    try:
        import devtrace
        reader = _bench_module("metrics/moe_roofline.py", "bench_moe_roofline").read
        cfg = json.loads((ROOT / "bench_h100/configs/lfm2-8b-a1b-tts.json").read_text())
        spent = 0.05
        ctx = {"counts": c, "cfg": cfg, "devtrace": devtrace,
               "profile": {"kernels": {"routed_experts_gateup_kernel": spent * 0.6,
                                       "routed_experts_down_kernel": spent * 0.4,
                                       "nvjet_gemm": 1.0}, "batch": 16, "steps": 4}}
        was_on = TRACE.on
        TRACE.enable()
        try:
            stats = RouteStats(22, 32, 16, "cpu")
            stats.counts[:, 32] = 20 * 10  # 20 experts touched a call, 10 calls a layer
            stats.counts[:, 33] = 10
            TRACE.add_routes(stats)
            got = reader(ctx)
            other = RouteStats(22, 32, 8, "cpu")  # another batch's engine: not read
            other.counts[:, 32], other.counts[:, 33] = 4, 1
            TRACE.add_routes(other)
            assert reader(ctx) == got
        finally:
            if not was_on:
                TRACE.disable()
        want = 100.0 * 4 * 22 * c.bound_s(*c.expert_call(cfg, 16, 20.0)) / spent
        assert got == pytest.approx(want)
        assert reader(dict(ctx, profile={**ctx["profile"], "kernels": {"x": 1.0}})) is None
    finally:
        sys.path.remove(here)
