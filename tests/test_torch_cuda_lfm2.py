"""The hybrid (LFM2) talker's kernels on the card: ``routed_experts`` (1, 4
and 16 rows; every row on the same 4 experts, rows spread over all 32; a
captured replay) against its plain version at LFM2-8B-A1B's widths, the
head_dim 64 / group 4 flash-decode instance against ``flash_decode_plain``,
and a small hybrid engine captured against eager.

These need an NVIDIA card and nvcc, and skip elsewhere.  No JAX:

    python -m pytest --noconftest tests/test_torch_cuda_lfm2.py -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3tts_tpu_torch.ops import flash_decode as fd  # noqa: E402
from qwen3tts_tpu_torch.ops import routed_experts as rx  # noqa: E402

# kernel vs plain, |out - ref| <= atol + rtol |ref|: both round the
# activation to bf16 before the down products and the output once; float32
# summation order flips an activation's rounding now and then (2 ulps)
TOL = (2e-3, 1.6e-2)
H, I, E, K = 2048, 1792, 32, 4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def _experts(seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape, scale):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    return (n(H, E, scale=H ** -0.5), n(E, H, 2 * I, scale=H ** -0.5),
            n(E, I, H, scale=I ** -0.5))


def _rows(case, B, router, seed=1):
    """(x, h, bias): ``same``: a bias that sends every row to experts 3, 7,
    11 and 29; ``spread``: row r's hidden picks experts 4r .. 4r + 3 (mod
    32) through the router, so 8 rows or more touch all 32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, H), generator=g, device="cuda").to(torch.bfloat16)
    h = torch.randn((B, H), generator=g, device="cuda") * 0.1
    bias = torch.zeros((E,), device="cuda")
    if case == "same":
        bias[[3, 7, 11, 29]] = 10.0
    else:
        for r in range(B):
            h[r, r] = 30.0
            for j in range(K):
                router[r, (4 * r + j) % E] = 1.0
    return x, h.to(torch.bfloat16), bias.to(torch.bfloat16)


def _close(got, want):
    atol, rtol = TOL
    err = (got.float() - want.float()).abs()
    assert (err <= atol + rtol * want.float().abs()).all(), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["same", "spread"])
@pytest.mark.parametrize("B", [1, 4, 16])
def test_routed_experts_matches_plain(case, B):
    _need_card()
    router, w13, w2 = _experts()
    x, h, bias = _rows(case, B, router)
    st_k = torch.zeros((E + 2,), dtype=torch.int64, device="cuda")
    st_p = torch.zeros_like(st_k)
    got = rx.routed_experts(x, h, router, bias, w13, w2, K, True, 1.0, st_k)
    want = rx.routed_experts_plain(x, h, router, bias, w13, w2, K, True, 1.0, st_p)
    _close(got, want)
    assert torch.equal(st_k, st_p), (st_k, st_p)
    touched = int(st_k[E])
    if case == "same":
        assert touched == 4
    else:
        assert touched == min(E, 4 * B)


@pytest.mark.cuda
def test_routed_experts_replays_captured():
    """One call captured, its inputs rewritten in place, replayed: the
    plain version on the new inputs, the counters summed over both."""
    _need_card()
    router, w13, w2 = _experts(2)
    x, h, bias = _rows("spread", 16, router, seed=3)
    stats = torch.zeros((E + 2,), dtype=torch.int64, device="cuda")
    rx.routed_experts(x, h, router, bias, w13, w2, K, True, 1.0, stats)  # workspaces
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        out = rx.routed_experts(x, h, router, bias, w13, w2, K, True, 1.0, stats)
    x2, h2, _ = _rows("same", 16, router.clone(), seed=4)
    x.copy_(x2)
    h.copy_(h2)
    graph.replay()
    torch.cuda.synchronize()
    ref_stats = torch.zeros_like(stats)
    want = rx.routed_experts_plain(x, h, router, bias, w13, w2, K, True, 1.0, ref_stats)
    _close(out, want)
    assert int(stats[E + 1]) == 2  # the eager call and the replay


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pos", [300, 2000])
@pytest.mark.parametrize("B", [1, 16])
def test_flash_d64g4_matches_plain(dtype, pos, B):
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(pos + B)
    L, S, KVH, NH, D = 6, 2048, 8, 32, 64
    q = torch.randn((B, NH, D), generator=g, device="cuda").to(dt)
    k = torch.randn((L, B, S, KVH, D), generator=g, device="cuda").to(dt)
    v = torch.randn((L, B, S, KVH, D), generator=g, device="cuda").to(dt)
    pad = torch.arange(B, dtype=torch.int32, device="cuda") * 7
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    for layer in (0, 5):
        got = fd.flash_decode(q, k, v, layer, p, pad)
        want = fd.flash_decode_plain(q, k, v, layer, p, pad)
        atol, rtol = (2e-3, 1.6e-2) if dtype == "bfloat16" else (1e-5, 0.0)
        err = (got.float() - want.float()).abs()
        assert (err <= atol + rtol * want.float().abs()).all(), err.max().item()


@pytest.mark.cuda
def test_small_hybrid_engine_captured_equals_eager():
    """A small bf16 hybrid talker (the kernels' shapes: head_dim 64 in
    groups of 4, hidden and expert widths multiples of 128) through the
    API: captured chunks give the eager chunks' greedy tokens."""
    _need_card()
    from qwen3tts_tpu_torch.api.model import FasterQwen3TTS
    from qwen3tts_tpu_torch.core.presets import get_preset

    base = get_preset("tiny-lfm2")
    tc = dataclasses.replace(base.talker, hidden_size=256, num_attention_heads=4,
                             num_key_value_heads=1, head_dim=64, mrope_section=(12, 10, 10),
                             intermediate_size=256, moe_intermediate_size=128,
                             text_hidden_size=256)
    cfg = dataclasses.replace(base, talker=tc, dtype="bfloat16")
    from qwen3tts_tpu_torch.core.loader import init_random

    params = init_random(cfg, seed=3, device="cuda")
    wav = (0.1 * np.random.default_rng(0).standard_normal(16000)).astype(np.float32)
    outs = []
    for graphs in (True, False):
        m = FasterQwen3TTS(cfg, params, max_seq_len=256, seed=1)
        if not graphs:
            m.engine.graphs = None
            m._batch_engine(3).graphs = None
        wavs, _ = m.generate_voice_clone_batch(["one", "two words", "three more words"],
                                               "English", (wav, 16000), "", max_new_tokens=24,
                                               min_new_tokens=24, do_sample=False)
        outs.append(np.stack(wavs))
        del m
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-3)
