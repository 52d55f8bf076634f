"""The w8a8 kernels on the card (``csrc/w8a8.cu``, ``ops/w8a8.py``).

- ``w8a8_gemv``, the fused kernel (the activation quantize inside the
  GEMV), against its plain version at tolerance 0 (every step exact or
  rounded once in the same order), 1 to 16 rows, bf16 and float32, at the
  0.6B's product shapes; two runs equal.
- The route above 16 rows (``quantize_act``'s kernel, ``torch._int_mm``,
  the epilogue), also exact.
- One captured graph replayed after its input was rewritten.
- The launch counters: one ``w8a8_gemv`` a call at 16 rows or fewer, one
  ``quantize_act`` above, none while a stream captures.
- A CUDA tensor that neither route takes raises ValueError (no plain
  version on the card).
- ``from_pretrained("random:tiny", quantize="w8a8")`` cannot run on the card
  (its flash-decode layout), so the API is driven in ``chip_smoke.py``;
  here a w8a8 talker decode step of the parity phase's small float32 model
  runs on the card with the kernels counted.

These need an NVIDIA card and nvcc, and skip elsewhere.  The card's machine
has no JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda_w8a8.py -q
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

SHAPES = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 2048)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _weight(K, N, seed):
    from qwen3tts_tpu_torch.ops.quant import quantize_tensor

    g = torch.Generator(device="cuda").manual_seed(seed)
    return quantize_tensor(torch.randn((K, N), generator=g, device="cuda") * K ** -0.5, "w8a8")


def _rows(M, K, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((M, K), generator=g, device="cuda") * 2).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("K,N", SHAPES)
def test_kernels_equal_plain(K, N, dtype):
    _need_card()
    from qwen3tts_tpu_torch.ops import w8a8 as W

    qw = _weight(K, N, K + N)
    for M in (1, 2, 3, 4, 5, 8, 9, 16):
        x = _rows(M, K, getattr(torch, dtype), M)
        if M > 1:
            x[1] = 0  # the 1e-8 floor
        y = W.w8a8_gemv(x, qw["q8"], qw["scale"], x.dtype)
        ref = W.w8a8_gemv_plain(x, qw["q8"], qw["scale"], x.dtype)
        assert y.dtype == x.dtype and torch.equal(y, ref), (K, N, M)
        assert torch.equal(W.w8a8_matmul(x, qw), ref)
        assert torch.equal(W.w8a8_gemv(x, qw["q8"], qw["scale"], x.dtype), y)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 64, 115])
def test_route_above_16_rows_equals_plain(M):
    _need_card()
    from qwen3tts_tpu_torch.ops import w8a8 as W

    for K, N in SHAPES[:2]:
        qw = _weight(K, N, 3)
        x = _rows(M, K, torch.bfloat16, M)
        pq, ps = W.quantize_act_plain(x)
        xq, xs = W.quantize_act(x)
        assert torch.equal(xq, pq) and torch.equal(xs, ps), (K, N, M)
        before = (W.quantize_act.launches, W.w8a8_gemv.launches)
        y = W.w8a8_matmul(x[None], qw)  # leading axes kept
        assert (W.quantize_act.launches - before[0], W.w8a8_gemv.launches - before[1]) == (1, 0)
        assert y.shape == (1, M, N)
        assert torch.equal(y[0], W.w8a8_matmul_plain(pq, ps, qw["q8"], qw["scale"],
                                                     torch.bfloat16))


@pytest.mark.cuda
def test_captured_graph_replays_rewritten_input():
    _need_card()
    from qwen3tts_tpu_torch.ops import w8a8 as W

    qw = _weight(1024, 4096, 5)
    x = _rows(4, 1024, torch.bfloat16, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        W.w8a8_matmul(x, qw)
    torch.cuda.current_stream().wait_stream(side)
    before = (W.quantize_act.launches, W.w8a8_gemv.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = W.w8a8_matmul(x, qw)
    assert (W.quantize_act.launches, W.w8a8_gemv.launches) == before  # capture launches nothing
    for seed in (2, 3):
        x.copy_(_rows(4, 1024, torch.bfloat16, seed) * seed)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, W.w8a8_gemv_plain(x, qw["q8"], qw["scale"], torch.bfloat16))


@pytest.mark.cuda
def test_launch_counters():
    _need_card()
    from qwen3tts_tpu_torch.ops import w8a8 as W

    qw = _weight(1024, 1024, 6)
    W.quantize_act.launches = W.w8a8_gemv.launches = 0
    for M in (1, 16, 17):
        W.w8a8_matmul(_rows(M, 1024, torch.float32, M), qw)
    assert (W.quantize_act.launches, W.w8a8_gemv.launches) == (1, 2)


@pytest.mark.cuda
def test_shapes_without_a_route_raise():
    _need_card()
    from qwen3tts_tpu_torch.ops import w8a8 as W

    odd = {"q8": torch.zeros((64, 30), dtype=torch.int8, device="cuda"),
           "scale": torch.ones((1, 30), device="cuda")}
    with pytest.raises(ValueError, match="no kernel instance"):  # N % 16 != 0, 1 row
        W.w8a8_matmul(torch.ones((1, 64), device="cuda"), odd)
    small_k = {"q8": torch.zeros((64, 32), dtype=torch.int8, device="cuda"),
               "scale": torch.ones((1, 32), device="cuda")}
    with pytest.raises(ValueError, match="no route on the card"):  # K < 128 above 16 rows
        W.w8a8_matmul(torch.ones((20, 64), device="cuda"), small_k)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        W.quantize_act(torch.ones((2, 64), device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        W.w8a8_gemv(torch.ones((2, 64), device="cuda", dtype=torch.float16), small_k["q8"],
                    small_k["scale"], torch.float16)
    with pytest.raises(ValueError, match="one device"):
        W.w8a8_gemv(torch.zeros((1, 64), device="cuda"), small_k["q8"].cpu(),
                    small_k["scale"].cpu(), torch.float32)


@pytest.mark.cuda
def test_w8a8_decode_step_on_card_matches_cpu():
    """The prefill (20 rows: torch._int_mm) and a decode step (one row: the
    GEMV) of a small float32 w8a8 talker (the parity phase's, hidden 128) on
    the card against the CPU.  Each product quantizes its activation row,
    so a float32 last-bit difference elsewhere can flip one int8 rounding,
    which moves an output by about one int8 step of its row (~1/127 of the
    row's largest value times a weight): held to 5e-2, which garbage from a
    wrong kernel exceeds (chip_smoke.py holds the chain exactly up to the
    first such flip)."""
    _need_card()
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import talker as talker_lib
    from qwen3tts_tpu_torch.ops import w8a8 as W
    from qwen3tts_tpu_torch.ops.quant import quantize_bundle

    base = get_preset("tiny")
    talker = dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20),
                                 hidden_size=128, text_hidden_size=128, speaker_embed_dim=128)
    cfg = dataclasses.replace(base, talker=talker)
    params = quantize_bundle(init_random(cfg, seed=6, dtype=torch.float32, device="cpu"),
                             "w8a8")["talker"]
    g = torch.Generator().manual_seed(0)
    embeds = torch.randn((1, 20, 128), generator=g) * 0.1
    x = torch.randn((1, 1, 128), generator=g) * 0.1

    def move(t, dev):
        return ({k: move(v, dev) for k, v in t.items()} if isinstance(t, dict)
                else [move(v, dev) for v in t] if isinstance(t, list) else t.to(dev))

    outs = {}
    for dev in ("cuda", "cpu"):
        p = move(params, dev)
        kv = talker_lib.new_kv_cache(cfg.talker, 1, 32, torch.float32, dev)
        pad = torch.zeros((1,), dtype=torch.int32, device=dev)
        before = (W.quantize_act.launches, W.w8a8_gemv.launches)
        _, logits, kv = talker_lib.prefill(p, cfg.talker, embeds.to(dev), pad, kv)
        h, _ = talker_lib.decode_step(p, cfg.talker, x.to(dev),
                                      torch.full((1,), 20, dtype=torch.int32, device=dev), pad,
                                      kv, use_flash=True)
        launched = (W.quantize_act.launches - before[0], W.w8a8_gemv.launches - before[1])
        outs[dev] = (logits.cpu(), h.cpu(), launched)
    L = cfg.talker.num_hidden_layers
    assert outs["cuda"][2] == (4 * L, 4 * L)  # prefill: 20 rows (torch._int_mm); step: GEMV
    assert (outs["cuda"][0] - outs["cpu"][0]).abs().max().item() < 5e-2
    assert (outs["cuda"][1] - outs["cpu"][1]).abs().max().item() < 5e-2
