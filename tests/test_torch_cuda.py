"""PyTorch port on the card: the CUDA kernels (flash-decode with a float
and an int8 cache, fused_norm_matmul, fused_o_mlp, fused_micro_step, matvec,
matvec_kt) against their plain versions, the wrappers' refusals, and the
talker decode and the predictor frame through the kernels against the CPU.

These need an NVIDIA card and nvcc, and skip elsewhere.  The card's machine
has no JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3tts_tpu_torch.ops import flash_decode as fd  # noqa: E402
from qwen3tts_tpu_torch.ops import fused_block as fb  # noqa: E402
from qwen3tts_tpu_torch.ops import matvec as mv  # noqa: E402
from qwen3tts_tpu_torch.ops import predictor_step as ps  # noqa: E402
from qwen3tts_tpu_torch.ops.quant import quantize_tensor  # noqa: E402

# kernel vs plain, elementwise |out - ref| <= atol + rtol * |ref|
TOL = {"bfloat16": (2e-3, 1.6e-2),  # kernel and plain each round to bf16: 2 ulps of |ref|
       "float32": (1e-5, 0.0)}  # summation order only
# the bf16 micro-step: each phase rounds its activations to bf16, and the
# roundings that float32 summation order flips carry through the layers, so
# the plain version against itself in another summation order already misses
# TOL (tests/test_torch_predictor_step.py, chip_smoke.py): twice the largest
# spread measured, 1.95e-2
MICRO_BF16_TOL = (4e-2, 1.6e-2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    ("bfloat16", 2e-3, 1.6e-2),  # kernel and plain each round to bf16: 2 ulps of |ref|
    ("float32", 1e-5, 0.0),  # summation order only
])
def test_kernel_matches_plain(dtype, atol, rtol):
    """Kernel vs plain at the 0.6B talker's shapes (D 128, 16/8 heads)."""
    _need_card()
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    L, S = 4, 2048

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dt)

    q, k, v = t(1, 16, 128), t(L, 1, S, 8, 128), t(L, 1, S, 8, 128)
    for layer, pos, pad, window in [(0, 0, 0, None), (1, 255, 3, None),
                                    (3, 2047, 0, None), (2, 900, 0, 128),
                                    (1, 10, 20, None)]:
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        pd = torch.tensor([pad], dtype=torch.int32, device=dev)
        before = fd.flash_decode.launches
        out = fd.flash_decode(q, k, v, layer, p, pd, window)
        assert fd.flash_decode.launches == before + 1
        ref = fd.flash_decode_plain(q, k, v, layer, p, pd, window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
        if pad > pos:
            assert torch.all(out == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8kv_kernel_matches_plain(dtype):
    """The int8-cache kernel vs plain at the 0.6B talker's head layout."""
    _need_card()
    atol, rtol = TOL[dtype]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    L, S = 4, 2048
    q = torch.randn((1, 16, 128), generator=g, device=dev).to(getattr(torch, dtype))
    k, v = (torch.randint(-127, 128, (L, 1, S, 8, 128), generator=g, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((L, 1, 8, S), generator=g, device=dev) * 0.02 for _ in range(2))
    for layer, pos, pad, window in [(0, 0, 0, None), (1, 255, 3, None),
                                    (3, 2047, 0, None), (2, 900, 0, 128),
                                    (1, 10, 20, None)]:
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        pd = torch.tensor([pad], dtype=torch.int32, device=dev)
        before = (fd.flash_decode.launches, fd.flash_decode.launches_int8kv)
        out = fd.flash_decode(q, k, v, layer, p, pd, window, ks, vs)
        assert (fd.flash_decode.launches, fd.flash_decode.launches_int8kv) == (
            before[0], before[1] + 1)
        ref = fd.flash_decode_plain(q, k, v, layer, p, pd, window, ks, vs)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
        if pad > pos:
            assert torch.all(out == 0)


def _flash_inputs(dtype, int8, B, L=2, S=2048, seed=3):
    """q [B, 16, 128] and a cache of the talker's head layout: float in q's
    dtype, or int8 with float32 scales [L, B, KVH, S]."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, 16, 128), generator=g, device=dev).to(dt)
    if not int8:
        k, v = (torch.randn((L, B, S, 8, 128), generator=g, device=dev).to(dt)
                for _ in range(2))
        return q, k, v, ()
    k, v = (torch.randint(-127, 128, (L, B, S, 8, 128), generator=g, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((L, B, 8, S), generator=g, device=dev) * 0.02 for _ in range(2))
    return q, k, v, (ks, vs)


def _split_cases(S, splits):
    """(pos, pads, window): live lengths below, at and just above the split
    count and the 32-slot least split, at whole splits of 32 and one slot
    past them, one slot past whole splits of 8, pos = S - 1, pad > pos (row
    0) beside a live row, a window, a pad inside the range."""
    least = fd.MIN_CHUNK
    cases = [(n - 1, 0, None) for n in (1, splits - 1, splits, splits + 1, least, least + 1,
                                         splits * least, splits * least + 1, 8 * splits + 1)
             if 1 <= n <= S]
    cases += [(S - 1, 0, None), (S - 1, 5, 100), (40, 100, None), (1500, 0, 300),
              (700, 333, None), (31, 31, None)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_flash_split_geometry_matches_plain(dtype, int8, B):
    """The split-K kernel against the plain version at live lengths around
    the split count and its multiples, pos = S - 1, pad > pos (exact zeros),
    a window; row 1 (B 2) has its own pad.  Two runs give the same bits."""
    _need_card()
    from qwen3tts_tpu_torch.ops import cuda_build

    atol, rtol = TOL[dtype]
    dev = torch.device("cuda")
    q, k, v, scales = _flash_inputs(dtype, int8, B)
    L, _, S, KVH, _ = k.shape
    splits = fd.num_splits(S, B, KVH, cuda_build.sm_count(dev))
    assert splits > 1
    counter = "launches_int8kv" if int8 else "launches"
    for pos, pad, window in _split_cases(S, splits):
        pads = [pad, pad // 4][:B]
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        pd = torch.tensor(pads, dtype=torch.int32, device=dev)
        before = getattr(fd.flash_decode, counter)
        out = fd.flash_decode(q, k, v, 1, p, pd, window, *scales)
        again = fd.flash_decode(q, k, v, 1, p, pd, window, *scales)
        assert getattr(fd.flash_decode, counter) == before + 2
        ref = fd.flash_decode_plain(q, k, v, 1, p, pd, window, *scales)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol,
                                   msg=lambda m: f"pos {pos} pads {pads} window {window}: {m}")
        assert torch.equal(out, again)  # splits merged in a fixed order
        for b in range(B):
            if pads[b] > pos:
                assert torch.all(out[b] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_flash_graph_replays_across_positions(int8):
    """A CUDA graph captured once replays right after pos and pad change in
    device memory: each split finds its slice on the device."""
    _need_card()
    atol, rtol = TOL["bfloat16"]
    dev = torch.device("cuda")
    q, k, v, scales = _flash_inputs("bfloat16", int8, 1, L=3)
    p = torch.zeros((1,), dtype=torch.int32, device=dev)
    pd = torch.zeros((1,), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # allocates the workspace before capture
        fd.flash_decode(q, k, v, 2, p, pd, None, *scales)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd.flash_decode(q, k, v, 2, p, pd, None, *scales)
    for pos, pad in ((0, 0), (15, 0), (16, 0), (17, 2), (300, 0), (1024, 1000), (2047, 0),
                     (5, 9), (2000, 0)):
        p.fill_(pos)
        pd.fill_(pad)
        graph.replay()
        ref = fd.flash_decode_plain(q, k, v, 2, p, pd, None, *scales)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
        if pad > pos:
            assert torch.all(out == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [1, 1000, 8192])
@pytest.mark.parametrize("N", [8, 4096 + 8, 65536])
def test_matvec_split_k_shapes(dtype, K, N):
    """The split-K matvec at the edges of its shapes (N a ragged multiple of
    8, K from 1 to 8192) against the plain version; two runs give the same
    bits."""
    _need_card()
    atol, rtol = TOL[dtype]
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(dt)
    x = torch.randn((1, K), generator=g, device=dev).to(dt)
    before = mv.matvec.launches
    y, y2 = mv.matvec(x, w), mv.matvec(x, w)
    assert mv.matvec.launches == before + 2
    ref = mv.matvec_plain(x, w)
    torch.cuda.synchronize()
    assert y.shape == (1, N) and y.dtype == dt
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=rtol)
    assert torch.equal(y, y2)  # K splits summed in a fixed order


def _fused_inputs(dtype, quantized, B, H, Dq, N, I, seed=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def w(rows, cols):
        t = torch.randn((rows, cols), generator=g, device=dev) * rows ** -0.5
        return quantize_tensor(t) if quantized else t.to(dt)

    x = torch.randn((B, H), generator=g, device=dev).to(dt)
    attn = torch.randn((B, Dq), generator=g, device=dev).to(dt)
    nw = (1 + 0.1 * torch.randn((H,), generator=g, device=dev)).to(dt)
    return x, attn, nw, w(H, N), w(Dq, H), w(H, 2 * I), w(I, H)


# (B, H, Dq, N, I): the 0.6B talker and predictor, and a batch of 4
FUSED_SHAPES = [(1, 1024, 2048, 4096, 3072), (1, 1024, 1024, 2048, 3072),
                (4, 1024, 2048, 4096, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_kernels_match_plain(dtype, quantized, shape):
    _need_card()
    atol, rtol = TOL[dtype]
    B, H, Dq, N, I = shape
    x, attn, nw, wqkv, wo, wgu, wd = _fused_inputs(dtype, quantized, B, H, Dq, N, I)
    before = (fb.fused_norm_matmul.launches, fb.fused_o_mlp.launches)
    y = fb.fused_norm_matmul(x, nw, wqkv)
    z = fb.fused_o_mlp(x, attn, wo, nw, wgu, wd)
    z2 = fb.fused_o_mlp(x, attn, wo, nw, wgu, wd)
    assert (fb.fused_norm_matmul.launches, fb.fused_o_mlp.launches) == (
        before[0] + 1, before[1] + 2)
    y_ref = fb.fused_norm_matmul_plain(x, nw, wqkv)
    z_ref = fb.fused_o_mlp_plain(x, attn, wo, nw, wgu, wd)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and z.dtype == x.dtype
    torch.testing.assert_close(y.float(), y_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(z.float(), z_ref.float(), atol=atol, rtol=rtol)
    assert torch.equal(z, z2)  # no float atomics: the same bits every run


def _graph_of(fn):
    """A CUDA graph of one call of ``fn()``, warmed up on a side stream first
    (a wrapper allocates its workspace at first use, never while capturing)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


# (B, H, Dq, I): the 0.6B talker and predictor at 1, 2 and 32 rows, the 1.7B
# talker, and widths where an item is less than one ring stage
O_MLP_SHAPES = [(1, 1024, 2048, 3072), (2, 1024, 2048, 3072), (32, 1024, 2048, 3072),
                (1, 1024, 1024, 3072), (2, 1024, 1024, 3072), (32, 1024, 1024, 3072),
                (1, 2048, 2048, 6144), (3, 64, 64, 128), (1, 64, 128, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", O_MLP_SHAPES)
def test_o_mlp_kernel_rows_and_shapes(dtype, quantized, shape):
    """fused_o_mlp against its plain version; two runs give the same bits."""
    _need_card()
    atol, rtol = TOL[dtype]
    B, H, Dq, I = shape
    x, attn, nw, _, wo, wgu, wd = _fused_inputs(dtype, quantized, B, H, Dq, 8, I, seed=3)
    z, z2 = (fb.fused_o_mlp(x, attn, wo, nw, wgu, wd) for _ in range(2))
    z_ref = fb.fused_o_mlp_plain(x, attn, wo, nw, wgu, wd)
    torch.cuda.synchronize()
    torch.testing.assert_close(z.float(), z_ref.float(), atol=atol, rtol=rtol)
    assert torch.equal(z, z2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("quantized", [False, True])
def test_o_mlp_graph_replays_after_inputs_change(dtype, quantized):
    """One captured graph of fused_o_mlp, replayed after x and attn were
    rewritten in place: every replay equals the plain version."""
    _need_card()
    atol, rtol = TOL[dtype]
    x, attn, nw, _, wo, wgu, wd = _fused_inputs(dtype, quantized, 1, 1024, 2048, 8, 3072)
    graph, out = _graph_of(lambda: fb.fused_o_mlp(x, attn, wo, nw, wgu, wd))
    g = torch.Generator(device="cuda").manual_seed(9)
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        attn.copy_(torch.randn(attn.shape, generator=g, device="cuda"))
        graph.replay()
        ref = fb.fused_o_mlp_plain(x, attn, wo, nw, wgu, wd)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


# (B, H, N): the 0.6B talker's and predictor's qkv at 1, 2 and 32 rows, the
# 1.7B talker's, and narrow widths (8-column tiles, a ragged last tile)
NORM_MM_SHAPES = [(1, 1024, 4096), (2, 1024, 4096), (32, 1024, 4096), (1, 1024, 2048),
                  (2, 1024, 2048), (32, 1024, 2048), (1, 2048, 4096), (3, 64, 64),
                  (5, 64, 1064)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", NORM_MM_SHAPES)
def test_norm_matmul_kernel_rows_and_shapes(dtype, quantized, shape):
    """fused_norm_matmul against its plain version; two runs give the same
    bits."""
    _need_card()
    atol, rtol = TOL[dtype]
    B, H, N = shape
    x, _, nw, wqkv, *_ = _fused_inputs(dtype, quantized, B, H, 8, N, 8, seed=4)
    y, y2 = (fb.fused_norm_matmul(x, nw, wqkv) for _ in range(2))
    y_ref = fb.fused_norm_matmul_plain(x, nw, wqkv)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_ref.float(), atol=atol, rtol=rtol)
    assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("quantized", [False, True])
def test_norm_matmul_graph_replays_after_inputs_change(dtype, quantized):
    """One captured graph of fused_norm_matmul, replayed after x was
    rewritten in place: every replay equals the plain version."""
    _need_card()
    atol, rtol = TOL[dtype]
    x, _, nw, wqkv, *_ = _fused_inputs(dtype, quantized, 1, 1024, 8, 2048, 8)
    graph, out = _graph_of(lambda: fb.fused_norm_matmul(x, nw, wqkv))
    g = torch.Generator(device="cuda").manual_seed(10)
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        graph.replay()
        ref = fb.fused_norm_matmul_plain(x, nw, wqkv)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_fused_wrappers_raise_without_instance():
    """On CUDA tensors a shape or dtype without a kernel instance raises; the
    plain version never runs in its place."""
    _need_card()
    x, attn, nw, wqkv, wo, wgu, wd = _fused_inputs("bfloat16", False, 1, 256, 256, 256, 256)
    with pytest.raises(ValueError, match="no kernel instance"):  # K > 2048
        fb.fused_norm_matmul(x.new_zeros((1, 4096)), nw.new_ones(4096),
                             wqkv.new_zeros((4096, 256)))
    with pytest.raises(ValueError, match="no kernel instance"):  # a tile of 504 columns
        fb.fused_norm_matmul(x, nw, wqkv.new_zeros((256, 65536)))
    with pytest.raises(ValueError, match="no kernel instance"):  # I % 8 != 0
        fb.fused_o_mlp(x, attn, wo, nw, wgu[:, :2 * 44].contiguous(), wd[:44].contiguous())
    with pytest.raises(ValueError, match="float16"):
        fb.fused_norm_matmul(x.half(), nw.half(), wqkv.half())
    with pytest.raises(ValueError, match="must be"):  # weight dtype != activations
        fb.fused_norm_matmul(x, nw, wqkv.float())
    with pytest.raises(ValueError, match="contiguous"):
        fb.fused_norm_matmul(x, nw, wqkv.t().contiguous().t())
    with pytest.raises(ValueError, match="is on cpu"):
        fb.fused_norm_matmul(x, nw, wqkv.cpu())


@pytest.mark.cuda
def test_wrapper_rejects_unsupported_on_card():
    _need_card()
    dev = torch.device("cuda")
    q = torch.zeros((1, 4, 16), device=dev)
    kv = torch.zeros((1, 1, 32, 2, 16), device=dev)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no instance"):  # head_dim 16: no fallback
        fd.flash_decode(q, kv, kv, 0, pos, pos)
    kv64 = torch.zeros((1, 1, 32, 8, 64), device=dev)
    with pytest.raises(ValueError, match="no instance"):  # the predictor's head_dim
        fd.flash_decode(q.new_zeros((1, 16, 64)), kv64, kv64, 0, pos, pos)
    with pytest.raises(ValueError, match="int32"):
        fd.flash_decode(q.new_zeros((1, 16, 128)), kv.new_zeros((1, 1, 32, 8, 128)),
                        kv.new_zeros((1, 1, 32, 8, 128)), 0, pos.long(), pos)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_talker_decode_on_card_matches_cpu(int8):
    """float32 talker prefill + decode steps through the kernel on the card
    vs the plain version on the CPU; with ``int8`` int8 weights, an int8 KV
    cache and the fused kernels.  TF32 is off: cuDNN and cuBLAS would
    otherwise round float32 products to 10-bit mantissas."""
    _need_card()
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import talker as T

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = get_preset("tiny")
        # the talker's head layout (head_dim 128, 2 query heads per kv head)
        cfg = dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20))
        params = init_random(dataclasses.replace(base, talker=cfg), seed=1,
                             dtype=torch.float32)["talker"]
        if int8:
            from qwen3tts_tpu_torch.ops.quant import quantize_block_stack

            params = dict(params, blocks=quantize_block_stack(params["blocks"]))
        rng = np.random.default_rng(1)
        embeds = rng.standard_normal((1, 7, cfg.hidden_size)).astype(np.float32) * 0.1
        xs = rng.standard_normal((4, 1, 1, cfg.hidden_size)).astype(np.float32) * 0.1
        outs, caches = {}, {}  # caches: each output's KV cache as it left it

        def move(t, dev):
            return {k: move(v, dev) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)

        for device in ("cpu", "cuda"):
            dev = torch.device(device)
            p = move(params, dev)
            kv = T.new_kv_cache(cfg, 1, 32, torch.float32, dev, kv_quant=int8)
            pad = torch.zeros((1,), dtype=torch.int32, device=dev)
            _, logits, kv = T.prefill(p, cfg, torch.from_numpy(embeds).to(dev), pad, kv)
            hs, kvs = [logits.cpu()], [{k: t.to("cpu", copy=True) for k, t in kv.items()}]
            for i, x in enumerate(xs):
                pos = torch.full((1,), 7 + i, dtype=torch.int32, device=dev)
                h, kv = T.decode_step(p, cfg, torch.from_numpy(x).to(dev), pos, pad, kv,
                                      use_flash=True, fused=int8)
                hs.append(h.cpu())
                kvs.append({k: t.to("cpu", copy=True) for k, t in kv.items()})
            outs[device], caches[device] = hs, kvs
        errs = [float((a - b).abs().max()) for a, b in zip(outs["cuda"], outs["cpu"])]
        if not int8:
            assert max(errs) <= 1e-4, errs
            return

        def flipped(kv, ref):
            """(int8 entries of kv that differ from ref's, the largest difference)"""
            d = [(kv[k].int() - ref[k].int()).abs() for k in kv if kv[k].dtype == torch.int8]
            return sum(int((t > 0).sum()) for t in d), max(int(t.max()) for t in d)

        # With an int8 cache every new row is re-quantized, so a last-bit
        # difference in a float32 sum (the kernels sum in another order than
        # the CPU) can flip one int8 rounding, which moves what attends to
        # that row by about its scale: the outputs are continuous in the
        # kernels' last bits only while the card's int8 entries equal the
        # CPU's.  An output is held to 1e-4 where its cache's int8 entries
        # equal the CPU's, to 2e-3 where it attends to a flipped entry (one
        # flipped entry was measured to move a step by 3.2e-4 and the chain
        # by 8.7e-4); each step on the card from the CPU chain's cache as it
        # stood before the step flips at most 2 entries over the chain, by
        # one each.
        for e, kv, ref in zip(errs, caches["cuda"], caches["cpu"]):
            assert e <= (2e-3 if flipped(kv, ref)[0] else 1e-4), errs
        dev = torch.device("cuda")
        p, pad = move(params, dev), torch.zeros((1,), dtype=torch.int32, device=dev)
        flips = 0
        for i, x in enumerate(xs):
            pos = torch.full((1,), 7 + i, dtype=torch.int32, device=dev)
            h, kv = T.decode_step(p, cfg, torch.from_numpy(x).to(dev), pos, pad,
                                  move(caches["cpu"][i], dev), use_flash=True, fused=int8)
            n, most = flipped({k: t.cpu() for k, t in kv.items()}, caches["cpu"][i + 1])
            err = float((h.cpu() - outs["cpu"][1 + i]).abs().max())
            print(f"int8 step {i} from the CPU's cache: max_abs_err {err:.3e}, {n} int8 "
                  f"cache entries flipped")
            assert most <= 1 and err <= (2e-3 if n else 1e-4), (i, n, most, err)
            flips += n
        assert flips <= 2, flips
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_engine_on_card_raises_for_head_layout_without_kernel():
    """The tiny preset's talker (head_dim 16) has no kernel instance: on the
    card its decode raises instead of running the plain version."""
    _need_card()
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy

    cfg = get_preset("tiny")
    params = init_random(cfg, seed=0, dtype=torch.float32, device="cuda")
    eng = Engine(params["talker"], params["predictor"], cfg, max_seq_len=64)
    H = cfg.talker.hidden_size
    state = eng.prefill(np.zeros((1, 6, H), np.float32), None, GenerationPolicy(do_sample=False))
    tpe = torch.zeros((1, 1, H), device="cuda")
    with pytest.raises(ValueError, match="no instance"):
        eng.decode_chunk(state, tpe, 1, tpe, 1)


def _predictor_params(dtype, cfg, talker_hidden, seed):
    """Random predictor parameters on the card, norms and proj bias moved off
    1 / 0 so that a misplaced one shows."""
    from qwen3tts_tpu_torch.models import predictor as P

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    p = P.init_params(g, cfg, talker_hidden, dtype, dev)

    def jitter(t, base):
        return (base + 0.1 * torch.randn(t.shape, generator=g, device=dev)).to(dtype)

    for k in ("input_norm", "post_norm", "q_norm", "k_norm"):
        p["blocks"][k] = jitter(p["blocks"][k], 1.0)
    p["final_norm"] = jitter(p["final_norm"], 1.0)
    p["small_to_mtp"]["b"] = jitter(p["small_to_mtp"]["b"], 0.0)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_micro_step_kernel_matches_plain(dtype):
    """Four chained kernel micro-steps (pos 2..5) at the 0.6B predictor's
    shapes; each step's h and cache against the plain version run on the
    kernel's cache as it stood before the step.  In float32 the plain chain
    also runs on its own.  bf16 is held to MICRO_BF16_TOL.  A second run
    gives the same bits."""
    _need_card()
    from qwen3tts_tpu_torch.core.presets import get_preset

    dt = getattr(torch, dtype)
    cfg = get_preset("qwen3-tts-0.6b")
    pcfg, Ht = cfg.predictor, cfg.talker.hidden_size
    w = ps.micro_step_weights(_predictor_params(dt, pcfg, Ht, seed=5))
    tol = MICRO_BF16_TOL if dtype == "bfloat16" else TOL[dtype]
    _micro_chain(w, pcfg, Ht, dt, pcfg.num_hidden_layers, tol, dtype == "float32")


def _micro_chain(w, pcfg, Ht, dt, L, tol, free_running, rows=None):
    """Kernel micro-steps, each against the plain version on the kernel's
    cache; with ``free_running`` the plain chain also runs on its own.  With
    ``rows`` the cache is [L, rows, S, KVH, D] and x [rows, Ht]; without,
    one row's [L, S, KVH, D] and x [1, Ht]."""
    from qwen3tts_tpu_torch.models import predictor as P

    atol, rtol = tol
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    lead = (L,) if rows is None else (L, rows)
    slot = len(lead)  # the cache's slot axis
    shape = lead + (pcfg.max_seq, pcfg.num_key_value_heads, pcfg.head_dim)
    k0, v0 = (torch.zeros(shape, device=dev, dtype=dt) for _ in range(2))
    for t in (k0, v0):
        t.narrow(slot, 0, 2).copy_(torch.randn(t.narrow(slot, 0, 2).shape, generator=g,
                                               device=dev))
    R = rows or 1
    xs = [(0.5 * torch.randn((R, Ht), generator=g, device=dev)).to(dt) for _ in range(4)]

    def step(fn, i, kk, vv):
        pos = torch.full((1,), 2 + i, dtype=torch.int32, device=dev)
        cos, sin = P._rope(pcfg, pos.reshape(1, 1))
        return fn(w, xs[i], cos[0, 0], sin[0, 0], kk, vv, pos, pcfg.rms_norm_eps)

    def close(a, b):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)

    runs = []
    for _ in range(2):
        kk, vv, hs = k0.clone(), v0.clone(), []
        for i in range(len(xs)):
            kp, vp = kk.clone(), vv.clone()
            before = ps.fused_micro_step.launches
            h, kk, vv = step(ps.fused_micro_step, i, kk, vv)
            assert ps.fused_micro_step.launches == before + 1
            hp, kp, vp = step(ps.fused_micro_step_plain, i, kp, vp)
            torch.cuda.synchronize()
            assert h.dtype == dt and h.shape == (R, pcfg.hidden_size)
            close(h, hp)
            close(kk, kp)
            close(vv, vp)
            hs.append(h)
        n = pcfg.max_seq - 2 - len(xs)
        assert not kk.narrow(slot, 2 + len(xs), n).any()
        assert not vv.narrow(slot, 2 + len(xs), n).any()
        runs.append(hs + [kk, vv])
    for a, b in zip(*runs):
        assert torch.equal(a, b)  # no float atomics: the same bits every run
    if free_running:
        kp, vp = k0.clone(), v0.clone()
        for i in range(len(xs)):
            hp, kp, vp = step(ps.fused_micro_step_plain, i, kp, vp)
            close(runs[0][i], hp)
        close(runs[0][-2], kp)
        close(runs[0][-1], vp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows", [("bfloat16", 1), ("bfloat16", 2), ("bfloat16", 4),
                                        ("bfloat16", 16), ("float32", 4), ("float32", 16)])
@pytest.mark.parametrize("talker_hidden", [1024, 2048])
def test_micro_step_rows_match_plain(dtype, rows, talker_hidden):
    """The kernel at R rows of one ``pos`` (a cache [L, R, S, KVH, D]; R 1
    runs micro_step_kernel, 2-16 micro_step_kernel_rows) at the 0.6B predictor's
    shapes, its proj input 1024 (0.6B) or 2048 wide (1.7B): four chained
    steps against the plain version, one launch a step, two runs the same
    bits; bf16 held to MICRO_BF16_TOL, float32 also free-running."""
    _need_card()
    from qwen3tts_tpu_torch.core.presets import get_preset

    dt = getattr(torch, dtype)
    pcfg = get_preset("qwen3-tts-0.6b").predictor
    w = ps.micro_step_weights(_predictor_params(dt, pcfg, talker_hidden, seed=5))
    tol = MICRO_BF16_TOL if dtype == "bfloat16" else TOL[dtype]
    _micro_chain(w, pcfg, talker_hidden, dt, pcfg.num_hidden_layers, tol, dtype == "float32",
                 rows=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_micro_step_rows_small_widths(dtype):
    """3 rows of a predictor of small widths (hidden 128, 2/1 heads of 64, I
    192, 5 layers): phases of unequal item counts meet at grid barriers, and
    the rows are not a multiple of 4."""
    _need_card()
    from qwen3tts_tpu_torch.core.presets import get_preset

    dt = getattr(torch, dtype)
    pcfg = dataclasses.replace(get_preset("tiny").predictor, hidden_size=128,
                               num_attention_heads=2, num_key_value_heads=1, head_dim=64,
                               intermediate_size=192, num_hidden_layers=5)
    w = ps.micro_step_weights(_predictor_params(dt, pcfg, 64, seed=9))
    tol = MICRO_BF16_TOL if dtype == "bfloat16" else TOL[dtype]
    _micro_chain(w, pcfg, 64, dt, 5, tol, dtype == "float32", rows=3)


@pytest.mark.cuda
def test_micro_step_rows_graph_replays_after_inputs_change():
    """One captured graph of a 16-row micro-step at the 0.6B shapes (bf16),
    replayed after x, the rope rows, pos and the cache were rewritten: every
    replay equals the plain version on the same inputs, h and the cache."""
    _need_card()
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import predictor as P

    dt, R = torch.bfloat16, 16
    atol, rtol = MICRO_BF16_TOL
    cfg = get_preset("qwen3-tts-0.6b")
    pcfg, Ht = cfg.predictor, cfg.talker.hidden_size
    w = ps.micro_step_weights(_predictor_params(dt, pcfg, Ht, seed=5))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    shape = (pcfg.num_hidden_layers, R, pcfg.max_seq, pcfg.num_key_value_heads, pcfg.head_dim)
    kk, vv = (torch.randn(shape, generator=g, device=dev).to(dt) for _ in range(2))
    x = torch.zeros((R, Ht), device=dev, dtype=dt)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    cos, sin = (torch.zeros((pcfg.head_dim,), device=dev) for _ in range(2))
    before = ps.fused_micro_step.launches
    graph, (h, _, _) = _graph_of(lambda: ps.fused_micro_step(w, x, cos, sin, kk, vv, pos,
                                                             pcfg.rms_norm_eps))
    assert ps.fused_micro_step.launches == before + 1  # the warm-up; the capture launches none
    for p in (2, 9, 16, 5):
        x.copy_(0.5 * torch.randn((R, Ht), generator=g, device=dev))
        pos.fill_(p)
        c, s_ = P._rope(pcfg, pos.reshape(1, 1))
        cos.copy_(c[0, 0])
        sin.copy_(s_[0, 0])
        kp, vp = kk.clone(), vv.clone()
        graph.replay()
        hp, kp, vp = ps.fused_micro_step_plain(w, x, cos, sin, kp, vp, pos, pcfg.rms_norm_eps)
        torch.cuda.synchronize()
        torch.testing.assert_close(h.float(), hp.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(kk.float(), kp.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(vv.float(), vp.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layers", [1, 5])
def test_micro_step_kernel_small_widths(dtype, layers):
    """A predictor of small widths (hidden 128, 2/1 heads of 64, I 192), 1
    and 5 layers: every item is less than one ring stage, and at 5 layers
    the ring wraps around."""
    _need_card()
    from qwen3tts_tpu_torch.core.presets import get_preset

    dt = getattr(torch, dtype)
    pcfg = dataclasses.replace(get_preset("tiny").predictor, hidden_size=128,
                               num_attention_heads=2, num_key_value_heads=1, head_dim=64,
                               intermediate_size=192, num_hidden_layers=layers)
    w = ps.micro_step_weights(_predictor_params(dt, pcfg, 64, seed=9))
    tol = MICRO_BF16_TOL if dtype == "bfloat16" else TOL[dtype]
    _micro_chain(w, pcfg, 64, dt, layers, tol, dtype == "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_micro_step_graph_replays_after_inputs_change(dtype):
    """One captured graph of a micro-step at the 0.6B shapes, replayed after
    x, the rope rows, pos and the cache were rewritten: every replay equals
    the plain version on the same inputs, h and the slot it wrote."""
    _need_card()
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import predictor as P

    dt = getattr(torch, dtype)
    atol, rtol = MICRO_BF16_TOL if dtype == "bfloat16" else TOL[dtype]
    cfg = get_preset("qwen3-tts-0.6b")
    pcfg, Ht = cfg.predictor, cfg.talker.hidden_size
    w = ps.micro_step_weights(_predictor_params(dt, pcfg, Ht, seed=5))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    shape = (pcfg.num_hidden_layers, pcfg.max_seq, pcfg.num_key_value_heads, pcfg.head_dim)
    kk, vv = (torch.randn(shape, generator=g, device=dev).to(dt) for _ in range(2))
    x = torch.zeros((1, Ht), device=dev, dtype=dt)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    cos, sin = (torch.zeros((pcfg.head_dim,), device=dev) for _ in range(2))
    graph, (h, _, _) = _graph_of(lambda: ps.fused_micro_step(w, x, cos, sin, kk, vv, pos,
                                                             pcfg.rms_norm_eps))
    for p in (0, 7, 16, 3):
        x.copy_(0.5 * torch.randn((1, Ht), generator=g, device=dev))
        pos.fill_(p)
        c, s_ = P._rope(pcfg, pos.reshape(1, 1))
        cos.copy_(c[0, 0])
        sin.copy_(s_[0, 0])
        kp, vp = kk.clone(), vv.clone()
        graph.replay()
        hp, kp, vp = ps.fused_micro_step_plain(w, x, cos, sin, kp, vp, pos, pcfg.rms_norm_eps)
        torch.cuda.synchronize()
        torch.testing.assert_close(h.float(), hp.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(kk.float(), kp.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(vv.float(), vp.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("K,N", [(1024, 4096), (1024, 65536), (1000, 4096)])
def test_matvec_kernels_match_plain(dtype, K, N):
    _need_card()
    atol, rtol = TOL[dtype]
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(dt)
    wt = w.t().contiguous()
    x = torch.randn((1, K), generator=g, device=dev).to(dt)
    before = (mv.matvec.launches, mv.matvec_kt.launches)
    y, z = mv.matvec(x, w), mv.matvec_kt(x, wt)
    assert (mv.matvec.launches, mv.matvec_kt.launches) == (before[0] + 1, before[1] + 1)
    y_ref, z_ref = mv.matvec_plain(x, w), mv.matvec_kt_plain(x, wt)
    torch.cuda.synchronize()
    assert y.shape == (1, N) and y.dtype == dt and z.shape == (N, 1) and z.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(z, z_ref, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_new_wrappers_raise_without_instance():
    """On CUDA tensors a layout without a kernel instance raises; the plain
    version never runs in its place."""
    _need_card()
    from qwen3tts_tpu_torch.core.presets import get_preset

    cfg = get_preset("tiny")  # predictor head_dim 16: no micro-step instance
    pcfg = cfg.predictor
    w = ps.micro_step_weights(_predictor_params(torch.float32, pcfg, cfg.talker.hidden_size, 8))
    dev = torch.device("cuda")
    shape = (pcfg.num_hidden_layers, pcfg.max_seq, pcfg.num_key_value_heads, pcfg.head_dim)
    kv = torch.zeros(shape, device=dev)
    cs = torch.ones(pcfg.head_dim, device=dev)
    pos = torch.full((1,), 2, dtype=torch.int32, device=dev)
    x = torch.zeros((1, cfg.talker.hidden_size), device=dev)
    with pytest.raises(ValueError, match="no kernel instance"):
        ps.fused_micro_step(w, x, cs, cs, kv, kv.clone(), pos)
    with pytest.raises(ValueError, match="is on cpu"):
        ps.fused_micro_step(w, x, cs, cs.cpu(), kv, kv.clone(), pos)
    xm = torch.zeros((1, 1024), device=dev)
    with pytest.raises(ValueError, match="no kernel instance"):  # K > 8192
        mv.matvec(xm.new_zeros((1, 9000)), xm.new_zeros((9000, 64)))
    with pytest.raises(ValueError, match="one dtype"):
        mv.matvec(xm, xm.new_zeros((1024, 64)).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        mv.matvec_kt(xm, xm.new_zeros((1024, 64)).t())


@pytest.mark.cuda
def test_micro_frame_on_card_matches_cpu():
    """Greedy predict_frame(micro_kernel=True) on a small float32 model
    (predictor head_dim 64): the card (kernel, 14 launches) and the CPU
    (plain version) give the same tokens, embed_sum within 1e-4.  TF32 off."""
    _need_card()
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import predictor as P

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = get_preset("tiny")
        cfg = dataclasses.replace(base, predictor=dataclasses.replace(base.predictor,
                                                                      head_dim=64))
        params = init_random(cfg, seed=2, dtype=torch.float32, device="cpu")["predictor"]
        pin = torch.randn((1, 2, cfg.talker.hidden_size),
                          generator=torch.Generator().manual_seed(3))
        out = {}
        for device in ("cuda", "cpu"):
            dev = torch.device(device)
            def move(t):
                return {k: move(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)

            before = ps.fused_micro_step.launches
            out[device] = P.predict_frame(move(params), cfg.predictor, pin.to(dev), None,
                                          P.SamplingPolicy(do_sample=False), micro_kernel=True)
            assert ps.fused_micro_step.launches - before == (14 if device == "cuda" else 0)
        torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0], atol=0, rtol=0)
        np.testing.assert_allclose(out["cuda"][1].cpu().numpy(), out["cpu"][1].numpy(),
                                   atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# captured decode chunks (runtime/graphs.py)


def _graph_model(mode: str, seed: int = 8):
    """(params, cfg) of a small model whose every part has a kernel instance
    on the card (talker head_dim 128, predictor head_dim 64), and Engine
    options for ``mode``: float32 or bf16 default, int8 weights + int8 KV
    cache + fused kernels, or the micro-step kernel."""
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.ops.quant import quantize_bundle

    base = get_preset("tiny")
    cfg = dataclasses.replace(
        base, talker=dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20)),
        predictor=dataclasses.replace(base.predictor, head_dim=64))
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    params = init_random(cfg, seed=seed, dtype=dtype, device="cuda")
    kw = {}
    if mode == "int8":
        params = quantize_bundle(params, "int8")
        kw = dict(use_fused_kernels=True, kv_quant=True)
    elif mode == "micro":
        kw = dict(use_micro_kernel=True)
    return params, cfg, kw


def _engines(params, cfg, kw):
    from qwen3tts_tpu_torch.runtime.engine import Engine

    return {graphs: Engine(params["talker"], params["predictor"], cfg, max_seq_len=128,
                           use_cuda_graphs=graphs, **kw) for graphs in (False, True)}


def _greedy_chunks(eng, seed: int, chunks: int = 3, chunk: int = 8):
    """Greedy frames of prefill + ``chunks`` decode chunks of ``chunk``."""
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    H = eng.talker_cfg.hidden_size
    g = torch.Generator().manual_seed(seed)
    embeds, tth, tpe = (torch.randn(s, generator=g) * 0.1 for s in
                        ((1, 12, H), (1, 16, H), (1, 1, H)))
    state = eng.prefill(embeds, None, GenerationPolicy(do_sample=False, min_new_tokens=99),
                        SamplingPolicy(do_sample=False))
    tth, tpe = tth.to("cuda", eng.dtype), tpe.to("cuda", eng.dtype)
    out = []
    for _ in range(chunks):
        _, frames, n, lens, _ = eng.decode_chunk(state, tth, 5, tpe, chunk)
        out.append(frames[0, : int(lens[0])].cpu())
    eng.release(state)
    return torch.cat(out)


@pytest.fixture()
def no_tf32():
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "bf16", "int8", "micro"])
def test_captured_chunks_equal_eager_tokens(mode, no_tf32):
    """The same kernels in the same order, captured or eager, give the same
    greedy tokens; the captured engine replays a graph for every chunk."""
    _need_card()
    params, cfg, kw = _graph_model(mode)
    eng = _engines(params, cfg, kw)
    eager, captured = _greedy_chunks(eng[False], 1), _greedy_chunks(eng[True], 1)
    assert eng[False].graphs is None and eng[True].graphs.replays == 3
    assert eng[True].graphs.captures == 1
    torch.testing.assert_close(captured, eager, atol=0, rtol=0)


@pytest.mark.cuda
def test_default_engines_take_the_micro_kernel(no_tf32):
    """A default FasterQwen3TTS takes the whole-micro-step kernel at B 1 and
    in its B 16 batch engine: their dispatched frame steps count only under
    ``predictor_frames.kernel``, an eager step launches the kernel 14 times,
    and a captured chunk gives the eager chunk's greedy tokens."""
    _need_card()
    from qwen3tts_tpu_torch.api.model import FasterQwen3TTS
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy
    from qwen3tts_tpu_torch.utils.timing import TRACE

    params, cfg, _ = _graph_model("bf16")
    model = FasterQwen3TTS(cfg, params, max_seq_len=128)
    H = cfg.talker.hidden_size
    for B in (1, 16):
        eng = model._batch_engine(B)
        assert eng.use_micro_kernel and eng.batch == B
        g = torch.Generator().manual_seed(B)
        embeds, tth, tpe = (torch.randn(s, generator=g) * 0.1 for s in
                            ((B, 12, H), (B, 16, H), (B, 1, H)))
        tth, tpe = tth.to("cuda", eng.dtype), tpe.to("cuda", eng.dtype)
        pol = GenerationPolicy(do_sample=False, min_new_tokens=99)
        frames = {}
        for graphs in (False, True):
            before = dict(TRACE.counters)
            launches = ps.fused_micro_step.launches
            state = eng.prefill(embeds, None, pol, SamplingPolicy(do_sample=False))
            with (eng.eager() if not graphs else contextlib.nullcontext()):
                _, f, n, lens, _ = eng.decode_chunk(state, tth, 5, tpe, 8)
            frames[graphs] = f[:, : int(n)].cpu()
            eng.release(state)
            got = {k: TRACE.counters.get(k, 0) - before.get(k, 0)
                   for k in ("predictor_frames.kernel", "predictor_frames.eager")}
            assert got == {"predictor_frames.kernel": 8, "predictor_frames.eager": 0}
            if not graphs:
                assert ps.fused_micro_step.launches - launches == 14 * 8
        torch.testing.assert_close(frames[True], frames[False], atol=0, rtol=0)


@pytest.mark.cuda
def test_seeded_replays_repeat_and_seeds_differ():
    """Sampled requests through captured chunks: seeds a, a repeat token for
    token, seed b differs, and each equals the eager engine's request with
    the same seed (a replay draws the eager steps' Philox offsets)."""
    _need_card()
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    params, cfg, kw = _graph_model("float32")
    eng = _engines(params, cfg, kw)
    H = cfg.talker.hidden_size
    g = torch.Generator().manual_seed(4)
    prompt = [torch.randn(s, generator=g).numpy() * 0.1 for s in
              ((1, 12, H), (1, 7, H), (1, 1, H))]

    def run(e, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        ids, _ = loops.fast_generate(e, *prompt, generator=gen, max_new_tokens=24,
                                     policy=GenerationPolicy(min_new_tokens=24),
                                     pred_policy=SamplingPolicy(), device_chunk=8)
        return ids

    a1, a2, b = run(eng[True], 5), run(eng[True], 5), run(eng[True], 6)
    np.testing.assert_array_equal(a1, a2)
    assert not np.array_equal(a1, b)
    np.testing.assert_array_equal(a1, run(eng[False], 5))
    np.testing.assert_array_equal(b, run(eng[False], 6))


@pytest.mark.cuda
def test_interleaved_captured_streams_equal_eager():
    """Two streamed requests on one captured engine, advanced in turn: each
    holds its own cache (and so captures its own graphs) and gives its eager
    tokens and audio."""
    _need_card()
    from qwen3tts_tpu_torch.audio.vocoder import Vocoder
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    params, cfg, kw = _graph_model("float32")
    eng = _engines(params, cfg, kw)
    voc = Vocoder(params["codec"], cfg.codec, compute_dtype=None)
    H = cfg.talker.hidden_size
    g = torch.Generator().manual_seed(9)
    prompts = [[torch.randn(s, generator=g).numpy() * 0.1 for s in
                ((1, T, H), (1, 6, H), (1, 1, H))] for T in (10, 14)]

    def stream(e, p):
        return loops.fast_generate_streaming_audio(
            e, voc, *p, generator=None, max_new_tokens=24,
            policy=GenerationPolicy(do_sample=False, min_new_tokens=24),
            pred_policy=SamplingPolicy(do_sample=False), chunk_size=8)

    want = [[(f, a) for f, a, _ in stream(eng[False], p)] for p in prompts]
    streams = [stream(eng[True], p) for p in prompts]
    got = [[], []]
    for _ in range(3):
        for i, s in enumerate(streams):
            f, a, _ = next(s)
            got[i].append((f, a))
    for s in streams:
        with pytest.raises(StopIteration):
            next(s)
    for g_i, w_i in zip(got, want):
        for (f, a), (wf, wa) in zip(g_i, w_i):
            np.testing.assert_array_equal(f, wf)
            np.testing.assert_allclose(a, wa, atol=1e-5)
    assert eng[True].graphs.captures == 2  # one decode + vocode graph per cache
    assert len(eng[True]._kv_pool) == 2  # both caches hold graphs: both pooled


@pytest.mark.cuda
@pytest.mark.parametrize("mode,module", [("float32", "flash"), ("int8", "fused"),
                                         ("micro", "micro")])
def test_capture_without_eager_step_raises(mode, module):
    """A step captured before any eager call of its shape finds no workspace
    and raises (the wrappers refuse to allocate during capture): the reason
    the engine runs one eager step before each capture."""
    _need_card()
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    params, cfg, kw = _graph_model(mode)
    eng = _engines(params, cfg, kw)[True]
    H = cfg.talker.hidden_size
    state = eng.prefill(np.zeros((1, 6, H), np.float32), None,
                        GenerationPolicy(do_sample=False), SamplingPolicy(do_sample=False))
    eng._own(state)
    tpe = torch.zeros((1, 1, H), device="cuda")
    torch.cuda.synchronize()
    {"flash": fd._workspace, "fused": fb._workspace, "micro": ps._workspace}[module].clear()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before"):
        with torch.cuda.graph(graph):
            eng._one_step(state, tpe, 0, tpe)


@pytest.mark.cuda
def test_decode_vocode_graph_equals_eager_audio(no_tf32):
    """chunk_vocode replayed from its graph gives the eager path's frames and,
    through a float32 codec, its audio within 1e-5; the stream state lives
    in the graph's buffers and carries across chunks."""
    _need_card()
    from qwen3tts_tpu_torch.audio.vocoder import Vocoder
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    params, cfg, kw = _graph_model("float32")
    eng = _engines(params, cfg, kw)
    voc = Vocoder(params["codec"], cfg.codec, compute_dtype=None)
    H = cfg.talker.hidden_size
    embeds = torch.randn((1, 9, H), generator=torch.Generator().manual_seed(2)) * 0.1
    tpe = torch.zeros((1, 1, H), device="cuda")
    out = {}
    for graphs, e in eng.items():
        state = e.prefill(embeds, None, GenerationPolicy(do_sample=False, min_new_tokens=99),
                          SamplingPolicy(do_sample=False))
        vst, chunks = voc.stream_state(), []
        for _ in range(3):
            _, frames, n, lens, done, audio, vst = e.chunk_vocode(voc, state, tpe, 0, tpe, 8,
                                                                   vst)
            chunks.append((frames.cpu().clone(), audio.cpu().clone()))
        out[graphs] = chunks
    assert eng[True].graphs.replays == 3
    for (f, a), (wf, wa) in zip(out[True], out[False]):
        torch.testing.assert_close(f, wf, atol=0, rtol=0)
        torch.testing.assert_close(a, wa, atol=1e-5, rtol=0)
