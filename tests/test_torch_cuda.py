"""PyTorch port on the card: the CUDA kernels (flash-decode with a float
and an int8 cache, fused_norm_matmul, fused_o_mlp) against their plain
versions, the wrappers' refusals, and the talker decode through the kernels
against the CPU.

These need an NVIDIA card and nvcc, and skip elsewhere.  The card's machine
has no JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3tts_tpu_torch.ops import flash_decode as fd  # noqa: E402
from qwen3tts_tpu_torch.ops import fused_block as fb  # noqa: E402
from qwen3tts_tpu_torch.ops.quant import quantize_tensor  # noqa: E402

# kernel vs plain, elementwise |out - ref| <= atol + rtol * |ref|
TOL = {"bfloat16": (2e-3, 1.6e-2),  # kernel and plain each round to bf16: 2 ulps of |ref|
       "float32": (1e-5, 0.0)}  # summation order only


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


@pytest.mark.cuda
def test_fused_wrappers_raise_without_instance():
    """On CUDA tensors a shape or dtype without a kernel instance raises; the
    plain version never runs in its place."""
    _need_card()
    x, attn, nw, wqkv, wo, wgu, wd = _fused_inputs("bfloat16", False, 1, 256, 256, 256, 256)
    with pytest.raises(ValueError, match="no kernel instance"):  # K > 2048
        fb.fused_norm_matmul(x.new_zeros((1, 4096)), nw.new_ones(4096),
                             wqkv.new_zeros((4096, 256)))
    with pytest.raises(ValueError, match="no kernel instance"):  # I % 32 != 0
        fb.fused_o_mlp(x, attn, wo, nw, wgu[:, :2 * 48].contiguous(), wd[:48].contiguous())
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
        outs = {}
        for device in ("cuda", "cpu"):
            dev = torch.device(device)
            def move(t):
                return {k: move(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)

            p = move(params)
            kv = T.new_kv_cache(cfg, 1, 32, torch.float32, dev, kv_quant=int8)
            pad = torch.zeros((1,), dtype=torch.int32, device=dev)
            _, logits, kv = T.prefill(p, cfg, torch.from_numpy(embeds).to(dev), pad, kv)
            hs = [logits.cpu()]
            for i, x in enumerate(xs):
                pos = torch.full((1,), 7 + i, dtype=torch.int32, device=dev)
                h, kv = T.decode_step(p, cfg, torch.from_numpy(x).to(dev), pos, pad, kv,
                                      use_flash=True, fused=int8)
                hs.append(h.cpu())
            outs[device] = hs
        for a, b in zip(outs["cuda"], outs["cpu"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
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
