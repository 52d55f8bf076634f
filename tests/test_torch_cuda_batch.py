"""Batched generation of the PyTorch port on the card: captured chunks
against eager ones at batch 3 (tokens, the state after each chunk, and the
steps a chunk runs once rows end), the kernel nodes that each step of a
recorded capture holds against an eager step's launches, and the
flash-decode kernel at batch 4 with a left pad of its own per row against
its plain version.

These need an NVIDIA card and nvcc, and skip elsewhere.  The card's machine
has no JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda_batch.py -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

LENGTHS = (6, 10, 8)
CHUNK = 8
# kernel vs plain, elementwise |out - ref| <= atol + rtol * |ref|
TOL = {"bfloat16": (2e-3, 1.6e-2),  # kernel and plain each round to bf16: 2 ulps of |ref|
       "float32": (1e-5, 0.0)}  # summation order only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.fixture()
def no_tf32():
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _model(mode: str):
    """A small float32 model whose every part has a kernel instance on the
    card (talker head_dim 128), and its Engine options: the default path, or
    int8 weights + int8 KV cache + fused kernels."""
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.ops.quant import quantize_bundle

    base = get_preset("tiny")
    cfg = dataclasses.replace(
        base, talker=dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20)),
        predictor=dataclasses.replace(base.predictor, head_dim=64))
    params = init_random(cfg, seed=8, dtype=torch.float32, device="cuda")
    if mode == "int8":
        return quantize_bundle(params, "int8"), cfg, dict(use_fused_kernels=True, kv_quant=True)
    return params, cfg, {}


def _rows(H: int):
    """Prompts of LENGTHS tokens left-padded into one batch, their pads, and
    the trailing texts."""
    g = torch.Generator().manual_seed(3)
    T = max(LENGTHS)
    batch = torch.zeros((3, T, H))
    for b, L in enumerate(LENGTHS):
        batch[b, T - L:] = torch.randn((L, H), generator=g) * 0.1
    pads = np.asarray([T - L for L in LENGTHS])
    return batch.numpy(), pads, (torch.randn((3, 16, H), generator=g) * 0.1).cuda()


def _chunks(eng, eos_id=None, retire_after_first=False):
    """Three greedy chunks of 8 at batch 3; with ``retire_after_first`` rows 0
    and 2 are marked done after the first.  Returns per chunk (frames, n,
    lens, the state's tensors), all on the host."""
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    if eos_id is not None:
        eng.eos_id = eos_id
    H = eng.talker_cfg.hidden_size
    batch, pads, tth = _rows(H)
    tpe = torch.zeros((3, 1, H), device="cuda")
    state = eng.prefill(batch, None, GenerationPolicy(do_sample=False, min_new_tokens=0),
                        SamplingPolicy(do_sample=False), pad_count=pads)
    out = []
    for i in range(3):
        _, frames, n, lens, _ = eng.decode_chunk(state, tth, 16, tpe, CHUNK)
        eng.settle(state, int(n))
        out.append((frames.cpu().clone(), int(n), lens.cpu().clone(),
                    {k: state[k].cpu().clone() for k in ("pos", "pad_count", "gen_step",
                                                          "n_gen", "token", "done")}))
        if i == 0 and retire_after_first:
            with torch.inference_mode():
                state["done"][0] = state["done"][2] = True
    assert state["pos_host"] == int(state["pos"])
    eng.release(state)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_batched_captured_chunks_equal_eager(mode, no_tf32):
    """At batch 3 with a pad per row: captured chunks give the eager chunks'
    frames and state after every chunk.  Then, with rows 0 and 2 retired
    after the first chunk and row 1's EOS set to a token it first samples in
    the second, both stop there (``n`` the steps to the EOS) and the third
    chunk runs no step."""
    _need_card()
    from qwen3tts_tpu_torch.runtime.engine import Engine

    params, cfg, kw = _model(mode)

    def engine(graphs):
        return Engine(params["talker"], params["predictor"], cfg, max_seq_len=128, batch=3,
                      use_cuda_graphs=graphs, **kw)

    eager = _chunks(engine(False))
    captured_eng = engine(True)
    captured = _chunks(captured_eng)
    assert captured_eng.graphs.replays == 3 and captured_eng.graphs.captures == 1
    for (f, n, lens, st), (wf, wn, wlens, wst) in zip(captured, eager):
        torch.testing.assert_close(f, wf, atol=0, rtol=0)
        assert n == wn == CHUNK and torch.equal(lens, wlens)
        for k in st:
            torch.testing.assert_close(st[k], wst[k], atol=0, rtol=0, msg=k)

    row1 = torch.cat([f[1, :, 0] for f, _, _, _ in eager]).tolist()
    first = {}
    for i, t in enumerate(row1):
        first.setdefault(t, i)
    k = min((i for i in first.values() if CHUNK < i < 2 * CHUNK), default=None)
    assert k is not None, "row 1 samples no new token in its second chunk"
    runs = [_chunks(engine(g), eos_id=row1[k], retire_after_first=True) for g in (False, True)]
    for (f, n, lens, st), (wf, wn, wlens, wst) in zip(runs[1], runs[0]):
        torch.testing.assert_close(f, wf, atol=0, rtol=0)
        assert n == wn and torch.equal(lens, wlens)
        for name in st:
            torch.testing.assert_close(st[name], wst[name], atol=0, rtol=0, msg=name)
    assert [n for _, n, _, _ in runs[1]] == [CHUNK, k - CHUNK, 0]
    assert not runs[1][2][0].any()  # the third chunk's frames stay zeros


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_recorded_graph_holds_the_eager_steps_kernels(mode, no_tf32):
    """At batch 3, each step of a chunk captured with
    ``ChunkGraphs(record=True)`` holds, in its conditional node's body, the
    kernels an eager step launches (the wrappers' counters), and nothing
    outside the steps; the wrappers count no call while the chunk is
    captured (only the capture's eager step on copies); each replay logs
    its ``n``."""
    _need_card()
    from qwen3tts_tpu_torch.ops import flash_decode as fd
    from qwen3tts_tpu_torch.ops import fused_block as fb
    from qwen3tts_tpu_torch.ops.cuda_build import KERNEL_SYMBOLS
    from qwen3tts_tpu_torch.runtime.engine import Engine
    from qwen3tts_tpu_torch.runtime.graphs import ChunkGraphs

    params, cfg, kw = _model(mode)

    def engine(graphs):
        return Engine(params["talker"], params["predictor"], cfg, max_seq_len=128, batch=3,
                      use_cuda_graphs=graphs, **kw)

    def counts():
        return [fd.flash_decode.launches + fd.flash_decode.launches_int8kv,
                fb.fused_norm_matmul.launches, fb.fused_o_mlp.launches]

    before = counts()
    _chunks(engine(False))
    delta = [a - b for a, b in zip(counts(), before)]
    assert delta[0] > 0 and all(d % (3 * CHUNK) == 0 for d in delta)
    eager = [d // (3 * CHUNK) for d in delta]
    assert (eager[1] > 0) == (mode == "int8")
    eng = engine(True)
    eng.graphs = ChunkGraphs(eng, record=True)
    before = counts()
    _chunks(eng)
    assert [a - b for a, b in zip(counts(), before)] == eager  # the capture's eager step
    graphs = {id(g): g for g, _, _, _ in eng.graphs.log}
    assert len(graphs) == 1 and [int(n) for _, n, _, _ in eng.graphs.log] == [CHUNK] * 3
    top, steps = eng.graphs.kernel_nodes(next(iter(graphs.values())), [
        KERNEL_SYMBOLS[k] for k in ("flash_decode", "fused_norm_matmul", "fused_o_mlp")])
    assert top[:3] == [0, 0, 0] and len(steps) == CHUNK
    assert all(step[:3] == eager for step in steps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_rows_with_pads_match_plain(dtype, int8):
    """Flash-decode at B 4 (0.6B talker heads, 2048 slots), each row with a
    pad of its own, one past ``pos`` (exact zeros): kernel vs plain, float
    and int8 cache, with and without a sliding window."""
    _need_card()
    from qwen3tts_tpu_torch.models.layers import _quantize_rows
    from qwen3tts_tpu_torch.ops import flash_decode as fd

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    L, B, S = 2, 4, 2048
    k = torch.randn((L, B, S, 8, 128), generator=g, device=dev)
    v = torch.randn((L, B, S, 8, 128), generator=g, device=dev)
    q = torch.randn((B, 16, 128), generator=g, device=dev).to(dt)
    if int8:
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
        scales = (ks.transpose(-1, -2).contiguous(), vs.transpose(-1, -2).contiguous())
    else:
        k, v, scales = k.to(dt), v.to(dt), ()
    atol, rtol = TOL[dtype]
    for pos, pads, window in [(300, (0, 17, 250, 301), None), (1500, (3, 0, 1200, 1600), 300),
                              (40, (0, 39, 41, 5), None)]:
        args = (q, k, v, 1, torch.tensor([pos], dtype=torch.int32, device=dev),
                torch.tensor(pads, dtype=torch.int32, device=dev), window, *scales)
        out, ref = fd.flash_decode(*args), fd.flash_decode_plain(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        excess = ((out.float() - ref.float()).abs() - atol - rtol * ref.float().abs()).max()
        assert excess.item() <= 0, (pos, pads, window)
        for b, pad in enumerate(pads):
            if pad > pos:
                assert out[b].abs().max().item() == 0.0
