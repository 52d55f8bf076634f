"""Tensor-parallel serving on the card (``qwen3tts_tpu_torch/parallel/``).

- Flash-decode at one rank's head count under TP 2 (8 heads over 4 kv
  heads) and TP 4 (4 over 2), float and int8 caches, against its plain
  version.
- Two gloo ranks on the one card run the 0.6B flagship check in float32
  with the int8 cache: greedy tokens equal to the unsharded run, and
  flash-decode's int8 instance launched 28 times a step on each rank.

These need an NVIDIA card and nvcc, and skip elsewhere.  The card's machine
has no JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda_sharding.py -q
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the rank functions' module: spawned ranks import it by name from sys.path
sys.path.insert(0, str(Path(__file__).resolve().parent))
TOL = {"bfloat16": (2e-3, 1.6e-2),  # kernel and plain each round to bf16: 2 ulps of |ref|
       "float32": (1e-5, 0.0)}  # summation order only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("kvh,nh", [(4, 8), (2, 4)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_decode_at_rank_heads(kvh, nh, int8, dtype):
    _need_card()
    from qwen3tts_tpu_torch.models.layers import _quantize_rows
    from qwen3tts_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    L, S, D = 4, 2048, 128
    g = torch.Generator(device=dev).manual_seed(kvh)
    dt = getattr(torch, dtype)
    k = torch.randn((L, 1, S, kvh, D), generator=g, device=dev)
    v = torch.randn((L, 1, S, kvh, D), generator=g, device=dev)
    q = torch.randn((1, nh, D), generator=g, device=dev).to(dt)
    scales = ()
    if int8:
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
        scales = tuple(t.transpose(-1, -2).contiguous() for t in (ks, vs))
    else:
        k, v = k.to(dt), v.to(dt)
    atol, rtol = TOL[dtype]
    before = fd.flash_decode.launches_int8kv if int8 else fd.flash_decode.launches
    cases = [(3, 300, 0, None), (1, 2000, 0, None), (2, 1500, 0, 300), (0, 40, 100, None)]
    for layer, pos, pad, window in cases:
        ints = [torch.tensor([x], dtype=torch.int32, device=dev) for x in (pos, pad)]
        out = fd.flash_decode(q, k, v, layer, *ints, window, *scales)
        ref = fd.flash_decode_plain(q, k, v, layer, *ints, window, *scales)
        diff = (out.float() - ref.float()).abs()
        assert (diff - atol - rtol * ref.float().abs()).max().item() <= 0, (layer, pos, pad)
        if pad > pos:
            assert out.abs().max().item() == 0.0
    after = fd.flash_decode.launches_int8kv if int8 else fd.flash_decode.launches
    assert after - before == len(cases)


@pytest.mark.cuda
def test_two_gloo_ranks_flagship_token_exact():
    _need_card()
    import torch_shard_workers as W

    from qwen3tts_tpu_torch.parallel.sharding import launch

    ids, single, per_rank = launch(W.flagship_gloo, 2, device="cuda", backend="gloo")
    assert ids.shape == (4, 16)
    np.testing.assert_array_equal(ids, single)
    for st in per_rank:
        assert st["eager_step_flash_decode"] == {"flash_decode": 0, "flash_decode_int8kv": 28}
        assert st["flash_decode_launches"]["flash_decode_int8kv"] == 28 * 4
