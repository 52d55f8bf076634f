"""PyTorch port: flash-decode plain version vs the JAX Pallas kernel
(interpret mode) and its oracle, with a float cache and with an int8 cache
plus per-(slot, head) scales; the wrapper's CPU routing and checks.  The
CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.

Inputs come from numpy.random.default_rng and go to both packages.
Tolerance: float32 throughout on the CPU, atol 1e-5 (summation order only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.models.layers import _quantize_rows  # noqa: E402
from qwen3tts_tpu.ops.flash_decode import (  # noqa: E402
    flash_decode_reference,
    flash_decode_stacked,
)
from qwen3tts_tpu_torch.ops import cuda_build  # noqa: E402
from qwen3tts_tpu_torch.ops import flash_decode as fd  # noqa: E402

ATOL = 1e-5
L, B, S, KVH, G, D = 3, 2, 64, 2, 2, 16
NH = KVH * G


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NH, D)).astype(np.float32)
    k = rng.standard_normal((L, B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((L, B, S, KVH, D)).astype(np.float32)
    return q, k, v


def _int8_inputs(seed):
    """q, and an int8 cache with f32 scales [L, B, KVH, S], quantized per
    (slot, head) as the cache write does (JAX ``layers._quantize_rows``)."""
    q, k, v = _inputs(seed)
    kq, ks = (np.array(a) for a in _quantize_rows(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in _quantize_rows(jnp.asarray(v)))
    return q, kq, vq, np.ascontiguousarray(ks.transpose(0, 1, 3, 2)), \
        np.ascontiguousarray(vs.transpose(0, 1, 3, 2))


def _torch_call(fn, q, k, v, layer, pos, pads, window, *scales):
    return fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), layer,
              torch.tensor([pos], dtype=torch.int32),
              torch.tensor(pads, dtype=torch.int32), window,
              *(torch.from_numpy(s) for s in scales)).numpy()


# (layer, pos, per-row pads, window)
CASES = [
    (0, 0, [0, 0], None),
    (1, 15, [0, 3], None),
    (2, 16, [5, 0], None),  # pos at a tile edge (block 16)
    (1, 63, [0, 40], None),  # pos = S - 1
    (0, 30, [0, 50], None),  # row 1: pad > pos -> zeros
    (2, 50, [0, 7], 12),  # sliding window
]


@pytest.mark.parametrize("layer,pos,pads,window", CASES)
def test_plain_matches_jax_kernel_and_oracle(layer, pos, pads, window):
    q, k, v = _inputs(layer * 100 + pos)
    got = _torch_call(fd.flash_decode_plain, q, k, v, layer, pos, pads, window)
    want = np.asarray(flash_decode_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(layer),
        jnp.int32(pos), jnp.asarray(pads, jnp.int32), block_size=16,
        sliding_window=window, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)
    for b in range(B):
        if pads[b] > pos:
            assert np.all(got[b] == 0.0)  # no live slot: exact zeros, not NaN
            continue
        ref = np.asarray(flash_decode_reference(
            jnp.asarray(q[b]), jnp.asarray(k[layer, b]), jnp.asarray(v[layer, b]),
            pos, pads[b], sliding_window=window))
        np.testing.assert_allclose(got[b], ref, atol=ATOL)


@pytest.mark.parametrize("layer,pos,pads,window", CASES)
def test_plain_int8_cache_matches_jax_kernel(layer, pos, pads, window):
    q, kq, vq, ks, vs = _int8_inputs(layer * 100 + pos + 1)
    got = _torch_call(fd.flash_decode_plain, q, kq, vq, layer, pos, pads, window, ks, vs)
    want = np.asarray(flash_decode_stacked(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.int32(layer),
        jnp.int32(pos), jnp.asarray(pads, jnp.int32), block_size=16,
        sliding_window=window, interpret=True, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    for b in range(B):
        if pads[b] > pos:
            assert np.all(got[b] == 0.0)
    # the same as attending over the float32 dequantized cache
    kf = kq.astype(np.float32) * ks.transpose(0, 1, 3, 2)[..., None]
    vf = vq.astype(np.float32) * vs.transpose(0, 1, 3, 2)[..., None]
    np.testing.assert_allclose(
        got, _torch_call(fd.flash_decode_plain, q, kf, vf, layer, pos, pads, window),
        atol=ATOL)


def test_wrapper_routes_int8_cache_to_plain():
    q, kq, vq, ks, vs = _int8_inputs(9)
    before = (fd.flash_decode.launches, fd.flash_decode.launches_int8kv)
    got = _torch_call(fd.flash_decode, q, kq, vq, 1, 40, [0, 3], None, ks, vs)
    want = _torch_call(fd.flash_decode_plain, q, kq, vq, 1, 40, [0, 3], None, ks, vs)
    np.testing.assert_array_equal(got, want)
    assert (fd.flash_decode.launches, fd.flash_decode.launches_int8kv) == before


@pytest.mark.parametrize("bad", ["scale_without_int8", "int8_without_scale",
                                 "one_scale", "scale_shape", "scale_dtype"])
def test_wrapper_rejects_bad_scales(bad):
    q, kq, vq, ks, vs = (torch.from_numpy(a) for a in _int8_inputs(4))
    k = v = torch.zeros(kq.shape)
    pos = torch.tensor([5], dtype=torch.int32)
    pad = torch.zeros((B,), dtype=torch.int32)
    args = {"scale_without_int8": (k, v, ks, vs), "int8_without_scale": (kq, vq, None, None),
            "one_scale": (kq, vq, ks, None), "scale_shape": (kq, vq, ks[..., :-1], vs),
            "scale_dtype": (kq, vq, ks.double(), vs)}[bad]
    with pytest.raises(ValueError):
        fd.flash_decode(q, args[0], args[1], 0, pos, pad, None, args[2], args[3])


def test_plain_ignores_stale_slots():
    """Slots outside [pad, pos] (stale rows of a reused static cache) do not
    change the result."""
    q, k, v = _inputs(7)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 40:] = 1e4
    v2[:, :, 40:] = -1e4
    k2[:, 1, :2] = 1e4  # row 1's left pad
    a = _torch_call(fd.flash_decode_plain, q, k, v, 1, 39, [0, 2], None)
    b = _torch_call(fd.flash_decode_plain, q, k2, v2, 1, 39, [0, 2], None)
    np.testing.assert_allclose(a, b, atol=ATOL)


def test_wrapper_routes_cpu_tensors_to_plain():
    q, k, v = _inputs(3)
    before = fd.flash_decode.launches
    got = _torch_call(fd.flash_decode, q, k, v, 2, 33, [1, 4], None)
    want = _torch_call(fd.flash_decode_plain, q, k, v, 2, 33, [1, 4], None)
    np.testing.assert_array_equal(got, want)
    assert fd.flash_decode.launches == before  # the counter counts kernel launches only


@pytest.mark.parametrize("bad", ["q_rank", "head_dim", "layer", "pad_shape"])
def test_wrapper_rejects_bad_shapes(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(4))
    pos = torch.tensor([5], dtype=torch.int32)
    pad = torch.zeros((B,), dtype=torch.int32)
    layer = 0
    if bad == "q_rank":
        q = q[0]
    elif bad == "head_dim":
        q = q[..., :8]
    elif bad == "layer":
        layer = L
    else:
        pad = torch.zeros((B + 1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, v, layer, pos, pad)


def test_kernel_geometry_and_build_flags():
    assert fd.kernel_supports(128, 16, 8)  # the 0.6B and 1.7B talkers
    assert not fd.kernel_supports(64, 16, 8) and not fd.kernel_supports(128, 16, 4)
    assert not fd.kernel_supports(16, 4, 2)  # tiny preset: the wrapper raises on the card
    for name, source in cuda_build.SOURCES.items():
        cmd = cuda_build.nvcc_command("nvcc", cuda_build.BUILD_DIR / f"lib{name}.so", source)
        assert "arch=compute_90a,code=sm_90a" in cmd and str(source) in cmd
        assert source.exists()
    assert set(cuda_build.SOURCES) == {"flash_decode", "fused_block", "predictor_step",
                                       "matvec"}
    assert len(cuda_build.build_key()) == 16
