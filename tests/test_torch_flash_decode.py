"""PyTorch port: flash-decode plain version vs the JAX Pallas kernel
(interpret mode) and its oracle, with a float cache and with an int8 cache
plus per-(slot, head) scales; the kernel's split-K arithmetic (its range
formula, each split's partial softmax state, the merge in split order)
replayed on the CPU; the wrapper's CPU routing and checks.  The CUDA kernel
itself is tested on the card by tests/test_torch_cuda.py.

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


def _split_merge(q, k, v, layer, pos, pads, window, splits, ks=None, vs=None):
    """The CUDA kernel's arithmetic, split by split, in float32 numpy: for
    each row and kv head, every split of the live range (the kernel's range
    formula, ``live_range`` / ``split_range``) gives its (m, l, acc) over its
    own slots (an empty split m = -inf, l = 0), and the splits merge in split
    order: out = sum_s acc_s c_s / max(sum_s l_s c_s, 1e-30), c_s =
    exp(m_s - max_s m_s).  The kernel computes in base 2; the merged value is
    the same function."""
    Bq, NH, D = q.shape
    S, KVH = k.shape[2], k.shape[3]
    G = NH // KVH
    out = np.zeros((Bq, NH, D), np.float32)
    for b in range(Bq):
        lo, hi = fd.live_range(pos, pads[b], window, S)
        for h in range(KVH):
            qg = q[b, h * G:(h + 1) * G].astype(np.float32)
            parts = []
            for sp in range(splits):
                a, e = fd.split_range(lo, hi, sp, splits)
                if a > e:
                    parts.append((np.full(G, -np.inf, np.float32), np.zeros(G, np.float32),
                                  np.zeros((G, D), np.float32)))
                    continue
                kk = k[layer, b, a:e + 1, h].astype(np.float32)
                vv = v[layer, b, a:e + 1, h].astype(np.float32)
                if ks is not None:
                    kk = kk * ks[layer, b, h, a:e + 1][:, None]
                    vv = vv * vs[layer, b, h, a:e + 1][:, None]
                sc = (qg @ kk.T) * np.float32(D ** -0.5)  # [G, n]
                m = sc.max(axis=1)
                p = np.exp(sc - m[:, None])
                parts.append((m, p.sum(axis=1), p @ vv))
            mx = np.max([m for m, _, _ in parts], axis=0)
            num = np.zeros((G, D), np.float32)
            den = np.zeros(G, np.float32)
            for m, l, acc in parts:  # split order
                live = np.isfinite(m)  # an empty split (or row) weighs 0
                c = np.zeros(G, np.float32)
                c[live] = np.exp(m[live] - mx[live])
                num += acc * c[:, None]
                den += l * c
            out[b, h * G:(h + 1) * G] = num / np.maximum(den, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("splits", [1, 3, 16, 64])
@pytest.mark.parametrize("layer,pos,pads,window", CASES)
def test_split_merge_matches_plain_and_jax_kernel(layer, pos, pads, window, splits, int8):
    """Every split of the live range, merged in split order, equals the plain
    version and the JAX kernel (interpret mode): splits = 1, fewer than the
    live slots, more than the live slots (empty splits), and more than S;
    pad > pos gives exact zeros."""
    if int8:
        q, k, v, ks, vs = _int8_inputs(layer * 100 + pos + 2)
        scales = (ks, vs)
        jax_scales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    else:
        q, k, v = _inputs(layer * 100 + pos + 3)
        scales, jax_scales = (), {}
    got = _split_merge(q, k, v, layer, pos, pads, window, splits, *scales)
    plain = _torch_call(fd.flash_decode_plain, q, k, v, layer, pos, pads, window, *scales)
    np.testing.assert_allclose(got, plain, atol=ATOL)
    want = np.asarray(flash_decode_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(layer), jnp.int32(pos),
        jnp.asarray(pads, jnp.int32), block_size=16, sliding_window=window, interpret=True,
        **jax_scales))
    np.testing.assert_allclose(got, want, atol=ATOL)
    for b in range(B):
        if pads[b] > pos:
            assert np.all(got[b] == 0.0)


@pytest.mark.parametrize("splits", [1, 2, 5, 16, 17])
def test_split_range_partitions_the_live_range(splits):
    """The splits of [lo, hi] are consecutive, in order, disjoint, and cover
    it exactly; the live range is the plain version's mask."""
    for lo, hi in [(0, 0), (0, 15), (3, 16), (0, 2047), (100, 40), (7, 300), (1024, 1030)]:
        slots = []
        for sp in range(splits):
            a, e = fd.split_range(lo, hi, sp, splits)
            slots += list(range(a, e + 1))
        assert slots == list(range(lo, hi + 1))
    for pos, pad, window in [(30, 0, None), (30, 50, None), (63, 5, 12), (70, 0, None),
                             (5, 9, 3)]:
        lo, hi = fd.live_range(pos, pad, window, 64)
        idx = np.arange(64)
        mask = (idx <= pos) & (idx >= pad)
        if window is not None:
            mask &= idx > pos - window
        assert list(np.flatnonzero(mask)) == list(range(lo, hi + 1))


def test_num_splits_one_cta_per_sm():
    """About one CTA per SM from S, B, KVH and the SM count, never more than
    the kernel takes: 16 splits at batch 1 on the 0.6B talker (8 kv heads)
    on 132 SMs."""
    assert fd.num_splits(2048, 1, 8, 132) == 16
    assert fd.num_splits(2048, 2, 8, 132) == 8
    assert fd.num_splits(2048, 4, 8, 132) == 4
    assert fd.num_splits(2048, 32, 8, 132) == 1
    assert fd.num_splits(64, 1, 1, 132) == 2  # at least 32 slots a split
    assert fd.num_splits(32, 1, 1, 132) == 1
    assert fd.num_splits(8192, 1, 1, 132) == fd.MAX_SPLITS


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
                                       "matvec", "graph_cond", "w8a8", "routed_experts"}
    assert len(cuda_build.build_key()) == 16


def test_kernel_probe_copies_apply_to_the_shipped_source():
    """tools/kernel_probe.py builds its alternatives by text substitution in
    csrc/flash_decode.cu: each one still finds its place in the source."""
    from qwen3tts_tpu_torch.tools import kernel_probe

    v = kernel_probe._variants()
    assert set(v) == {"base2", "pdl", "stamped", "stream"}
    assert "ex2.approx" in v["base2"] and "expf(" not in v["base2"]
    assert "griddepcontrol.wait" in v["pdl"] and "ProgrammaticStreamSerialization" in v["pdl"]
    assert all(f"stamp({i}" in v["stamped"] for i in range(7))
