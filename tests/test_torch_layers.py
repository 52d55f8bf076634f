"""PyTorch port vs the JAX package: rms_norm, MRoPE, block_forward (prefill
and decode, masked and flash paths), sampling and the repetition penalty.

Inputs come from numpy.random.default_rng and go to both packages in
float32.  Tolerance: atol 1e-5 for single ops, 2e-5 for a whole block
(float32 summation order only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.models import layers as JL  # noqa: E402
from qwen3tts_tpu.ops import rope as JR  # noqa: E402
from qwen3tts_tpu.ops import sampling as JS  # noqa: E402
from qwen3tts_tpu_torch.models import layers as TL  # noqa: E402
from qwen3tts_tpu_torch.ops import rope as TR  # noqa: E402
from qwen3tts_tpu_torch.ops import sampling as TS  # noqa: E402

SPEC = dict(num_layers=2, hidden_size=32, num_heads=4, num_kv_heads=2, head_dim=8,
            intermediate_size=64, rms_norm_eps=1e-6)
SECTIONS = (2, 1, 1)


def _np(t):
    return np.asarray(t)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32) * 3
    w = rng.standard_normal(32).astype(np.float32)
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    want = _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("sections", [SECTIONS, None])
def test_rope(sections):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 500, (2, 5))
    cos_t, sin_t = TR.mrope_cos_sin(torch.from_numpy(pos), 8, 1e6, sections)
    cos_j, sin_j = JR.mrope_cos_sin(jnp.asarray(pos), 8, 1e6, sections)
    np.testing.assert_allclose(cos_t.numpy(), _np(cos_j), atol=1e-5)
    np.testing.assert_allclose(sin_t.numpy(), _np(sin_j), atol=1e-5)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    qt, kt = TR.apply_rope(torch.from_numpy(q), torch.from_numpy(k), cos_t, sin_t)
    qj, kj = JR.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j)
    np.testing.assert_allclose(qt.numpy(), _np(qj), atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), _np(kj), atol=1e-5)


def _layer_params(rng):
    H, D, I = 32, 8, 64
    qkv = 4 * D + 2 * 2 * D
    return {
        "input_norm": 1 + 0.1 * rng.standard_normal(H),
        "qkv_proj": rng.standard_normal((H, qkv)) * H ** -0.5,
        "o_proj": rng.standard_normal((4 * D, H)) * (4 * D) ** -0.5,
        "q_norm": 1 + 0.1 * rng.standard_normal(D),
        "k_norm": 1 + 0.1 * rng.standard_normal(D),
        "post_norm": 1 + 0.1 * rng.standard_normal(H),
        "gateup_proj": rng.standard_normal((H, 2 * I)) * H ** -0.5,
        "down_proj": rng.standard_normal((I, H)) * I ** -0.5,
    }


def test_block_forward_prefill_then_decode():
    rng = np.random.default_rng(2)
    p = {k: np.asarray(v, np.float32) for k, v in _layer_params(rng).items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    jspec, tspec = JL.BlockSpec(**SPEC), TL.BlockSpec(**SPEC)
    B, T, S, layer = 2, 6, 16, 1
    pad = np.array([0, 2], np.int32)
    x = rng.standard_normal((B, T, 32)).astype(np.float32)

    kv_j = JL.init_kv_cache(jspec, B, S, jnp.float32)
    kv_t = TL.init_kv_cache(tspec, B, S, torch.float32, "cpu")
    eff = np.maximum(np.arange(T)[None] - pad[:, None], 0)
    cos_j, sin_j = JR.mrope_cos_sin(jnp.asarray(eff), 8, 1e6, SECTIONS)
    cos_t, sin_t = TR.mrope_cos_sin(torch.from_numpy(eff), 8, 1e6, SECTIONS)
    yj, kv_j = JL.block_forward(pj, jnp.asarray(x), cos_j, sin_j, kv_j, jnp.int32(layer),
                                jnp.int32(0), JL.prefill_mask(T, T, jnp.asarray(pad)), jspec)
    yt, kv_t = TL.block_forward(pt, torch.from_numpy(x), cos_t, sin_t, kv_t, layer, 0,
                                TL.prefill_mask(T, T, torch.from_numpy(pad)), tspec)
    np.testing.assert_allclose(yt.numpy(), _np(yj), atol=2e-5)
    np.testing.assert_allclose(kv_t["k"].numpy(), _np(kv_j["k"]), atol=2e-5)
    np.testing.assert_allclose(kv_t["v"].numpy(), _np(kv_j["v"]), atol=2e-5)

    # one decode step at pos T: JAX masked path vs the port's masked and flash paths
    xd = rng.standard_normal((B, 1, 32)).astype(np.float32)
    eff_d = (T - pad)[:, None]
    cos_j, sin_j = JR.mrope_cos_sin(jnp.asarray(eff_d), 8, 1e6, SECTIONS)
    cos_t, sin_t = TR.mrope_cos_sin(torch.from_numpy(eff_d), 8, 1e6, SECTIONS)
    yj, _ = JL.block_forward(pj, jnp.asarray(xd), cos_j, sin_j, kv_j, jnp.int32(layer),
                             jnp.int32(T), JL.decode_mask(S, jnp.int32(T), jnp.asarray(pad)),
                             jspec)
    pos_t = torch.tensor([T], dtype=torch.int32)
    pad_t = torch.from_numpy(pad)
    for flash in (False, True):
        kv_c = {k: v.clone() for k, v in kv_t.items()}
        ctx = {"pos": pos_t, "pad": pad_t, "window": None} if flash else None
        yt, _ = TL.block_forward(pt, torch.from_numpy(xd), cos_t, sin_t, kv_c, layer,
                                 pos_t, TL.decode_mask(S, pos_t, pad_t), tspec,
                                 flash_ctx=ctx)
        np.testing.assert_allclose(yt.numpy(), _np(yj), atol=2e-5, err_msg=f"flash={flash}")


def test_masks():
    pad = np.array([0, 3], np.int32)
    for window in (None, 4):
        np.testing.assert_array_equal(
            TL.prefill_mask(7, 9, torch.from_numpy(pad), window).numpy(),
            _np(JL.prefill_mask(7, 9, jnp.asarray(pad), window)))
        np.testing.assert_array_equal(
            TL.decode_mask(9, torch.tensor([6], dtype=torch.int32),
                           torch.from_numpy(pad), window).numpy(),
            _np(JL.decode_mask(9, jnp.int32(6), jnp.asarray(pad), window)))


def test_greedy_sampling_with_suppression_matches_jax():
    rng = np.random.default_rng(3)
    V, eos = 64, 50
    logits = rng.standard_normal((4, V)).astype(np.float32)
    logits[:, 60] += 10  # a suppressed control id would win
    logits[0, eos] += 20  # EOS wins row 0 unless suppressed
    mask = TS.build_suppress_mask(V, eos, zone=16)
    np.testing.assert_array_equal(mask, JS.build_suppress_mask(V, eos, zone=16))
    se = np.array([False, True, False, True])
    got = TS.sample_logits(None, torch.from_numpy(logits), temperature=1.0, top_k=0,
                           top_p=1.0, do_sample=False,
                           suppress_mask=torch.from_numpy(mask),
                           suppress_eos=torch.from_numpy(se), eos_id=eos).numpy()
    want = _np(JS.sample_logits(None, jnp.asarray(logits), temperature=1.0, top_k=0,
                                top_p=1.0, do_sample=False,
                                suppress_mask=jnp.asarray(mask),
                                suppress_eos=jnp.asarray(se), eos_id=eos))
    np.testing.assert_array_equal(got, want)
    assert got[0] == eos


def _draws(logits_row, n=4000, **kw):
    g = torch.Generator().manual_seed(0)
    logits = torch.from_numpy(np.tile(logits_row, (n, 1)).astype(np.float32))
    return TS.sample_logits(g, logits, do_sample=True, **kw).numpy()


def test_top_k_keeps_ties_at_kth_value():
    row = np.array([0.0, 5.0, 3.0, 3.0, 3.0, -1.0, 1.0, 2.0])
    ids = set(_draws(row, temperature=1.0, top_k=2, top_p=1.0).tolist())
    assert ids == {1, 2, 3, 4}  # the 2nd-largest value is tied three ways


def test_top_p_keeps_the_top_one_and_its_mass():
    row = np.array([0.0, 4.0, 3.5, -2.0, 1.0])
    assert set(_draws(row, temperature=1.0, top_k=0, top_p=0.0).tolist()) == {1}
    assert set(_draws(row, temperature=1.0, top_k=0, top_p=0.97).tolist()) == {1, 2}


def test_sampling_respects_suppression():
    V, eos = 32, 20
    row = np.zeros(V)
    mask = torch.from_numpy(TS.build_suppress_mask(V, eos, zone=16))
    ids = _draws(row, temperature=1.0, top_k=0, top_p=1.0, suppress_mask=mask,
                 suppress_eos=torch.tensor(True), eos_id=eos)
    assert ids.max() < 16 and len(set(ids.tolist())) == 16


def test_gumbel_sampling_follows_the_distribution():
    row = np.log(np.array([0.5, 0.3, 0.2]))
    ids = _draws(row, n=20000, temperature=1.0, top_k=0, top_p=1.0)
    freq = np.bincount(ids, minlength=3) / len(ids)
    np.testing.assert_allclose(freq, [0.5, 0.3, 0.2], atol=0.02)


def test_repetition_penalty():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 16)).astype(np.float32)
    seen = rng.random((2, 16)) < 0.4
    got = TS.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(seen),
                                      1.3).numpy()
    want = _np(JS.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen), 1.3))
    np.testing.assert_allclose(got, want, atol=1e-6)
