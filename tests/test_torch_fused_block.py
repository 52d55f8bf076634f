"""PyTorch port vs the JAX package: the fused block kernels' plain versions
(``ops/fused_block.py``) against the Pallas kernels in interpret mode, the
wrappers' CPU routing and checks, and ``block_forward(fused=True)`` with
plain or int8 weights over a float or int8 KV cache.  The CUDA kernels
themselves are tested on the card by tests/test_torch_cuda.py.

Inputs come from numpy.random.default_rng and go to both packages.
Tolerances: float32 atol 1e-5 (summation order only); bfloat16
``2e-3 + 1.6e-2 * |ref|`` (both round the same intermediates to bf16 and may
land one ulp apart); int8 cache rows bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.models import layers as JL  # noqa: E402
from qwen3tts_tpu.ops import fused_block as JF  # noqa: E402
from qwen3tts_tpu.ops import quant as JQ  # noqa: E402
from qwen3tts_tpu.ops import rope as JR  # noqa: E402
from qwen3tts_tpu_torch.models import layers as TL  # noqa: E402
from qwen3tts_tpu_torch.ops import fused_block as TF  # noqa: E402
from qwen3tts_tpu_torch.ops import rope as TR  # noqa: E402
from qwen3tts_tpu_torch.ops import wstream as WS  # noqa: E402

EPS = 1e-6
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-3, 1.6e-2)}
H, DQ, N, I = 64, 128, 256, 256


def _weight(rng, shape, quantized):
    """A weight as (jax leaf, torch leaf): f32, or int8 from JAX's quantizer."""
    w = (rng.standard_normal(shape) * shape[0] ** -0.5).astype(np.float32)
    if not quantized:
        return w, w
    jq = JQ.quantize_tensor(jnp.asarray(w))
    return jq, {k: torch.from_numpy(np.array(v)) for k, v in jq.items()}


def _pair(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _leaf_pair(leaf_j, leaf_t, dtype):
    if isinstance(leaf_t, dict):
        return leaf_j, leaf_t
    return _pair(leaf_t, dtype)


def _close(got: torch.Tensor, want, dtype: str, what=""):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=what)


CASES = [(B, q, dt) for B in (1, 4) for q in (False, True) for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("B,quantized,dtype", CASES)
def test_norm_matmul_plain_matches_jax_kernel(B, quantized, dtype):
    rng = np.random.default_rng(10 * B + quantized)
    x = rng.standard_normal((B, H)).astype(np.float32)
    nw = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    wj, wt = _leaf_pair(*_weight(rng, (H, N), quantized), dtype)
    (xj, xt), (nj, nt) = _pair(x, dtype), _pair(nw, dtype)
    want = JF.fused_norm_matmul(xj, nj, wj, eps=EPS)
    got = TF.fused_norm_matmul_plain(xt, nt, wt, EPS)
    assert got.dtype == xt.dtype and got.shape == (B, N)
    _close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("B,quantized,dtype", CASES)
def test_o_mlp_plain_matches_jax_kernel(B, quantized, dtype):
    rng = np.random.default_rng(20 * B + quantized)
    x = rng.standard_normal((B, H)).astype(np.float32)
    attn = rng.standard_normal((B, DQ)).astype(np.float32)
    nw = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    ws = [_leaf_pair(*_weight(rng, s, quantized), dtype)
          for s in ((DQ, H), (H, 2 * I), (I, H))]
    (xj, xt), (aj, at), (nj, nt) = _pair(x, dtype), _pair(attn, dtype), _pair(nw, dtype)
    want = JF.fused_o_mlp(xj, aj, ws[0][0], nj, ws[1][0], ws[2][0], eps=EPS)
    got = TF.fused_o_mlp_plain(xt, at, ws[0][1], nt, ws[1][1], ws[2][1], EPS)
    assert got.dtype == xt.dtype and got.shape == (B, H)
    _close(got, want.astype(jnp.float32), dtype)


def test_o_mlp_keeps_x2_in_float32():
    """The fused half adds the MLP to the float32 x2, which the unfused block
    rounds to the model dtype first: in bf16 the two differ."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, H)).astype(np.float32)).bfloat16()
    attn = torch.from_numpy(rng.standard_normal((1, DQ)).astype(np.float32)).bfloat16()
    nw = torch.ones(H, dtype=torch.bfloat16)
    ow, gu, dw = (torch.from_numpy(_weight(rng, s, False)[1]).bfloat16()
                  for s in ((DQ, H), (H, 2 * I), (I, H)))
    x2 = x.float() + attn.float() @ ow.float()
    got = TF.fused_o_mlp_plain(x, attn, ow, nw, gu, dw, EPS)
    h = TF._rms_norm_f32(x2, nw, EPS).bfloat16().float() @ gu.float()
    act = (torch.nn.functional.silu(h[:, :I]) * h[:, I:]).bfloat16().float()
    torch.testing.assert_close(got, (x2 + act @ dw.float()).bfloat16(), atol=0, rtol=0)
    assert not torch.equal(got, (x2.bfloat16().float() + act @ dw.float()).bfloat16())


def test_wrappers_route_cpu_tensors_to_plain():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, H)).astype(np.float32))
    attn = torch.from_numpy(rng.standard_normal((2, DQ)).astype(np.float32))
    nw = torch.ones(H)
    w = _weight(rng, (H, N), True)[1]
    ws = [_weight(rng, s, True)[1] for s in ((DQ, H), (H, 2 * I), (I, H))]
    before = (TF.fused_norm_matmul.launches, TF.fused_o_mlp.launches)
    torch.testing.assert_close(TF.fused_norm_matmul(x, nw, w, EPS),
                               TF.fused_norm_matmul_plain(x, nw, w, EPS), atol=0, rtol=0)
    torch.testing.assert_close(TF.fused_o_mlp(x, attn, ws[0], nw, ws[1], ws[2], EPS),
                               TF.fused_o_mlp_plain(x, attn, ws[0], nw, ws[1], ws[2], EPS),
                               atol=0, rtol=0)
    # the counters count kernel launches only
    assert (TF.fused_norm_matmul.launches, TF.fused_o_mlp.launches) == before


@pytest.mark.parametrize("bad", ["x_rank", "norm_shape", "w_shape", "mixed_quant",
                                 "w8a8_leaf"])
def test_wrappers_reject_bad_inputs(bad):
    rng = np.random.default_rng(5)
    x = torch.zeros((1, H))
    attn = torch.zeros((1, DQ))
    nw = torch.ones(H)
    ws = [_weight(rng, s, True)[1] for s in ((DQ, H), (H, 2 * I), (I, H))]
    w = torch.zeros((H, N))
    with pytest.raises(ValueError):
        if bad == "x_rank":
            TF.fused_norm_matmul(x[0], nw, w)
        elif bad == "norm_shape":
            TF.fused_o_mlp(x, attn, ws[0], nw[:-1], ws[1], ws[2])
        elif bad == "w_shape":
            TF.fused_norm_matmul(x, nw, w[1:])
        elif bad == "mixed_quant":
            TF.fused_o_mlp(x, attn, torch.zeros((DQ, H)), nw, ws[1], ws[2])
        else:
            TF.fused_norm_matmul(x, nw, {"q8": ws[1]["q"], "scale": ws[1]["scale"]})


# (H, Dq, I): the 0.6B talker and predictor, the 1.7B talker, tiny
O_MLP_SHAPES = {"0.6b-talker": (1024, 2048, 3072), "0.6b-predictor": (1024, 1024, 3072),
                "1.7b-talker": (2048, 2048, 6144), "tiny": (64, 64, 128)}
SMS = 132  # the H100's grid: one CTA per SM


def _cover(K, N, geo, grid):
    """How often each (row, column) of a [K, N] phase is taken by the items
    of CTAs 0 .. grid - 1."""
    seen = np.zeros((K, N), np.int32)
    for cta in range(grid):
        item = WS.item_of(cta, K, N, geo)
        if item is not None:
            assert item.cols % WS.VEC == 0 and item.n0 % WS.VEC == 0
            seen[item.k_lo:item.k_hi, item.n0:item.n0 + item.cols] += 1
    return seen


@pytest.mark.parametrize("shape", sorted(O_MLP_SHAPES))
def test_o_mlp_geometry_covers_every_weight_once(shape):
    """One launch on 132 CTAs: the o-projection's items (32-column tiles x
    row splits) take every element of Wo exactly once, the MLP tiles every
    intermediate column once, with at most one item of each per CTA."""
    Hh, Dq, Ii = O_MLP_SHAPES[shape]
    geo_o, geo_mlp = TF.o_mlp_geometry(Hh, Dq, Ii, SMS)
    assert (_cover(Dq, Hh, geo_o, SMS) == 1).all()
    assert WS.num_items(Dq, Hh, geo_o) <= SMS
    assert geo_mlp.splits == 1 and geo_mlp.cols <= TF.MAX_GU_COLS
    assert (_cover(Hh, Ii, geo_mlp, SMS) == 1).all()
    assert WS.num_items(Hh, Ii, geo_mlp) <= SMS


@pytest.mark.parametrize("shape", ["0.6b-talker", "0.6b-predictor"])
def test_o_mlp_geometry_fills_the_card(shape):
    """At the 0.6B shapes both phases give 128 of the 132 CTAs an item: 32
    column tiles x 4 row splits of Wo, and 128 MLP tiles of 24 columns."""
    Hh, Dq, Ii = O_MLP_SHAPES[shape]
    geo_o, geo_mlp = TF.o_mlp_geometry(Hh, Dq, Ii, SMS)
    assert geo_o == WS.Geo(32, 4, Dq // 4)
    assert geo_mlp.cols == 24
    assert WS.num_items(Dq, Hh, geo_o) == WS.num_items(Hh, Ii, geo_mlp) == 128


# (H, N) of the qkv projection: the 0.6B talker and predictor, the 1.7B
# talker, tiny
NORM_MM_SHAPES = {"0.6b-talker": (1024, 4096), "0.6b-predictor": (1024, 2048),
                  "1.7b-talker": (2048, 4096), "tiny": (64, 128)}


@pytest.mark.parametrize("shape", sorted(NORM_MM_SHAPES))
def test_norm_matmul_geometry_covers_every_weight_once(shape):
    """One launch on 132 SMs: column tiles only (nothing crosses the grid),
    a multiple of 8 columns wide, every element of W taken exactly once, at
    most one item per CTA."""
    Hh, Nn = NORM_MM_SHAPES[shape]
    geo = TF.norm_matmul_geometry(Hh, Nn, SMS)
    assert geo.splits == 1 and geo.chunk >= Hh and geo.cols <= TF.MAX_NM_COLS
    assert (_cover(Hh, Nn, geo, SMS) == 1).all()
    assert WS.num_items(Hh, Nn, geo) <= SMS


@pytest.mark.parametrize("shape,cols", [("0.6b-talker", 32), ("0.6b-predictor", 16)])
def test_norm_matmul_geometry_fills_the_card(shape, cols):
    """At the 0.6B shapes 128 of the 132 CTAs hold a tile: 32 columns at the
    talker's N 4096, 16 at the predictor's N 2048 (32-column tiles would
    give the predictor 64)."""
    Hh, Nn = NORM_MM_SHAPES[shape]
    geo = TF.norm_matmul_geometry(Hh, Nn, SMS)
    assert geo.cols == cols
    assert 120 <= WS.num_items(Hh, Nn, geo) <= SMS
    assert sum(WS.item_of(c, Hh, Nn, geo) is not None for c in range(SMS)) >= 120


@pytest.mark.parametrize("rows,row_bytes,stages", [
    (512, 64, 5),     # the 0.6B talker's o-projection item in bf16: one stage
    (1024, 96, 5),    # its gate|up tile: 341 rows a stage, a ragged last stage
    (24, 2048, 5),    # its rows of Wd
    (1024, 48, 2),    # the int8 gate|up tile on a ring of two stages: wraps
    (7, 8192, 2),     # float32 rows of H 2048: four rows a stage
])
def test_stage_schedule_takes_every_row_once(rows, row_bytes, stages):
    sched = WS.stage_schedule([(0, 16), (rows, row_bytes), (0, 16), (rows, row_bytes)], stages,
                              TF.STAGE_BYTES)
    for job in (1, 3):
        mine = [(r0, n) for j, r0, n, _ in sched if j == job]
        assert [r0 for r0, _ in mine] == [sum(n for _, n in mine[:i]) for i in range(len(mine))]
        assert sum(n for _, n in mine) == rows
        assert all(0 < n * row_bytes <= TF.STAGE_BYTES for _, n in mine)
    assert [slot for *_, slot in sched] == [i % stages for i in range(len(sched))]
    assert {j for j, *_ in sched} == {1, 3}  # jobs without rows take no stage


@pytest.mark.parametrize("B,quantized,dtype", CASES)
def test_o_mlp_in_kernel_order_matches_jax_kernel(B, quantized, dtype):
    """The plain version with its cross-CTA sums in the CUDA kernel's order
    (row splits of the o-projection in split order, the down projection's
    per-tile partial sums lane by lane and then in a butterfly) against the
    Pallas kernel in interpret mode: the same tolerance as the plain order,
    and within float32 summation error (1e-5) of it in float32."""
    rng = np.random.default_rng(30 * B + quantized)
    x = rng.standard_normal((B, H)).astype(np.float32)
    attn = rng.standard_normal((B, DQ)).astype(np.float32)
    nw = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    ws = [_leaf_pair(*_weight(rng, s, quantized), dtype)
          for s in ((DQ, H), (H, 2 * I), (I, H))]
    (xj, xt), (aj, at), (nj, nt) = _pair(x, dtype), _pair(attn, dtype), _pair(nw, dtype)
    geo = TF.o_mlp_geometry(H, DQ, I, SMS)
    assert geo[0].splits == 2 and WS.num_items(H, I, geo[1]) == 32  # sums to reorder
    want = JF.fused_o_mlp(xj, aj, ws[0][0], nj, ws[1][0], ws[2][0], eps=EPS)
    got = TF.fused_o_mlp_plain(xt, at, ws[0][1], nt, ws[1][1], ws[2][1], EPS, geo=geo)
    assert got.dtype == xt.dtype and got.shape == (B, H)
    _close(got, want.astype(jnp.float32), dtype)
    if dtype == "float32":
        plain = TF.fused_o_mlp_plain(xt, at, ws[0][1], nt, ws[1][1], ws[2][1], EPS)
        torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)


def test_tile_sum_is_the_sum():
    parts = torch.from_numpy(np.random.default_rng(6).standard_normal((70, 2, 5)))
    torch.testing.assert_close(TF.tile_sum(parts), parts.sum(0), atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# block_forward with fused=True

SPEC = dict(num_layers=2, hidden_size=H, num_heads=4, num_kv_heads=2, head_dim=16,
            intermediate_size=I // 2, rms_norm_eps=EPS)


def _layer(rng, quantized):
    Hh, D, Ii = H, 16, I // 2
    pj, pt = {}, {}
    for name, shape in (("qkv_proj", (Hh, 4 * D + 2 * 2 * D)), ("o_proj", (4 * D, Hh)),
                        ("gateup_proj", (Hh, 2 * Ii)), ("down_proj", (Ii, Hh))):
        pj[name], pt[name] = _weight(rng, shape, quantized)
        if not quantized:
            pj[name], pt[name] = jnp.asarray(pt[name]), torch.from_numpy(pt[name])
    for name, n in (("input_norm", Hh), ("q_norm", D), ("k_norm", D), ("post_norm", Hh)):
        a = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
        pj[name], pt[name] = jnp.asarray(a), torch.from_numpy(a)
    return pj, pt


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_block_forward_fused_matches_jax(quantized, kv_quant):
    """Prefill (unfused, as in both packages) then one fused decode step of
    layer 1, float32: the port's masked and flash paths against the JAX
    block's masked path."""
    rng = np.random.default_rng(30 + 2 * quantized + kv_quant)
    pj, pt = _layer(rng, quantized)
    jspec, tspec = JL.BlockSpec(**SPEC), TL.BlockSpec(**SPEC)
    B, T, S, layer = 2, 6, 16, 1
    pad = np.array([0, 2], np.int32)
    sections = (4, 2, 2)
    x = rng.standard_normal((B, T, H)).astype(np.float32)

    kv_j = JL.init_kv_cache(jspec, B, S, jnp.float32, kv_quant=kv_quant)
    kv_t = TL.init_kv_cache(tspec, B, S, torch.float32, "cpu", kv_quant=kv_quant)
    eff = np.maximum(np.arange(T)[None] - pad[:, None], 0)
    cj, sj = JR.mrope_cos_sin(jnp.asarray(eff), 16, 1e6, sections)
    ct, st = TR.mrope_cos_sin(torch.from_numpy(eff), 16, 1e6, sections)
    _, kv_j = JL.block_forward(pj, jnp.asarray(x), cj, sj, kv_j, jnp.int32(layer),
                               jnp.int32(0), JL.prefill_mask(T, T, jnp.asarray(pad)), jspec)
    _, kv_t = TL.block_forward(pt, torch.from_numpy(x), ct, st, kv_t, layer, 0,
                               TL.prefill_mask(T, T, torch.from_numpy(pad)), tspec)

    xd = rng.standard_normal((B, 1, H)).astype(np.float32)
    eff_d = (T - pad)[:, None]
    cj, sj = JR.mrope_cos_sin(jnp.asarray(eff_d), 16, 1e6, sections)
    ct, st = TR.mrope_cos_sin(torch.from_numpy(eff_d), 16, 1e6, sections)
    yj, kv_j = JL.block_forward(pj, jnp.asarray(xd), cj, sj, kv_j, jnp.int32(layer),
                                jnp.int32(T), JL.decode_mask(S, jnp.int32(T), jnp.asarray(pad)),
                                jspec, fused=True)
    kv_j = jax.tree.map(np.asarray, kv_j)
    pos_t, pad_t = torch.tensor([T], dtype=torch.int32), torch.from_numpy(pad)
    for flash in (False, True):
        kv_c = {k: v.clone() for k, v in kv_t.items()}
        ctx = {"pos": pos_t, "pad": pad_t, "window": None} if flash else None
        yt, kv_c = TL.block_forward(pt, torch.from_numpy(xd), ct, st, kv_c, layer, pos_t,
                                    TL.decode_mask(S, pos_t, pad_t), tspec, flash_ctx=ctx,
                                    fused=True)
        msg = f"flash={flash}"
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, err_msg=msg)
        assert set(kv_c) == set(kv_j)
        for key in kv_c:
            if kv_quant and key in ("k", "v"):
                assert kv_c[key].dtype == torch.int8
                np.testing.assert_array_equal(kv_c[key].numpy(), kv_j[key], err_msg=msg)
            else:
                np.testing.assert_allclose(kv_c[key].numpy(), kv_j[key], atol=1e-5,
                                           err_msg=f"{key} {msg}")


def test_block_forward_gates_fusion_like_jax():
    """Fused only for B * Tq <= 32: a 33-row call takes the unfused path
    (on the CPU both give the same numbers; the gate is what is checked)."""
    rng = np.random.default_rng(40)
    _, pt = _layer(rng, True)
    spec = TL.BlockSpec(**SPEC)
    calls = []
    orig = TL.fused_norm_matmul
    TL.fused_norm_matmul = lambda *a, **k: calls.append(a[0].shape) or orig(*a, **k)
    try:
        for B in (32, 33):
            kv = TL.init_kv_cache(spec, B, 4, torch.float32, "cpu")
            cos = torch.ones((B, 1, 16))
            sin = torch.zeros((B, 1, 16))
            pos = torch.tensor([0], dtype=torch.int32)
            TL.block_forward(pt, torch.zeros((B, 1, H)), cos, sin, kv, 0, pos,
                             TL.decode_mask(4, pos, torch.zeros(B, dtype=torch.int32)),
                             spec, fused=True)
    finally:
        TL.fused_norm_matmul = orig
    assert calls == [(32, H)]
