"""PyTorch port vs the JAX package: the whole-micro-step kernel's plain
version (``ops/predictor_step.py``) against the Pallas kernel
``qwen3tts_tpu/ops/predictor_step.py:fused_micro_step`` in interpret mode,
``predict_frame(micro_kernel=True)`` against the JAX package's, its gate,
and the wrapper's CPU routing and checks.  The CUDA kernel itself is tested
on the card by tests/test_torch_cuda.py.

Inputs come from numpy.random.default_rng and go to both packages; weights
cross by ``bundle_from_jax_numpy``, and both sides get the same rope rows.
Tolerances: float32 atol 1e-5 (summation order only); bfloat16
``2e-3 + 1.6e-2 * |ref|``, 2 bf16 ulps of |ref| (both round the same
activations to bf16 and may land one ulp apart).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes; several xdist workers share the host

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.models import predictor as JP  # noqa: E402
from qwen3tts_tpu.ops import predictor_step as JS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models import layers as TL  # noqa: E402
from qwen3tts_tpu_torch.models import predictor as TP  # noqa: E402
from qwen3tts_tpu_torch.ops import predictor_step as TS  # noqa: E402
from qwen3tts_tpu_torch.ops.quant import quantize_bundle  # noqa: E402

TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-3, 1.6e-2)}
TILINGS = [(512, 8), (16, 2)]  # tests/test_predictor_step.py: one tile, and many


def _numpy_params(tiny_cfg, seed=0):
    """Predictor params as numpy, with norm weights and the proj bias moved
    off 1 / 0 so that a misplaced norm or bias shows."""
    pcfg, Ht = tiny_cfg.predictor, tiny_cfg.talker.hidden_size
    tree = jax.tree.map(np.asarray, JP.init_params(jax.random.PRNGKey(seed), pcfg, Ht,
                                                   jnp.float32))
    rng = np.random.default_rng(seed)

    def jitter(a, base):
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    blocks = dict(tree["blocks"])
    for k in ("input_norm", "post_norm", "q_norm", "k_norm"):
        blocks[k] = jitter(blocks[k], 1.0)
    return {**tree, "blocks": blocks, "final_norm": jitter(tree["final_norm"], 1.0),
            "small_to_mtp": {"w": tree["small_to_mtp"]["w"],
                             "b": jitter(tree["small_to_mtp"]["b"], 0.0)}}


def _both(tiny_cfg, tree, dtype):
    """(JAX params, port params) of one numpy tree in ``dtype``."""
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(getattr(jnp, dtype)), tree)
    tparams = bundle_from_jax_numpy({"predictor": tree}, get_preset("tiny"),
                                    getattr(torch, dtype), "cpu")["predictor"]
    return jparams, tparams


def _rope(pcfg, pos):
    cos, sin = JP._rope(pcfg, jnp.full((1, 1), pos, jnp.int32))
    return cos[0, 0], sin[0, 0]


def _jax_step(jparams, pcfg, x, kk, vv, pos, tile, hpt):
    hm = JS.relayout_micro_kernel_weights(
        jparams["blocks"], jparams["small_to_mtp"]["b"], jparams["final_norm"],
        pcfg.head_dim, pcfg.num_key_value_heads, tile=tile, hpt=hpt)
    cos, sin = _rope(pcfg, pos)
    return JS.fused_micro_step(hm, jparams["small_to_mtp"]["w"], x, cos, sin, kk, vv,
                               jnp.int32(pos), eps=pcfg.rms_norm_eps, interpret=True,
                               tile=tile, hpt=hpt)


def _port_step(w, pcfg, x, kk, vv, pos, plain=True):
    cos, sin = (torch.from_numpy(np.array(a)) for a in _rope(pcfg, pos))
    fn = TS.fused_micro_step_plain if plain else TS.fused_micro_step
    return fn(w, x, cos, sin, kk, vv, torch.tensor([pos], dtype=torch.int32),
              pcfg.rms_norm_eps)


def _close(got: torch.Tensor, want, dtype: str, what=""):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=what)


def _caches(pcfg, rng, dtype):
    """A [L, S, KVH, D] cache with slots 0..1 filled, as after the prefill."""
    L, S = pcfg.num_hidden_layers, pcfg.max_seq
    shape = (L, S, pcfg.num_key_value_heads, pcfg.head_dim)
    k, v = (np.zeros(shape, np.float32) for _ in range(2))
    k[:, :2], v[:, :2] = (rng.standard_normal((2, L, 2) + shape[2:]).astype(np.float32))
    return [(jnp.asarray(a).astype(getattr(jnp, dtype)),
             torch.from_numpy(a).to(getattr(torch, dtype))) for a in (k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile,hpt", TILINGS)
def test_plain_micro_step_matches_jax_kernel(tiny_cfg, dtype, tile, hpt):
    pcfg, Ht = tiny_cfg.predictor, tiny_cfg.talker.hidden_size
    jparams, tparams = _both(tiny_cfg, _numpy_params(tiny_cfg), dtype)
    rng = np.random.default_rng(1)
    (kj, kt), (vj, vt) = _caches(pcfg, rng, dtype)
    x = rng.standard_normal((1, Ht)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))
    hj, kj, vj = _jax_step(jparams, pcfg, xj, kj, vj, 2, tile, hpt)
    ht, kt2, vt2 = _port_step(TS.micro_step_weights(tparams), pcfg, xt, kt, vt, 2)
    assert ht.dtype == xt.dtype and ht.shape == (1, pcfg.hidden_size)
    assert kt2 is kt and vt2 is vt  # written in place
    _close(ht, hj.astype(jnp.float32), dtype, "h")
    _close(kt, kj.astype(jnp.float32), dtype, "kv_k")
    _close(vt, vj.astype(jnp.float32), dtype, "kv_v")


def test_plain_micro_step_chain_matches_jax_kernel(tiny_cfg):
    """Three micro-steps from an empty cache (pos 0, 1, 2), the multi-tile
    JAX schedule: h at each step and the whole cache after."""
    pcfg, Ht = tiny_cfg.predictor, tiny_cfg.talker.hidden_size
    jparams, tparams = _both(tiny_cfg, _numpy_params(tiny_cfg, seed=2), "float32")
    w = TS.micro_step_weights(tparams)
    shape = (pcfg.num_hidden_layers, pcfg.max_seq, pcfg.num_key_value_heads,
             pcfg.head_dim)
    kj = vj = jnp.zeros(shape, jnp.float32)
    kt, vt = torch.zeros(shape), torch.zeros(shape)
    rng = np.random.default_rng(3)
    for pos in range(3):
        x = rng.standard_normal((1, Ht)).astype(np.float32) * 0.5
        hj, kj, vj = _jax_step(jparams, pcfg, jnp.asarray(x), kj, vj, pos, 16, 2)
        ht, kt, vt = _port_step(w, pcfg, torch.from_numpy(x), kt, vt, pos)
        _close(ht, hj, "float32", f"h at pos {pos}")
    _close(kt, kj, "float32", "kv_k")
    _close(vt, vj, "float32", "kv_v")
    assert not kt[:, 3:].any() and not vt[:, 3:].any()


def test_residual_stays_float32(tiny_cfg):
    """In bf16 the micro-step keeps the residual in float32 and does not
    round q or the probabilities: its result differs from the default path
    (proj + stack_forward + rms_norm, which rounds them) and equals JAX's
    kernel."""
    pcfg, Ht = tiny_cfg.predictor, tiny_cfg.talker.hidden_size
    jparams, tparams = _both(tiny_cfg, _numpy_params(tiny_cfg, seed=4), "bfloat16")
    rng = np.random.default_rng(5)
    (kj, kt), (vj, vt) = _caches(pcfg, rng, "bfloat16")
    x = torch.from_numpy(rng.standard_normal((1, Ht)).astype(np.float32)).bfloat16()
    hj, _, _ = _jax_step(jparams, pcfg, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                         kj, vj, 2, 512, 8)
    h, _, _ = _port_step(TS.micro_step_weights(tparams), pcfg, x, kt.clone(), vt.clone(), 2)
    _close(h, hj.astype(jnp.float32), "bfloat16")

    spec = TP.block_spec(pcfg)
    kv = {"k": kt.clone()[:, None], "v": vt.clone()[:, None]}
    cos, sin = TP._rope(pcfg, torch.full((1, 1), 2))
    pos = torch.tensor([2], dtype=torch.int32)
    y, _ = TL.stack_forward(tparams["blocks"], TP._proj(tparams, x)[:, None], cos, sin, kv,
                            pos, TL.decode_mask(pcfg.max_seq, pos, torch.zeros(1, dtype=torch.int32)),
                            spec)
    y = TL.rms_norm(y, tparams["final_norm"], pcfg.rms_norm_eps)[:, 0]
    assert not torch.equal(h, y)
    assert (h.float() - y.float()).abs().max().item() > 1e-2


def _permuted(w, rng):
    """The weights with the talker-space, hidden and intermediate units
    permuted: the same function, summed in another order."""
    Ht, Hp = w["proj_w"].shape
    I = w["dn"].shape[1]
    pt, ph, pi = (torch.from_numpy(rng.permutation(n)) for n in (Ht, Hp, I))
    gu_cols = torch.cat([pi, I + pi])
    return {"proj_w": w["proj_w"][pt][:, ph], "proj_b": w["proj_b"][ph],
            "in_norm": w["in_norm"][:, ph], "post_norm": w["post_norm"][:, ph],
            "q_norm": w["q_norm"], "k_norm": w["k_norm"], "final_norm": w["final_norm"][ph],
            "qkv": w["qkv"][:, ph], "o": w["o"][:, :, ph],
            "gu": w["gu"][:, ph][:, :, gu_cols], "dn": w["dn"][:, pi][:, :, ph]}, pt, ph


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_micro_step_summation_order_spread(dtype):
    """The reason for the card's bf16 micro-step tolerance (4e-2 + 1.6e-2 *
    |ref|): every phase rounds its activations to bf16, so the same function
    summed in another order (hidden and intermediate units permuted) moves
    bf16 outputs by a few ulps after 5 layers; float32 stays within 1e-5.
    Width 256, the predictor's head layout, 5 layers, 4 steps."""
    dt = getattr(torch, dtype)
    pcfg = dataclasses.replace(get_preset("qwen3-tts-0.6b").predictor, hidden_size=256,
                               num_attention_heads=4, num_key_value_heads=2,
                               intermediate_size=768)
    g = torch.Generator().manual_seed(5)
    p = TP.init_params(g, pcfg, 256, dt, "cpu")
    for k in ("input_norm", "post_norm", "q_norm", "k_norm"):
        p["blocks"][k] = (1 + 0.1 * torch.randn(p["blocks"][k].shape, generator=g)).to(dt)
    w = TS.micro_step_weights(p)
    wp, pt, ph = _permuted(w, np.random.default_rng(0))
    shape = (5, pcfg.max_seq, 2, 64)
    kk, vv = torch.zeros(shape, dtype=dt), torch.zeros(shape, dtype=dt)
    spread = 0.0
    for i in range(4):
        x = (0.5 * torch.randn((1, 256), generator=g)).to(dt)
        pos = torch.tensor([2 + i], dtype=torch.int32)
        cos, sin = (t[0, 0] for t in TP._rope(pcfg, pos.reshape(1, 1)))
        hq, _, _ = TS.fused_micro_step_plain(wp, x[:, pt], cos, sin, kk.clone(), vv.clone(),
                                             pos)
        h, kk, vv = TS.fused_micro_step_plain(w, x, cos, sin, kk, vv, pos)
        d = (hq[:, torch.argsort(ph)].float() - h.float()).abs()
        atol, rtol = (4e-2, 1.6e-2) if dtype == "bfloat16" else TOL["float32"]
        assert (d <= atol + rtol * h.float().abs()).all()
        spread = max(spread, d.max().item())
    assert spread > 0  # a different order does change the sums


@pytest.fixture(scope="module")
def frame_setup(tiny_cfg):
    tree = _numpy_params(tiny_cfg, seed=6)
    tree["lm_heads"] = tree["lm_heads"] * 4.0  # spread the logits: a clear argmax
    jparams, tparams = _both(tiny_cfg, tree, "float32")
    pin = np.random.default_rng(7).standard_normal(
        (1, 2, tiny_cfg.talker.hidden_size)).astype(np.float32)
    return jparams, tparams, pin


def test_greedy_frame_tokens_equal_jax(tiny_cfg, frame_setup):
    """Greedy predict_frame(micro_kernel=True): the JAX package (Pallas
    kernel in interpret mode) and the port (plain version on the CPU) give
    the same 15 tokens; embed_sum within 1e-5 (float32 sums of 15 rows)."""
    jparams, tparams, pin = frame_setup
    pcfg = tiny_cfg.predictor
    jt, je = JP.predict_frame(jparams, pcfg, jnp.asarray(pin), jax.random.PRNGKey(0),
                              JP.SamplingPolicy(do_sample=False), micro_kernel=True)
    pcfg_t = get_preset("tiny").predictor
    tt, te = TP.predict_frame(tparams, pcfg_t, torch.from_numpy(pin), None,
                              TP.SamplingPolicy(do_sample=False), micro_kernel=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5)
    # the default path gives the same greedy tokens on this float32 model
    td, _ = TP.predict_frame(tparams, pcfg_t, torch.from_numpy(pin), None,
                             TP.SamplingPolicy(do_sample=False))
    np.testing.assert_array_equal(td.numpy(), tt.numpy())


@pytest.mark.parametrize("case", ["batch2", "sliding", "int8", "taken"])
def test_frame_gates_micro_kernel_like_jax(frame_setup, monkeypatch, case):
    """The one gate (``micro_kernel_misfit``): batch 1 and batch 2 with plain
    weights take the micro-step 14 times, for all rows at once; a sliding
    window or int8 blocks make ``micro_kernel=True`` raise, naming why.  On
    the CPU no kernel launches: the launch counter stays 0."""
    _, tparams, pin = frame_setup
    pcfg = get_preset("tiny").predictor
    x = torch.from_numpy(pin)
    if case == "batch2":
        x = torch.cat([x, x])
    elif case == "sliding":
        pcfg = dataclasses.replace(pcfg, sliding_window=4)
    elif case == "int8":
        tparams = quantize_bundle({"predictor": tparams}, "int8-predictor")["predictor"]
    calls = []
    monkeypatch.setattr(TP, "fused_micro_step",
                        lambda *a, **k: calls.append(a[1].shape) or TS.fused_micro_step(*a, **k))
    before = TS.fused_micro_step.launches

    def frame():
        return TP.predict_frame(tparams, pcfg, x, None, TP.SamplingPolicy(do_sample=False),
                                micro_kernel=True)

    if case in ("sliding", "int8"):
        with pytest.raises(ValueError, match="sliding window" if case == "sliding"
                           else "quantized"):
            frame()
        assert not calls
    else:
        toks, emb = frame()
        assert toks.shape == (x.shape[0], 15) and emb.shape == (x.shape[0], 1, x.shape[2])
        assert calls == [(x.shape[0], x.shape[2])] * 14
    assert TS.fused_micro_step.launches == before == 0


@pytest.mark.parametrize("rows", [2, 4, 16])
def test_plain_micro_step_rows_equal_single_rows(tiny_cfg, rows):
    """The plain micro-step of R rows (a cache [L, R, S, KVH, D]) equals R
    one-row calls bit for bit in float32, h and every row's cache."""
    pcfg = tiny_cfg.predictor
    w, _, cos, sin, _, _, pos = _tiny_step_inputs(tiny_cfg)
    g = torch.Generator().manual_seed(rows)
    L, S, KVH, D = (pcfg.num_hidden_layers, pcfg.max_seq, pcfg.num_key_value_heads,
                    pcfg.head_dim)
    k, v = (torch.zeros((L, rows, S, KVH, D)) for _ in range(2))
    k[:, :, :2], v[:, :, :2] = (torch.randn((L, rows, 2, KVH, D), generator=g)
                                for _ in range(2))
    x = torch.randn((rows, w["proj_w"].shape[0]), generator=g)
    k1, v1 = k.clone(), v.clone()
    h, kk, vv = TS.fused_micro_step(w, x, cos, sin, k, v, pos)
    assert kk is k and vv is v and h.shape == (rows, w["proj_w"].shape[1])
    for r in range(rows):
        kr, vr = k1[:, r].clone(), v1[:, r].clone()
        hr, _, _ = TS.fused_micro_step_plain(w, x[r:r + 1], cos, sin, kr, vr, pos)
        assert torch.equal(h[r:r + 1], hr)
        assert torch.equal(k[:, r], kr) and torch.equal(v[:, r], vr)
    assert not torch.equal(h[0], h[1])  # the rows are not one row repeated


@pytest.mark.parametrize("batch", [2, 3, 4])
def test_greedy_micro_frame_rows_equal_their_batch_1_frames(tiny_cfg, frame_setup, batch):
    """Greedy predict_frame(micro_kernel=True) at B 2-4 gives each row the
    tokens of its own B 1 micro frame and of the JAX package's B 1 micro
    frame (Pallas kernel in interpret mode) for that row's input."""
    jparams, tparams, pin = frame_setup
    pcfg_t = get_preset("tiny").predictor
    rng = np.random.default_rng(batch)
    pins = np.concatenate(
        [pin] + [rng.standard_normal(pin.shape).astype(np.float32) for _ in range(batch - 1)])
    greedy = TP.SamplingPolicy(do_sample=False)
    toks, emb = TP.predict_frame(tparams, pcfg_t, torch.from_numpy(pins), None, greedy,
                                 micro_kernel=True)
    assert toks.shape == (batch, 15)
    for r in range(batch):
        one, one_emb = TP.predict_frame(tparams, pcfg_t, torch.from_numpy(pins[r:r + 1]), None,
                                        greedy, micro_kernel=True)
        np.testing.assert_array_equal(toks[r:r + 1].numpy(), one.numpy(), err_msg=f"row {r}")
        assert torch.equal(emb[r:r + 1], one_emb)
        jt, _ = JP.predict_frame(jparams, tiny_cfg.predictor, jnp.asarray(pins[r:r + 1]),
                                 jax.random.PRNGKey(0), JP.SamplingPolicy(do_sample=False),
                                 micro_kernel=True)
        np.testing.assert_array_equal(toks[r:r + 1].numpy(), np.asarray(jt),
                                      err_msg=f"row {r} against JAX")
    assert len({tuple(t) for t in toks.tolist()}) > 1  # the rows differ


@pytest.mark.parametrize("case", ["cpu", "rows", "int8", "sliding", "group", "ok"])
def test_micro_kernel_misfit_is_the_one_gate(frame_setup, case):
    """``micro_kernel_misfit``: with a device it refuses CPU tensors and more
    than 16 rows; with or without one, quantized blocks, a sliding window
    and a tp group; a plain frame of at most 16 rows asked about without a
    device fits."""
    _, tparams, _ = frame_setup
    pcfg = get_preset("tiny").predictor
    rows, device, group = 4, None, None
    if case == "cpu":
        device = torch.device("cpu")
    elif case == "rows":
        rows, device = 17, torch.device("cpu")
    elif case == "int8":
        tparams = quantize_bundle({"predictor": tparams}, "int8-predictor")["predictor"]
    elif case == "sliding":
        pcfg = dataclasses.replace(pcfg, sliding_window=4)
    elif case == "group":
        group = object()
    why = TP.micro_kernel_misfit(tparams, pcfg, rows, device, group)
    want = {"cpu": "on cpu", "rows": "17 rows (at most 16)", "int8": "quantized", "sliding": "sliding window",
            "group": "tp group", "ok": None}[case]
    assert why == want if want is None else want in why


def _tiny_step_inputs(tiny_cfg):
    pcfg, Ht = tiny_cfg.predictor, tiny_cfg.talker.hidden_size
    _, tparams = _both(tiny_cfg, _numpy_params(tiny_cfg, seed=8), "float32")
    w = TS.micro_step_weights(tparams)
    rng = np.random.default_rng(9)
    (_, kt), (_, vt) = _caches(pcfg, rng, "float32")
    x = torch.from_numpy(rng.standard_normal((1, Ht)).astype(np.float32))
    cos, sin = (torch.from_numpy(np.array(a)) for a in _rope(pcfg, 2))
    return w, x, cos, sin, kt, vt, torch.tensor([2], dtype=torch.int32)


def test_wrapper_routes_cpu_tensors_to_plain(tiny_cfg):
    w, x, cos, sin, kt, vt, pos = _tiny_step_inputs(tiny_cfg)
    before = TS.fused_micro_step.launches
    k2, v2 = kt.clone(), vt.clone()
    h, kk, vv = TS.fused_micro_step(w, x, cos, sin, kt, vt, pos)
    hp, _, _ = TS.fused_micro_step_plain(w, x, cos, sin, k2, v2, pos)
    assert kk is kt and vv is vt
    assert torch.equal(h, hp) and torch.equal(kt, k2) and torch.equal(vt, v2)
    assert TS.fused_micro_step.launches == before  # counts kernel launches only


@pytest.mark.parametrize("bad", ["x_shape", "cos_shape", "kv_v_shape", "weight_shape",
                                 "x_dtype", "pos_dtype", "cos_dtype", "norm_dtype",
                                 "int8_weights"])
def test_wrapper_rejects_bad_inputs(tiny_cfg, bad):
    w, x, cos, sin, kt, vt, pos = _tiny_step_inputs(tiny_cfg)
    if bad == "x_shape":
        x = x[:, :-1]
    elif bad == "cos_shape":
        cos = cos[:-1]
    elif bad == "kv_v_shape":
        vt = vt[:, :-1]
    elif bad == "weight_shape":
        w = dict(w, o=w["o"][:, :-1])
    elif bad == "x_dtype":
        x = x.double()
    elif bad == "pos_dtype":
        pos = pos.long()
    elif bad == "cos_dtype":
        cos = cos.bfloat16()
    elif bad == "norm_dtype":
        w = dict(w, in_norm=w["in_norm"].bfloat16())
    with pytest.raises(ValueError):
        if bad == "int8_weights":
            _, tparams = _both(tiny_cfg, _numpy_params(tiny_cfg), "float32")
            TS.micro_step_weights(quantize_bundle({"predictor": tparams},
                                                  "int8-predictor")["predictor"])
        TS.fused_micro_step(w, x, cos, sin, kt, vt, pos)


# ---------------------------------------------------------------------------
# the CUDA kernel's host-side geometry and the order of its sums

from qwen3tts_tpu_torch.ops import wstream as WS  # noqa: E402

SMS = 132  # the H100's grid: one CTA per SM
# (Ht, Hp, NH, KVH, D, I, L, S): the 0.6B and 1.7B predictors, and a small
# one with the kernel's head_dim
MICRO_DIMS = {"0.6b": (1024, 1024, 16, 8, 64, 3072, 5, 17),
              "1.7b": (2048, 1024, 16, 8, 64, 3072, 5, 17),
              "small": (64, 32, 2, 1, 64, 64, 2, 17)}


@pytest.mark.parametrize("dims", sorted(MICRO_DIMS))
@pytest.mark.parametrize("kind", TS.PHASES)
def test_phase_geometry_covers_every_weight_once(dims, kind):
    """Every phase kind gives each CTA of the 132 at most one item, and the
    items take every (row, column) of the phase's matrix exactly once."""
    d = MICRO_DIMS[dims]
    geo = TS.phase_geometry(d, SMS)[kind]
    K, N = TS.phase_dims(d)[kind]
    seen = np.zeros((K, N), np.int32)
    for cta in range(SMS):
        item = WS.item_of(cta, K, N, geo)
        if item is not None:
            assert item.cols % WS.VEC == 0 and item.n0 % WS.VEC == 0
            seen[item.k_lo:item.k_hi, item.n0:item.n0 + item.cols] += 1
    assert (seen == 1).all()
    assert WS.num_items(K, N, geo) <= SMS
    assert geo.splits == 1 or kind != "gu"  # the activation needs whole sums
    assert (2 if kind == "gu" else 1) * geo.cols <= TS.MAX_ITEM_COLS


def test_phase_geometry_fills_the_card_at_06b():
    """At the 0.6B shapes every phase has 128 items on the 132 CTAs, and a
    row segment of a tile is at least 32 bytes of bf16."""
    d = MICRO_DIMS["0.6b"]
    geo = TS.phase_geometry(d, SMS)
    for kind, (K, N) in TS.phase_dims(d).items():
        assert WS.num_items(K, N, geo[kind]) == 128, kind
        assert geo[kind].cols * 2 >= 32
    assert geo["gu"].cols == 24 and geo["down"] == WS.Geo(32, 4, 768)


@pytest.mark.parametrize("dims", sorted(MICRO_DIMS))
def test_o_phase_items_take_whole_heads_once(dims):
    """The attention is folded into the o phase: a head's first column lies
    in exactly one row split (whose CTA of column tile 0 writes the cache),
    and an item's cache rows fit the kernel's shared memory."""
    d = MICRO_DIMS[dims]
    Ht, Hp, NH, KVH, D, I, L, S = d
    geo = TS.phase_geometry(d, SMS)["o"]
    owners = [[ks for ks in range(geo.splits)
               if ks * geo.chunk <= h * D < min(NH * D, (ks + 1) * geo.chunk)]
              for h in range(NH)]
    assert all(len(o) == 1 for o in owners)
    nkv = TS.attention_kv_heads(d, geo)
    assert 1 <= nkv <= KVH
    assert 2 * nkv * S * D * 4 <= TS.KV_BYTES  # float32 cache rows


@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("cta", [0, 127, 131])
def test_ring_schedule_of_a_micro_step(L, cta):
    """A CTA's jobs over the 1 + 4 L phases, cut into the ring's stages: every
    row of every item once, stages within 16 KB, the slots round robin over a
    ring shallower than the schedule (wrap-around), nothing for a CTA
    without items."""
    d = MICRO_DIMS["0.6b"][:6] + (L, 17)
    geo = TS.phase_geometry(d, SMS)
    jobs = TS.cta_jobs(d, geo, cta, 2)
    assert len(jobs) == 1 + 4 * L
    sched = WS.stage_schedule(jobs, 9)
    if cta >= 128:
        assert sched == []
        return
    assert len(sched) > 9
    for j, (rows, row_bytes) in enumerate(jobs):
        mine = [(r0, n) for jj, r0, n, _ in sched if jj == j]
        assert sum(n for _, n in mine) == rows
        assert all(n * row_bytes <= WS.STAGE_BYTES for _, n in mine)
    assert [slot for *_, slot in sched] == [i % 9 for i in range(len(sched))]
    # this CTA's share of the step's weights: the whole, over the 128 CTAs with items
    total = sum(K * N * (2 if kind == "gu" else 1) * 2 * (1 if kind == "proj" else L)
                for kind, (K, N) in TS.phase_dims(d).items())
    assert abs(sum(r * b for r, b in jobs) - total / 128) <= 0.01 * total / 128


def test_graph_walk_needle_names_every_micro_step_kernel():
    """A captured step's launches are read from its graph's kernel nodes by
    substring of the kernel's name (``KERNEL_SYMBOLS``): the one-row and
    the rows kernel that ``fused_micro_step`` launches both carry its
    needle, and no other wrapper's needle matches them."""
    import re

    from qwen3tts_tpu_torch.ops.cuda_build import KERNEL_SYMBOLS, SOURCES

    src = SOURCES["predictor_step"].read_text()
    launched = set(re.findall(r"launch_cooperative\((\w+)<", src))
    assert launched == {"micro_step_kernel", "micro_step_kernel_rows"}
    for name in launched:
        hits = [k for k, needle in KERNEL_SYMBOLS.items() if needle in name]
        assert hits == ["fused_micro_step"], (name, hits)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_micro_step_in_kernel_order_matches_jax_kernel(tiny_cfg, dtype):
    """The plain version with every product summed over the CUDA kernel's
    row splits in split order, against the Pallas kernel in interpret mode
    (the stated tolerance) and, in float32, the plain order (1e-5: summation
    order only)."""
    pcfg, Ht = tiny_cfg.predictor, tiny_cfg.talker.hidden_size
    jparams, tparams = _both(tiny_cfg, _numpy_params(tiny_cfg, seed=5), dtype)
    w = TS.micro_step_weights(tparams)
    rng = np.random.default_rng(6)
    (kj, kt), (vj, vt) = _caches(pcfg, rng, dtype)
    x = rng.standard_normal((1, Ht)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))
    dims = TS._geometry(w, kt)
    # a grid of 4 CTAs cuts the tiny widths into row splits, as 132 cut the real ones
    geo = TS.phase_geometry(dims, 4)
    geo = {k: g._replace(splits=2, chunk=-(-TS.phase_dims(dims)[k][0] // 2))
           if k != "gu" else g for k, g in geo.items()}
    hj, kj, vj = _jax_step(jparams, pcfg, xj, kj, vj, 2, 16, 2)
    kp, vp = kt.clone(), vt.clone()
    cos, sin = (torch.from_numpy(np.array(a)) for a in _rope(pcfg, 2))
    pos = torch.tensor([2], dtype=torch.int32)
    ht, kt, vt = TS.fused_micro_step_plain(w, xt, cos, sin, kt, vt, pos, pcfg.rms_norm_eps,
                                           geo=geo)
    _close(ht, hj.astype(jnp.float32), dtype, "h")
    _close(kt, kj.astype(jnp.float32), dtype, "kv_k")
    _close(vt, vj.astype(jnp.float32), dtype, "kv_v")
    if dtype == "float32":
        hp, kp, vp = TS.fused_micro_step_plain(w, xt, cos, sin, kp, vp, pos, pcfg.rms_norm_eps)
        torch.testing.assert_close(ht, hp, atol=1e-5, rtol=0)
        torch.testing.assert_close(kt, kp, atol=1e-5, rtol=0)
