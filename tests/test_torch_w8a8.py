"""PyTorch port vs the JAX package: the w8a8 modes (``ops/w8a8.py``,
``ops/quant.py``) on the CPU, where the wrappers run their plain versions.

- ``quantize_tensor(w, "w8a8")``, ``quantize_act`` and ``w8a8_matmul``:
  bit-equal to JAX (atol 0) at M 1, 3 and 17, float32 and bfloat16; ties
  round half to even and an all-zero row takes the 1e-8 floor.  Every step
  is exact or rounds once in the JAX order, and the int8 products are
  summed exactly (float64 here, int32 in JAX), so no tolerance is needed.
- ``maybe_matmul`` dispatch, ``quantize_bundle`` in the three w8a8 modes
  leaf for leaf, and the weight bridge carrying a JAX w8a8 bundle with int8
  ``q8`` and float32 ``scale`` bit for bit (it used to cast them to the
  model dtype).
- The tiny float32 ``Engine`` with a w8a8 bundle gives the JAX engine's
  greedy tokens (plain, ``use_fused_kernels=True``, ``kv_quant=True``).
- ``from_pretrained("random:tiny", device="cpu", quantize=...)`` in each
  w8a8 mode: streamed and non-streamed audio of the right length; a save /
  load and ``replicate_to`` keep the int8 leaves.
- ``w8a8_gemv(x, q8, scale, dtype)``, the fused kernel's wrapper (its
  plain version here), bit-equal to JAX's ``w8a8_matmul`` at 1 to 16 rows,
  bf16 and float32, the tiny and the 0.6B presets' shapes, with ties and an
  all-zero row.
- The fused GEMV kernel's geometry (``gemv_geometry``) at the presets' shapes.

Inputs come from numpy.random.default_rng and go to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the tier-1 run's workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.ops import quant as JQ  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.ops import quant as TQ  # noqa: E402
from qwen3tts_tpu_torch.ops import w8a8 as W  # noqa: E402
from test_torch_slice import _greedy_tokens_both  # noqa: E402  (JAX and port engines)

W8A8_MODES = ("w8a8", "w8a8-talker", "w8a8-predictor")


def _np_bits(a) -> np.ndarray:
    """The raw bits of a numpy / JAX array or a torch tensor (bf16 too)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(
        {1: np.uint8, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _bits_equal(got, want) -> None:
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_array_equal(_np_bits(got), _np_bits(want))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(a).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("shape,scale", [((64, 96), 0.05), ((3, 32, 48), 1.0)])
def test_quantize_tensor_w8a8_bit_equal(shape, scale):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    w[..., :, 2] = 0.0  # an all-zero column: the 1e-8 floor
    got = TQ.quantize_tensor(torch.from_numpy(w), "w8a8")
    want = JQ.quantize_tensor(jnp.asarray(w), "w8a8")
    assert set(got) == set(want) == {"q8", "scale"}
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    _bits_equal(got["q8"], want["q8"])
    _bits_equal(got["scale"], want["scale"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_ties_and_zero_row(dtype):
    """Row 0's max is 127, so xs is 1 and x / xs lands on .5 exactly: ties
    round half to even; row 1 is all zero: xs floors at 1e-8 / 127 and xq is
    0."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0],
                  [0.0] * 8], np.float32)
    xt, xj = _pair(x, dtype)
    (gq, gs), (wq, ws) = W.quantize_act(xt), JQ.quantize_act(xj)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32 and gs.shape == (2, 1)
    _bits_equal(gq, wq)
    _bits_equal(gs, ws)
    np.testing.assert_array_equal(gq.numpy()[0], [127, 0, 2, 2, 0, -2, 126, -127])
    assert gs[1, 0].item() == np.float32(np.float32(1e-8) / np.float32(127.0))
    assert not gq[1].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 64, 32), (3, 96, 40), (17, 64, 48), (1, 1024, 512)])
def test_w8a8_matmul_bit_equal(dtype, M, K, N):
    rng = np.random.default_rng(M * 1000 + K + N)
    x = (rng.standard_normal((M, K)) * 3.0).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    xt, xj = _pair(x, dtype)
    qt, qj = TQ.quantize_tensor(torch.from_numpy(w), "w8a8"), JQ.quantize_tensor(
        jnp.asarray(w), "w8a8")
    got, want = TQ.w8a8_matmul(xt, qt), JQ.w8a8_matmul(xj, qj)
    assert got.dtype == xt.dtype
    _bits_equal(got, want)
    (gq, gs), (wq, ws) = TQ.quantize_act(xt), JQ.quantize_act(xj)
    _bits_equal(gq, wq)
    _bits_equal(gs, ws)
    # the fused GEMV's wrapper (its plain version on CPU tensors)
    _bits_equal(W.w8a8_gemv(xt, qt["q8"], qt["scale"], xt.dtype), want)


# (K, N): the tiny talker's qkv, the tiny predictor's o, the tiny talker's
# down; the 0.6B talker's qkv and down
GEMV_SHAPES = [(64, 128), (32, 32), (128, 64), (1024, 4096), (3072, 1024)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("K,N", GEMV_SHAPES)
def test_w8a8_gemv_bit_equal_jax(K, N, M, dtype):
    """Row 0 holds 127 and values whose quotient by xs = 1 is a tie (round
    half to even), row 1 is all zero (the 1e-8 floor)."""
    rng = np.random.default_rng(K * 7 + N + M)
    x = (rng.standard_normal((M, K)) * 3.0).astype(np.float32)
    x[0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0]
    if M > 1:
        x[1] = 0.0
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    xt, xj = _pair(x, dtype)
    qt = TQ.quantize_tensor(torch.from_numpy(w), "w8a8")
    want = JQ.w8a8_matmul(xj, JQ.quantize_tensor(jnp.asarray(w), "w8a8"))
    got = W.w8a8_gemv(xt, qt["q8"], qt["scale"], xt.dtype)
    assert got.dtype == xt.dtype and got.shape == (M, N)
    _bits_equal(got, want)
    _bits_equal(W.w8a8_gemv_plain(xt, qt["q8"], qt["scale"], xt.dtype), want)


def test_w8a8_matmul_keeps_leading_axes():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    got = TQ.w8a8_matmul(torch.from_numpy(x), TQ.quantize_tensor(torch.from_numpy(w), "w8a8"))
    want = JQ.w8a8_matmul(jnp.asarray(x), JQ.quantize_tensor(jnp.asarray(w), "w8a8"))
    assert got.shape == (2, 3, 24)
    _bits_equal(got, want)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_maybe_matmul_dispatch(mode):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 0.1).astype(np.float32)
    wt, wj = TQ.quantize_tensor(torch.from_numpy(w), mode), JQ.quantize_tensor(
        jnp.asarray(w), mode)
    got = TQ.maybe_matmul(torch.from_numpy(x), wt)
    want = JQ.maybe_matmul(jnp.asarray(x), wj)
    if mode == "w8a8":
        _bits_equal(got, want)
        assert torch.equal(got, TQ.w8a8_matmul(torch.from_numpy(x), wt))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("mode", W8A8_MODES)
def test_quantize_bundle_w8a8_bit_equal(tiny_models, mode):
    tp, pp = tiny_models
    jb = {"talker": tp, "predictor": pp}
    tb = bundle_from_jax_numpy(jax.tree.map(np.asarray, jb), get_preset("tiny"),
                               torch.float32, "cpu")
    got = dict(_leaves(TQ.quantize_bundle(tb, mode)))
    want = dict(_leaves(jax.tree.map(np.asarray, JQ.quantize_bundle(jb, mode))))
    assert set(got) == set(want)
    _, parts = TQ.parse_mode(mode)
    assert {k.split("/")[1] for k in got if k.endswith("/q8")} == set(parts)
    # the predictor's lm_heads stay int8 weight-only in every w8a8 mode
    assert ("/predictor/lm_heads/q" in got) == ("predictor" in parts)
    for name, t in got.items():
        _bits_equal(t, want[name])


def test_bridge_carries_w8a8_leaves_bit_exact(tiny_models):
    """bundle_from_jax_numpy used to keep only ``{"q", "scale"}`` leaves
    quantized; a ``{"q8", "scale"}`` leaf fell through to the generic branch
    and arrived as the model dtype (bf16 here), rounding every scale."""
    tp, pp = tiny_models
    tree = jax.tree.map(np.asarray, JQ.quantize_bundle({"talker": tp, "predictor": pp},
                                                       "w8a8"))
    out = bundle_from_jax_numpy(tree, get_preset("tiny"), torch.bfloat16, "cpu")
    for part in ("talker", "predictor"):
        for key in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"):
            leaf, src = out[part]["blocks"][key], tree[part]["blocks"][key]
            assert set(leaf) == {"q8", "scale"}
            assert leaf["q8"].dtype == torch.int8 and leaf["scale"].dtype == torch.float32
            _bits_equal(leaf["q8"], src["q8"])
            _bits_equal(leaf["scale"], src["scale"])
    lm = out["predictor"]["lm_heads"]
    assert set(lm) == {"q", "scale"} and lm["q"].dtype == torch.int8
    _bits_equal(lm["scale"], tree["predictor"]["lm_heads"]["scale"])
    assert out["talker"]["blocks"]["input_norm"].dtype == torch.bfloat16


@pytest.mark.parametrize("engine_kw", [{}, {"use_fused_kernels": True}, {"kv_quant": True}],
                         ids=["plain", "fused", "kv_quant"])
def test_w8a8_engine_greedy_tokens_equal_jax(tiny_cfg, tiny_models, engine_kw):
    """A JAX w8a8 bundle, carried across by the bridge: the fused gate keeps
    every q8 weight on maybe_matmul, as JAX's does."""
    tp, pp = tiny_models
    qb = JQ.quantize_bundle({"talker": tp, "predictor": pp}, "w8a8")
    eng, got, want = _greedy_tokens_both(tiny_cfg, qb["talker"], qb["predictor"], **engine_kw)
    assert set(eng.talker_params["blocks"]["qkv_proj"]) == {"q8", "scale"}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def ref_wav_path(tmp_path_factory):
    from qwen3tts_tpu_torch.audio.wav import write_wav

    path = tmp_path_factory.mktemp("w8a8") / "ref.wav"
    t = np.arange(16000, dtype=np.float32) / 16000
    write_wav(str(path), (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000)
    return str(path)


@pytest.mark.parametrize("mode", W8A8_MODES)
def test_api_w8a8_modes_on_cpu(ref_wav_path, mode):
    m = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu", quantize=mode)
    spf = m.vocoder.spf
    wavs, _ = m.generate_voice_clone("hello there", "English", ref_wav_path, "",
                                     max_new_tokens=8, min_new_tokens=8)
    assert wavs[0].shape == (8 * spf,) and np.isfinite(wavs[0]).all()
    out = list(m.generate_voice_clone_streaming(
        "hello there", "English", ref_wav_path, "", max_new_tokens=8, min_new_tokens=8,
        chunk_size=4))
    audio = np.concatenate([a for a, _, _ in out])
    assert len(out) == 2 and audio.shape == (8 * spf,) and np.isfinite(audio).all()


def test_w8a8_model_saves_loads_and_replicates(tmp_path):
    m = FasterQwen3TTS.from_pretrained("random:tiny", device="cpu", quantize="w8a8")
    m.save_pretrained(tmp_path / "ckpt")
    again = FasterQwen3TTS.from_pretrained(str(tmp_path / "ckpt"), device="cpu")
    clone = m.replicate_to("cpu", seed=1)
    for other in (again, clone):
        for part in ("talker", "predictor"):
            src, got = m.params[part]["blocks"]["down_proj"], other.params[part][
                "blocks"]["down_proj"]
            assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
            assert torch.equal(got["q8"], src["q8"]) and torch.equal(got["scale"], src["scale"])
        assert torch.equal(other.params["predictor"]["lm_heads"]["q"],
                           m.params["predictor"]["lm_heads"]["q"])


G = W.GemvGeometry


@pytest.mark.parametrize("M,K,N,elt,want", [
    (1, 1024, 4096, 2, G(1, False, 4, 256, 256, 1, True)),  # 0.6B talker qkv, B 1: 32 x 4
    (1, 2048, 1024, 2, G(1, False, 16, 128, 128, 1, True)),  # N 1024: 8 tiles x 16 splits
    (1, 1024, 6144, 2, G(1, False, 2, 512, 256, 2, True)),  # gate-up: 48 tiles x 2
    (4, 3072, 1024, 2, G(8, True, 16, 192, 192, 1, False)),  # down, B 4: x exchanged
    (16, 1024, 4096, 2, G(16, True, 4, 256, 256, 1, False)),  # mma from MMA_FROM_ROWS rows
    (16, 2048, 4096, 2, G(16, True, 4, 512, 256, 1, False)),  # 2 of 128 KB smem a CTA: ring 1
    (16, 1024, 1024, 4, G(16, True, 16, 64, 64, 1, False)),  # predictor o, float32
    (3, 2048, 4096, 2, G(8, True, 4, 512, 256, 2, True)),  # 1.7B talker qkv
    (8, 32, 32, 4, G(8, True, 1, 32, 32, 1, False)),  # tiny predictor o: no split
    (16, 2048, 12288, 4, G(16, True, 3, 704, 256, 1, False)),  # x's slice forces 3 splits
])
def test_gemv_geometry(M, K, N, elt, want):
    geo = W.gemv_geometry(M, K, N, 132, elt)
    assert geo == want
    assert geo.mt >= M and (geo.mt >= 8 if geo.mma else geo.mt < 2 * M)
    assert geo.kc % W.STEP == 0 and (geo.splits - 1) * geo.kc < K <= geo.splits * geo.kc
    assert 1 <= geo.splits <= W.MAX_SPLITS
    assert K * (M * elt + geo.mt) <= geo.splits * W.SLICE_BYTES
    assert geo.ring * geo.stage_rows * W.TILE <= W.RING_BYTES
    assert geo.stage_rows % W.STEP == 0 and geo.stage_rows <= min(geo.kc, W.MAX_STAGE_ROWS)
    assert geo.whole == (geo.splits > 1 and M * K * elt <= W.WHOLE_ROW_BYTES)
    smem = W.gemv_smem_bytes(geo.mt, M, elt, geo.kc, geo.stage_rows, geo.ring, geo.splits)
    assert geo.ring == 1 or 4 * -(-N // W.TILE) * geo.splits <= 3 * 132 or (
        smem <= W.CTA_SMEM_BYTES)
    forced = -(-K * (M * elt + geo.mt) // W.SLICE_BYTES)  # splits the slice of x needs
    assert -(-N // W.TILE) * geo.splits <= 132 or geo.splits == forced


def test_gemv_geometry_refuses_a_k_no_split_holds():
    assert W.gemv_geometry(16, 16384, 1024, 132, 4) is None
    assert W.gemv_geometry(16, 8192, 1024, 132, 4) is not None


def test_w8a8_gemv_rejects_bad_shapes():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="q8 \\[K, N\\]"):
        W.w8a8_gemv(x, torch.zeros((9, 4), dtype=torch.int8), torch.ones((1, 4)), torch.float32)
    with pytest.raises(ValueError, match="x \\[M, K\\]"):
        W.w8a8_gemv(torch.zeros((1, 2, 8)), torch.zeros((8, 4), dtype=torch.int8),
                    torch.ones((1, 4)), torch.float32)
    with pytest.raises(ValueError, match=r"x \[..., 8\]"):
        W.w8a8_matmul(torch.zeros((2, 7)), {"q8": torch.zeros((8, 4), dtype=torch.int8),
                                            "scale": torch.ones((1, 4))})
