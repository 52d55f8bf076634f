"""PyTorch port vs the JAX package: int8 weight-only quantization
(``ops/quant.py``) and the weight bridge for a quantized bundle.

- ``quantize_tensor`` / ``quantize_bundle`` (int8, int8-talker,
  int8-predictor): ``q`` and ``scale`` bit-equal to JAX on the same float32
  input.
- ``bundle_from_jax_numpy`` carries a quantized JAX bundle across with int8
  ``q`` and float32 ``scale`` unchanged.
- ``dequant_matmul`` / ``maybe_matmul``: float32, atol 1e-5 (summation
  order only).
- The modes as in JAX: the w8a8 modes quantize (``tests/test_torch_w8a8.py``
  holds them against JAX bit for bit); unknown modes raise ValueError.

Inputs come from numpy.random.default_rng and go to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.ops import quant as JQ  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.ops import quant as TQ  # noqa: E402


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("shape,scale", [((64, 96), 0.05), ((3, 32, 48), 1.0),
                                         ((2, 16, 8), 300.0)])
def test_quantize_tensor_bit_equal(shape, scale):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    w[..., 0, 1] = 0.0  # a column whose max sits elsewhere
    w[..., :, 2] = 0.0  # an all-zero column: scale floors at 1e-8 / 127
    got = TQ.quantize_tensor(torch.from_numpy(w))
    want = JQ.quantize_tensor(jnp.asarray(w))
    assert set(got) == {"q", "scale"}
    _bits_equal(got["q"], want["q"])
    _bits_equal(got["scale"], want["scale"])


def test_quantize_tensor_rounds_half_to_even():
    """Values that land exactly on .5 after the divide round to even, as
    jnp.round does (scale 1: the column max is 127)."""
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0]], np.float32).T
    got = TQ.quantize_tensor(torch.from_numpy(w))["q"].numpy()[:, 0]
    want = np.asarray(JQ.quantize_tensor(jnp.asarray(w))["q"])[:, 0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [127, 0, 2, 2, 0, -2, 126, -127])


def _jax_tiny_bundle(tiny_models):
    tp, pp = tiny_models
    return {"talker": tp, "predictor": pp}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("mode", ["int8", "int8-talker", "int8-predictor"])
def test_quantize_bundle_bit_equal(tiny_models, mode):
    jb = _jax_tiny_bundle(tiny_models)
    cfg = get_preset("tiny")
    tb = bundle_from_jax_numpy(jax.tree.map(np.asarray, jb), cfg, torch.float32, "cpu")
    got = TQ.quantize_bundle(tb, mode)
    want = JQ.quantize_bundle(jb, mode)
    got_leaves = dict(_leaves(got))
    want_leaves = dict(_leaves(jax.tree.map(np.asarray, want)))
    assert set(got_leaves) == set(want_leaves)
    quantized = [k for k in got_leaves if k.endswith("/q")]
    parts = ("talker", "predictor") if mode == "int8" else (mode.split("-")[1],)
    assert {k.split("/")[1] for k in quantized} == set(parts)
    if "predictor" in parts:
        assert "/predictor/lm_heads/q" in got_leaves
    for name, t in got_leaves.items():
        if name.endswith(("/q", "/scale")):
            _bits_equal(t, want_leaves[name])
        else:  # untouched leaves: the float32 bundle as carried across
            np.testing.assert_array_equal(t.numpy(), want_leaves[name], err_msg=name)


def test_bridge_keeps_quantized_leaves_bit_exact(tiny_models):
    """bundle_from_jax_numpy used to cast every leaf to the model dtype, so an
    int8 ``q`` arrived as a float tensor and a float32 ``scale`` as bf16."""
    jq = JQ.quantize_bundle(_jax_tiny_bundle(tiny_models), "int8")
    tree = jax.tree.map(np.asarray, jq)
    out = bundle_from_jax_numpy(tree, get_preset("tiny"), torch.bfloat16, "cpu")
    for part, key in (("talker", "qkv_proj"), ("talker", "down_proj"),
                      ("predictor", "gateup_proj")):
        leaf = out[part]["blocks"][key]
        assert leaf["q"].dtype == torch.int8 and leaf["scale"].dtype == torch.float32
        _bits_equal(leaf["q"], tree[part]["blocks"][key]["q"])
        _bits_equal(leaf["scale"], tree[part]["blocks"][key]["scale"])
    lm = out["predictor"]["lm_heads"]
    _bits_equal(lm["q"], tree["predictor"]["lm_heads"]["q"])
    _bits_equal(lm["scale"], tree["predictor"]["lm_heads"]["scale"])
    # every other leaf still takes the model dtype
    assert out["talker"]["blocks"]["input_norm"].dtype == torch.bfloat16
    assert out["talker"]["codec_embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("quantized", [False, True])
def test_dequant_and_maybe_matmul(quantized):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 0.1).astype(np.float32)
    wj = JQ.quantize_tensor(jnp.asarray(w)) if quantized else jnp.asarray(w)
    wt = TQ.quantize_tensor(torch.from_numpy(w)) if quantized else torch.from_numpy(w)
    got = TQ.maybe_matmul(torch.from_numpy(x), wt).numpy()
    want = np.asarray(JQ.maybe_matmul(jnp.asarray(x), wj))
    np.testing.assert_allclose(got, want, atol=1e-5)
    if quantized:
        np.testing.assert_allclose(TQ.dequant_matmul(torch.from_numpy(x), wt).numpy(),
                                   np.asarray(JQ.dequant_matmul(jnp.asarray(x), wj)),
                                   atol=1e-5)


def test_modes_and_w8a8_not_ported():
    """The modes, ``parse_mode`` and the unknown-mode check as in JAX.  The
    w8a8 modes, which raised NotImplementedError before they were ported,
    now quantize the selected blocks as ``{"q8", "scale"}`` (the lm_heads
    stay int8 ``{"q", "scale"}``), and ``maybe_matmul`` sends a ``q8``
    weight to ``w8a8_matmul``."""
    assert TQ.MODES == JQ.MODES
    for mode in TQ.MODES:
        assert TQ.parse_mode(mode) == JQ.parse_mode(mode)
    with pytest.raises(ValueError, match="unknown quantize mode"):
        TQ.parse_mode("int4")
    g = torch.Generator().manual_seed(0)
    bundle = {"talker": {"blocks": {"qkv_proj": torch.randn(1, 4, 4, generator=g)}},
              "predictor": {"blocks": {"qkv_proj": torch.randn(1, 4, 4, generator=g)},
                            "lm_heads": torch.randn(1, 4, 4, generator=g)}}
    for mode in ("w8a8", "w8a8-talker", "w8a8-predictor"):
        out = TQ.quantize_bundle(bundle, mode)
        _, parts = TQ.parse_mode(mode)
        for part in ("talker", "predictor"):
            leaf = out[part]["blocks"]["qkv_proj"]
            assert (set(leaf) == {"q8", "scale"}) if part in parts else leaf is bundle[
                part]["blocks"]["qkv_proj"]
        lm = out["predictor"]["lm_heads"]
        assert set(lm) == {"q", "scale"} if "predictor" in parts else lm is bundle[
            "predictor"]["lm_heads"]
    x = torch.randn(2, 4, generator=g)
    w = TQ.quantize_tensor(torch.randn(4, 4, generator=g), "w8a8")
    assert set(w) == {"q8", "scale"}
    assert torch.equal(TQ.maybe_matmul(x, w), TQ.w8a8_matmul(x, w))
