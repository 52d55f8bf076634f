"""PyTorch port vs the JAX package at the model level, on the ``tiny`` preset
in float32 with the JAX weights carried over by ``bundle_from_jax_numpy``:
talker prefill logits and decode-step hiddens, the predictor frame with a
greedy policy, and the speaker encoder (log-mel and x-vector).

Inputs come from numpy.random.default_rng.  Tolerance: atol 1e-4 on logits
and hiddens (float32, two layer stacks of summation-order differences);
predictor tokens must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.models import predictor as JP  # noqa: E402
from qwen3tts_tpu.models import speaker as JSp  # noqa: E402
from qwen3tts_tpu.models import talker as JT  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy, init_random  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models import predictor as TP  # noqa: E402
from qwen3tts_tpu_torch.models import speaker as TSp  # noqa: E402
from qwen3tts_tpu_torch.models import talker as TT  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module")
def ported(tiny_cfg, tiny_models):
    tp, pp = tiny_models
    tree = {"talker": jax.tree.map(np.asarray, tp), "predictor": jax.tree.map(np.asarray, pp)}
    return bundle_from_jax_numpy(tree, get_preset("tiny"), torch.float32, "cpu")


def test_talker_prefill_and_decode(tiny_cfg, tiny_models, ported):
    tp, _ = tiny_models
    cfg_j, cfg_t = tiny_cfg.talker, get_preset("tiny").talker
    rng = np.random.default_rng(0)
    H, T, S = cfg_j.hidden_size, 9, 32
    embeds = rng.standard_normal((1, T, H)).astype(np.float32) * 0.1
    pad = np.zeros((1,), np.int32)
    kv_j = JT.new_kv_cache(cfg_j, 1, S, jnp.float32)
    last_j, logits_j, kv_j = JT.prefill(tp, cfg_j, jnp.asarray(embeds), jnp.asarray(pad), kv_j)
    kv_t = TT.new_kv_cache(cfg_t, 1, S, torch.float32, "cpu")
    last_t, logits_t, kv_t = TT.prefill(ported["talker"], cfg_t, torch.from_numpy(embeds),
                                        torch.from_numpy(pad), kv_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=ATOL)

    kv_tm = {k: v.clone() for k, v in kv_t.items()}  # second copy for the masked path
    for i in range(3):
        x = rng.standard_normal((1, 1, H)).astype(np.float32) * 0.1
        pos = T + i
        h_j, kv_j = JT.decode_step(tp, cfg_j, jnp.asarray(x), jnp.int32(pos),
                                   jnp.asarray(pad), kv_j)
        pos_t = torch.tensor([pos], dtype=torch.int32)
        h_f, kv_t = TT.decode_step(ported["talker"], cfg_t, torch.from_numpy(x), pos_t,
                                   torch.from_numpy(pad), kv_t, use_flash=True)
        h_m, kv_tm = TT.decode_step(ported["talker"], cfg_t, torch.from_numpy(x), pos_t,
                                    torch.from_numpy(pad), kv_tm, use_flash=False)
        np.testing.assert_allclose(h_f.numpy(), np.asarray(h_j), atol=ATOL)
        np.testing.assert_allclose(h_m.numpy(), np.asarray(h_j), atol=ATOL)
        logits_j = JT.codec_head(tp, h_j[:, 0])
        logits_t = TT.codec_head(ported["talker"], h_f[:, 0])
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL)


def test_predictor_frame_greedy(tiny_cfg, tiny_models, ported):
    _, pp = tiny_models
    rng = np.random.default_rng(1)
    H = tiny_cfg.talker.hidden_size
    x = rng.standard_normal((1, 2, H)).astype(np.float32)
    tok_j, emb_j = JP.predict_frame(pp, tiny_cfg.predictor, jnp.asarray(x),
                                    jax.random.PRNGKey(0),
                                    JP.SamplingPolicy(do_sample=False))
    tok_t, emb_t = TP.predict_frame(ported["predictor"], get_preset("tiny").predictor,
                                    torch.from_numpy(x), None,
                                    TP.SamplingPolicy(do_sample=False))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=1e-6)


def test_speaker_embed(tiny_cfg):
    cfg = tiny_cfg.speaker_encoder
    params_j = JSp.init_params(jax.random.PRNGKey(4), cfg)
    params_t = bundle_from_jax_numpy({"speaker": jax.tree.map(np.asarray, params_j)},
                                     get_preset("tiny"), device="cpu")["speaker"]
    rng = np.random.default_rng(2)
    wav = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    mel_j = JSp.log_mel(jnp.asarray(wav), cfg.mel_bins, cfg.sample_rate)
    mel_t = TSp.log_mel(torch.from_numpy(wav), cfg.mel_bins, cfg.sample_rate)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=1e-3, rtol=1e-4)
    emb_j = JSp.embed(params_j, cfg, jnp.asarray(wav))
    emb_t = TSp.embed(params_t, cfg, torch.from_numpy(wav))
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=ATOL)


def test_init_random_matches_bridge_structure(tiny_cfg, tiny_models):
    """init_random and the bridge give the same tree, shapes and dtypes."""
    from qwen3tts_tpu.core import loader as JLd

    cfg = get_preset("tiny")
    mine = init_random(cfg, seed=0, device="cpu")
    jtree = jax.tree.map(np.asarray, JLd.init_random(tiny_cfg, seed=0))
    bridged = bundle_from_jax_numpy(jtree, cfg, device="cpu")

    def shapes(t, prefix=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items() for k2, v2 in shapes(v, f"{prefix}{k}/").items()}
        if isinstance(t, list):
            return {k2: v2 for i, v in enumerate(t)
                    for k2, v2 in shapes(v, f"{prefix}{i}/").items()}
        return {prefix: (tuple(t.shape), t.dtype)}

    assert shapes(mine) == shapes(bridged)
    # scales follow the JAX initialisers (std of a [in, out] weight ~ in^-0.5)
    w = mine["talker"]["blocks"]["qkv_proj"]
    assert abs(w.std().item() * cfg.talker.hidden_size ** 0.5 - 1.0) < 0.1
