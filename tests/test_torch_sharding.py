"""The port's tensor-parallel serving (``qwen3tts_tpu_torch/parallel/``)
against the JAX package's, on the CPU over gloo.

- The mesh's arithmetic: JAX's ``test_mesh_shapes`` cases, the rank
  coordinates of ``np.array(devices).reshape(dp, tp)``.
- One rank's shard of every leaf has the shape of JAX's shard on its
  8-device mesh; its ``qkv_proj`` / ``gateup_proj`` hold the rank's heads
  and its gate and up columns (per part, not one contiguous slice), its
  ``o_proj`` / ``down_proj`` the matching rows; ``gather_params`` of
  ``shard_params`` is the identity, bit for bit.
- ``host_init_flagship`` draws JAX's ``host_init_flagship`` bits.
- ``sharded_inference_check`` at TP 4 and at dp 2 x tp 2, with and
  without ``kv_quant``: the sharded greedy tokens, and the port's
  unsharded ones, equal the JAX package's single-device tokens on the
  JAX package's weights.
- At TP 2: ``sharded_batched_serving_check`` (3 rows, a mid-batch join)
  equals the port's unsharded run; the sharded codec / text embeddings,
  codec head, speaker projection, LM heads and codebook lookups equal the
  whole ones; the flagship checks run at the tiny shardable config, their
  collectives per step as the model's layout predicts; a spawned rank has
  imported no JAX.
- What raises: quantized leaves, the fused and micro-step kernels with a
  mesh, captured chunks on a gloo mesh, NCCL with fewer cards than ranks.

The JAX batched engine is not run here (its compiles cost more than a
minute): the batched check is held to the port's own unsharded run, which
``tests/test_torch_batch.py`` holds to JAX.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the tier-1 run's workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu.core import config as jcfg  # noqa: E402
from qwen3tts_tpu.core.presets import get_preset as jget_preset  # noqa: E402
from qwen3tts_tpu.models import predictor as jpred  # noqa: E402
from qwen3tts_tpu.models import talker as jtalker  # noqa: E402
from qwen3tts_tpu.parallel import sharding as jshard  # noqa: E402
from qwen3tts_tpu.runtime import loops as jloops  # noqa: E402
from qwen3tts_tpu.runtime.engine import Engine as JEngine  # noqa: E402
from qwen3tts_tpu.runtime.engine import GenerationPolicy as JGenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.models import predictor as P  # noqa: E402
from qwen3tts_tpu_torch.models import talker as T  # noqa: E402
from qwen3tts_tpu_torch.models.layers import block_forward  # noqa: E402
from qwen3tts_tpu_torch.ops.quant import quantize_bundle  # noqa: E402
from qwen3tts_tpu_torch.parallel import sharding as S  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import Engine  # noqa: E402

# the rank functions' module: spawned ranks import it by name from sys.path
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_shard_workers as W  # noqa: E402

STEPS = 8


def _jax_cfg():
    """The JAX checks' tiny shardable config (sharding.py:149-161)."""
    return jcfg.TTSModelConfig(
        dtype="float32",
        talker=jcfg.TalkerConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=4, head_dim=16, intermediate_size=128,
            mrope_section=(4, 2, 2), vocab_size=3072, text_vocab_size=512,
            text_hidden_size=64, speaker_embed_dim=64),
        predictor=jcfg.PredictorConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=4, head_dim=16, intermediate_size=128))


@pytest.fixture(scope="module")
def jax_params():
    """The JAX checks' weights (their own initialisers), as numpy."""
    cfg = _jax_cfg()
    tp = jtalker.init_params(jax.random.PRNGKey(0), cfg.talker, jnp.float32)
    pp = jpred.init_params(jax.random.PRNGKey(1), cfg.predictor, cfg.talker.hidden_size,
                           jnp.float32)
    return jax.tree.map(np.asarray, tp), jax.tree.map(np.asarray, pp)


@pytest.fixture(scope="module")
def jax_single(jax_params):
    """The JAX single-device greedy tokens of sharded_inference_check's
    unsharded run, without and with kv_quant."""
    cfg = _jax_cfg()
    H = cfg.talker.hidden_size
    embeds = jnp.asarray(np.random.RandomState(2).randn(1, 10, H), jnp.float32) * 0.1
    tth = jnp.asarray(np.random.RandomState(3).randn(1, 4, H), jnp.float32) * 0.1
    tpe = jnp.zeros((1, 1, H), jnp.float32)
    out = {}
    for kv_quant in (False, True):
        eng = JEngine(jax_params[0], jax_params[1], cfg, max_seq_len=64, kv_quant=kv_quant)
        ids, _ = jloops.fast_generate(
            eng, embeds, tth, tpe, key=jax.random.PRNGKey(7), max_new_tokens=STEPS,
            policy=JGenerationPolicy(do_sample=False),
            pred_policy=jpred.SamplingPolicy(do_sample=False), device_chunk=4)
        out[kv_quant] = np.asarray(ids)
    return out


@pytest.fixture(scope="module")
def greedy(jax_params):
    """The port's sharded_inference_check on 4 ranks: TP 4 and dp 2 x tp 2."""
    return {mesh: S.launch(W.greedy_tokens, 4, jax_params, device="cpu", dp=dp)
            for mesh, dp in (("tp4", 1), ("dp2xtp2", 2))}


@pytest.fixture(scope="module")
def tp2(jax_params):
    return S.launch(W.parts, 2, jax_params, device="cpu")


def _rank_mesh(tp: int, rank: int, backend: str = "gloo") -> S.Mesh:
    """One rank's Mesh, for what needs no process group."""
    return S.Mesh({"dp": 1, "tp": tp}, rank, torch.device("cpu"), backend, None, None)


# ---------------------------------------------------------------------------
# the mesh and the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dp,tp,want", [(8, 2, 4, {"dp": 2, "tp": 4}),
                                          (8, None, None, {"dp": 1, "tp": 8}),
                                          (8, None, 2, {"dp": 4, "tp": 2}),
                                          (4, 2, None, {"dp": 2, "tp": 2})])
def test_mesh_shapes(n, dp, tp, want):
    shape, tp_groups, dp_groups = S.mesh_layout(n, dp=dp, tp=tp)
    assert shape == want
    assert shape == jshard.make_mesh(n, dp=dp, tp=tp).shape
    grid = np.arange(n).reshape(want["dp"], want["tp"])  # JAX's device layout
    assert tp_groups == grid.tolist() and dp_groups == grid.T.tolist()
    for r in range(n):
        m = S.Mesh(shape, r, torch.device("cpu"), "gloo", None, None)
        assert (m.dp_rank, m.tp_rank) == tuple(np.argwhere(grid == r)[0])
    with pytest.raises(ValueError):
        S.mesh_layout(n, dp=3, tp=3)


def test_shard_shapes_match_jax(jax_params):
    """Every leaf's shard on a tp-4 rank has the shape of its shard under
    the JAX package's NamedSharding on the (2, 4) mesh."""
    cfg, jc = _port_cfg(), _jax_cfg()
    jmesh = jshard.make_mesh(8, dp=2, tp=4)
    for part, jspecs, specs in (
            (0, jshard.talker_param_specs(jc.talker), S.talker_param_specs(cfg.talker)),
            (1, jshard.predictor_param_specs(jc.predictor),
             S.predictor_param_specs(cfg.predictor))):
        jsharded = jshard.shard_params(jax_params[part], jmesh, jspecs)
        mine = S.shard_params(jax_params[part], _rank_mesh(4, 1), specs)
        jleaves = jax.tree_util.tree_flatten_with_path(jsharded)[0]
        assert len(jleaves) == len(jax.tree_util.tree_leaves(mine))
        for path, leaf in jleaves:
            got = mine
            for p in path:
                got = got[p.key]
            assert {s.data.shape for s in leaf.addressable_shards} == {tuple(got.shape)}, path


def _port_cfg():
    return S._shardable_cfg()


@pytest.mark.parametrize("rank", [0, 3])
def test_fused_leaves_split_per_head(jax_params, rank):
    """qkv / gate|up hold rank r's heads and columns of each part; o / down
    the matching input rows (a contiguous quarter of qkv would be all q)."""
    cfg = _port_cfg()
    tk, tp = cfg.talker, 4
    D, NH, KVH, I = tk.head_dim, tk.num_attention_heads, tk.num_key_value_heads, \
        tk.intermediate_size
    blocks = jax_params[0]["blocks"]
    local = S.shard_params(jax_params[0], _rank_mesh(tp, rank),
                           S.talker_param_specs(tk))["blocks"]
    qkv = blocks["qkv_proj"]
    q = qkv[..., : NH * D].reshape(*qkv.shape[:2], NH, D)
    k = qkv[..., NH * D: (NH + KVH) * D].reshape(*qkv.shape[:2], KVH, D)
    v = qkv[..., (NH + KVH) * D:].reshape(*qkv.shape[:2], KVH, D)
    nh, kvh, i = NH // tp, KVH // tp, I // tp

    def heads(x, n):
        return x[:, :, rank * n: (rank + 1) * n].reshape(*x.shape[:2], -1)

    want = np.concatenate([heads(q, nh), heads(k, kvh), heads(v, kvh)], axis=-1)
    np.testing.assert_array_equal(local["qkv_proj"].numpy(), want)
    gu = blocks["gateup_proj"]
    cols = slice(rank * i, (rank + 1) * i)
    np.testing.assert_array_equal(local["gateup_proj"].numpy(), np.concatenate(
        [gu[..., :I][..., cols], gu[..., I:][..., cols]], axis=-1))
    np.testing.assert_array_equal(local["o_proj"].numpy(),
                                  blocks["o_proj"][:, rank * nh * D: (rank + 1) * nh * D])
    np.testing.assert_array_equal(local["down_proj"].numpy(), blocks["down_proj"][:, cols])
    spec = T.block_spec(tk, tp)
    assert (spec.num_heads, spec.num_kv_heads, spec.intermediate_size) == (nh, kvh, i)


def test_gather_of_shard_is_identity(tp2):
    # talker 16 leaves + predictor 13 + the int8 cache's 4
    assert tp2["roundtrip_leaves"] == 33
    assert tp2["kv_shapes"] == {"k": (2, 2, 16, 2, 16), "v": (2, 2, 16, 2, 16),
                                "ks": (2, 2, 2, 16), "vs": (2, 2, 2, 16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_init_flagship_bit_equal_to_jax(dtype):
    jt, jp = jshard.host_init_flagship(jget_preset("tiny"), getattr(jnp, dtype))
    t, p = S.host_init_flagship(get_preset("tiny"), getattr(torch, dtype))
    jleaves = jax.tree_util.tree_flatten_with_path({"t": jt, "p": jp})[0]
    mine = {"t": t, "p": p}
    for path, leaf in jleaves:
        got = mine
        for k in path:
            got = got[k.key]
        want = np.asarray(leaf)
        assert tuple(got.shape) == want.shape, path
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16), err_msg=str(path))
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))


# ---------------------------------------------------------------------------
# greedy tokens against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["tp4", "dp2xtp2"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_sharded_inference_equals_jax_single_device(greedy, jax_single, mesh, kv_quant):
    sharded, single = greedy[mesh][kv_quant]
    want = jax_single[kv_quant]
    assert sharded.shape == want.shape == (STEPS, 16)
    np.testing.assert_array_equal(single, want)
    np.testing.assert_array_equal(sharded, want)


def test_sharded_batched_serving_equals_unsharded(tp2):
    sharded, single = tp2["batched"]
    assert sharded.shape == single.shape == (3, 32, 16)
    np.testing.assert_array_equal(sharded, single)


def test_sharded_parts_equal_whole(tp2):
    d = tp2["diffs"]
    # gathers and masked lookups are exact; the row-parallel text projection
    # and the summed lookups add partial sums in another order (float32)
    for name in ("embed_codec", "codec_head", "project_speaker", "lm_logits", "codec_embed"):
        assert d[name] == 0.0, (name, d[name])
    assert d["embed_text"] <= 1e-6 and d["embed_sum"] <= 1e-6, d


def test_flagship_checks_at_tiny_shardable_config(tp2):
    sharded, single = tp2["flagship"]
    np.testing.assert_array_equal(sharded, single)
    cfg = _port_cfg()
    Lt, Lp = cfg.talker.num_hidden_layers, cfg.predictor.num_hidden_layers
    passes = cfg.predictor.num_codebooks  # the 2-token prefill + 14 micro-steps
    # per step: each block's o and down products, the 14 micro-step lookups
    # and the frame's embedding sum; the codec embedding, the LM heads and
    # the codec head gathered
    want = {"all_reduce": 2 * Lt + 2 * Lp * passes + (passes - 1) + 1,
            "all_gather": 1 + passes + 1}
    assert tp2["stats"]["sharded"]["eager_step_collectives"] == want
    assert tp2["stats"]["single"]["eager_step_collectives"] == {"all_reduce": 0,
                                                                "all_gather": 0}
    s = tp2["structural"]
    assert s["logit_max_delta"] < 0.08 * s["logit_scale"] and s["argmax_agree"] >= 0.8
    assert s["steps"] == 4


def test_spawned_ranks_import_no_jax(tp2):
    assert tp2["jax_modules"] == []


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------


def _tiny_port(jax_params):
    from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy

    return bundle_from_jax_numpy({"talker": jax_params[0], "predictor": jax_params[1]},
                                 _port_cfg(), torch.float32, "cpu")


def test_quantized_leaf_raises(jax_params):
    cfg = _port_cfg()
    q = quantize_bundle(_tiny_port(jax_params), "int8")
    with pytest.raises(ValueError, match="quantized leaf"):
        S.shard_params(q["talker"], _rank_mesh(2, 0), S.talker_param_specs(cfg.talker))
    with pytest.raises(ValueError, match="quantized"):
        Engine(q["talker"], q["predictor"], cfg, max_seq_len=64, mesh=_rank_mesh(2, 0))


@pytest.mark.parametrize("kw", [{"use_fused_kernels": True}, {"use_micro_kernel": True},
                                {"use_cuda_graphs": True}])
def test_engine_refuses_with_a_mesh(jax_params, kw):
    p = _tiny_port(jax_params)
    with pytest.raises(ValueError, match="mesh"):
        Engine(p["talker"], p["predictor"], _port_cfg(), max_seq_len=64,
               mesh=_rank_mesh(2, 0), **kw)


def test_captured_nccl_engine_needs_graph_mixing_off(jax_params, monkeypatch):
    p = _tiny_port(jax_params)
    monkeypatch.delenv("NCCL_GRAPH_MIXING_SUPPORT", raising=False)
    with pytest.raises(ValueError, match="NCCL_GRAPH_MIXING_SUPPORT=0"):
        Engine(p["talker"], p["predictor"], _port_cfg(), max_seq_len=64,
               mesh=_rank_mesh(2, 0, backend="nccl"), use_cuda_graphs=True)


def test_fused_block_and_micro_frame_refuse_a_group(jax_params):
    cfg = _port_cfg()
    p = _tiny_port(jax_params)
    layer = {k: v[0] for k, v in p["talker"]["blocks"].items()}
    with pytest.raises(ValueError, match="all-reduce"):
        block_forward(layer, None, None, None, None, 0, 0, None, T.block_spec(cfg.talker),
                      fused=True, group=object())
    with pytest.raises(ValueError, match="tp group"):
        P.predict_frame(p["predictor"], cfg.predictor, torch.zeros(1, 2, 64), None,
                        P.SamplingPolicy(), micro_kernel=True, group=object())


def test_launch_never_picks_a_backend_itself():
    n = torch.cuda.device_count() + 1  # more ranks than cards
    with pytest.raises(RuntimeError, match=f"need {n} cards"):
        S.launch(W.greedy_tokens, n, None)
    with pytest.raises(RuntimeError, match=f"need {n} cards"):
        S.launch(W.greedy_tokens, n, None, device="cuda")
    with pytest.raises(ValueError):
        S.launch(W.greedy_tokens, 2, None, device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a card"):
            S.launch(W.greedy_tokens, 2, None, device="cuda", backend="gloo")
