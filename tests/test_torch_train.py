"""The port's talker train step (``parallel/sharding.py``: ``_talker_loss``,
``make_train_step``) and its optimiser (``utils/optim.py``) against the
JAX package and optax, on the CPU.

- ``_talker_loss`` and its gradient against JAX's under
  ``jax.value_and_grad``, on JAX's weights of the tiny shardable config,
  float32, left pads [0, 3]: the loss within 1e-6 relative, every leaf's
  gradient within 1e-5 of its largest magnitude (summation order only).
- ``adamw`` against ``optax.adamw(1e-2)`` over one and three steps from
  the same params and gradients, a leaf the loss never reads decayed;
  ``clip_by_global_norm`` and ``warmup_cosine_decay_schedule`` against
  optax's, the schedule at every step index of two configurations.
- The sharded step over gloo in spawned ranks at JAX's own mesh, dp 2 x
  tp 4 (8 ranks; JAX's ``tests/test_sharding.py:43-64``, which JAX marks
  slow), at tp 2, and unsharded in this process: 3 steps at lr 1e-2 with
  left pads that differ between dp rows.  The losses equal those of the
  unsharded JAX ``value_and_grad`` + ``optax.adamw`` loop (1e-5
  relative); the gathered params after 3 steps match it (below); every
  rank's gathered params have the same bits after each step; the
  collectives of a step follow ``make_train_step``'s formula, and a
  forward under ``torch.inference_mode()`` or with grad enabled makes the
  serving path's (2 L all-reduces, 1 all-gather) and no backward one.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the tier-1 run's workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from qwen3tts_tpu.core import config as jcfg  # noqa: E402
from qwen3tts_tpu.models import talker as jtalker  # noqa: E402
from qwen3tts_tpu.parallel import sharding as jshard  # noqa: E402
from qwen3tts_tpu_torch.parallel import sharding as S  # noqa: E402
from qwen3tts_tpu_torch.utils import optim  # noqa: E402

# the rank functions' module: spawned ranks import it by name from sys.path
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_train_workers as W  # noqa: E402

LR = 1e-2  # JAX's sharded train-step test
STEPS = 3
LOSS_RTOL = 1e-5
# After 3 Adam steps a parameter's change is ~lr a step whatever its
# gradient's size, so an element whose gradient is at float32 noise level
# (|g| ~ 1e-9) may move another way in the two packages.  Held: every
# element within 1e-5 + 1e-4 |ref| but at most 1 in 10,000 of a leaf, and
# those within lr / 50.
PARAM_ATOL, PARAM_RTOL, PARAM_OUTLIERS, PARAM_MAX = 1e-5, 1e-4, 1e-4, LR / 50


def _jax_talker_cfg():
    """The tiny shardable talker (``tests/test_torch_sharding.py:_jax_cfg``)."""
    return jcfg.TalkerConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=4, head_dim=16, intermediate_size=128,
        mrope_section=(4, 2, 2), vocab_size=3072, text_vocab_size=512,
        text_hidden_size=64, speaker_embed_dim=64)


def _flat(tree) -> dict:
    """``/``-joined path -> numpy leaf of a JAX tree."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_params():
    tk = _jax_talker_cfg()
    return jax.tree.map(np.asarray, jtalker.init_params(jax.random.PRNGKey(0), tk, jnp.float32))


@pytest.fixture(scope="module")
def batch():
    """4 rows x 16 positions, JAX's test's scale; pads [0, 3] on dp rank 0's
    rows and [5, 0] on dp rank 1's, so the valid counts differ."""
    tk = _jax_talker_cfg()
    rs = np.random.RandomState(0)
    embeds = (rs.randn(4, 16, tk.hidden_size) * 0.02).astype(np.float32)
    targets = rs.randint(0, tk.vocab_size, (4, 16)).astype(np.int32)
    return embeds, targets, np.array([0, 3, 5, 0], np.int32)


@pytest.fixture(scope="module")
def jax_loop(jax_params, batch):
    """The unsharded JAX loop: ``value_and_grad`` of JAX's ``_talker_loss``,
    then ``optax.adamw(LR)``, STEPS times."""
    tk = _jax_talker_cfg()
    e, t, pad = (jnp.asarray(x) for x in batch)
    vg = jax.jit(jax.value_and_grad(lambda p: jshard._talker_loss(p, tk, e, t, pad)))
    opt = optax.adamw(LR)
    p = jax.tree.map(jnp.asarray, jax_params)
    state, losses = opt.init(p), []
    for _ in range(STEPS):
        loss, g = vg(p)
        updates, state = opt.update(g, state, p)
        p = optax.apply_updates(p, updates)
        losses.append(float(loss))
    return np.array(losses), _flat(p)


@pytest.fixture(scope="module")
def sharded(jax_params, batch):
    return {mesh: S.launch(W.train_steps, world, jax_params, batch, LR, STEPS, device="cpu",
                           dp=dp)
            for mesh, world, dp in (("dp2xtp4", 8, 2), ("tp2", 2, 1))}


def _held_params(got: dict, want: dict) -> None:
    for name, x in optim.named_leaves(got):
        x = np.asarray(x)
        ref = want[name]
        assert x.shape == ref.shape, name
        d = np.abs(x - ref)
        out = d > PARAM_ATOL + PARAM_RTOL * np.abs(ref)
        assert out.sum() <= PARAM_OUTLIERS * ref.size, (name, int(out.sum()), ref.size)
        assert d.max() <= PARAM_MAX, (name, float(d.max()))


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------


def test_talker_loss_and_grads_equal_jax(jax_params):
    tk, ptk = _jax_talker_cfg(), S._shardable_cfg().talker
    rs = np.random.RandomState(1)
    embeds = (rs.randn(2, 16, tk.hidden_size) * 0.02).astype(np.float32)
    targets = rs.randint(0, tk.vocab_size, (2, 16)).astype(np.int32)
    pad = np.array([0, 3], np.int32)
    jloss, jgrad = jax.value_and_grad(lambda p: jshard._talker_loss(
        p, tk, jnp.asarray(embeds), jnp.asarray(targets), jnp.asarray(pad)))(
            jax.tree.map(jnp.asarray, jax_params))
    params = S._host(jax_params, torch.float32)
    named = optim.named_leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    loss = S._talker_loss(params, ptk, torch.tensor(embeds), torch.tensor(targets),
                          torch.tensor(pad))
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    assert abs(loss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    want = _flat(jgrad)
    for (name, _), g in zip(named, grads):
        ref = want[name]
        if g is None:  # not read by the loss: JAX's gradient is zero
            assert not ref.any(), name
            continue
        assert np.abs(g.numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), name


# ---------------------------------------------------------------------------
# the optimiser against optax
# ---------------------------------------------------------------------------


def _tree(rs, scale=1.0):
    return {"a": {"w": (rs.randn(5, 7) * scale).astype(np.float32),
                  "b": (rs.randn(7) * scale).astype(np.float32)},
            "unused": (rs.randn(3, 4) * scale).astype(np.float32)}


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_equals_optax(steps):
    """From the same params and gradients (``unused`` has none: optax sees
    zeros and decays it), within 1e-6 + 1e-6 |ref|."""
    rs = np.random.RandomState(steps)
    params = _tree(rs)
    grads = [_tree(rs, 0.1) for _ in range(steps)]
    for g in grads:
        g["unused"][:] = 0.0
    opt = optax.adamw(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
    tp = S._host(params, torch.float32)
    mine = optim.adamw(1e-2)
    st = mine.init(tp)
    for g in grads:
        gl = [torch.tensor(x) for x in optim.leaves(g)]
        gl[-1] = None  # "unused" sorts last
        mine.step(tp, gl, st)
    want = _flat(jp)
    for name, x in optim.named_leaves(tp):
        np.testing.assert_allclose(x.numpy(), want[name], rtol=1e-6, atol=1e-6, err_msg=name)
    assert st["count"] == steps
    assert not np.array_equal(want["unused"], params["unused"])  # decayed


@pytest.mark.parametrize("scale", [0.01, 10.0])  # below and above the norm 1.0
def test_clip_by_global_norm_equals_optax(scale):
    g = _tree(np.random.RandomState(7), scale)
    jg, _ = optax.clip_by_global_norm(1.0).update(jax.tree.map(jnp.asarray, g), None)
    tg = [torch.tensor(x) for x in optim.leaves(g)]
    norm = optim.clip_by_global_norm(tg, 1.0)
    assert abs(norm.item() - float(optax.global_norm(jax.tree.map(jnp.asarray, g)))) <= \
        1e-6 * norm.item()
    for x, ref in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


@pytest.mark.parametrize("args", [(0.0, 4e-4, 1, 4, 4e-4 * 0.02),      # train_asr's, 4 steps
                                  (0.0, 4e-4, 50, 480, 4e-4 * 0.02)])  # 16 epochs of 30
def test_warmup_cosine_schedule_equals_optax(args):
    """optax's float32 value at every step index, and past the end, within
    1e-6 relative (~8 ulps: XLA's float32 cosine is an approximation a few
    ulps off numpy's, seen at 5.7e-7)."""
    init, peak, warmup, decay, end = args
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    mine = optim.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    counts = np.arange(decay + 3)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(counts, jnp.int32)), np.float32)
    got = np.array([mine(c) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the train step, unsharded and sharded, against the JAX loop
# ---------------------------------------------------------------------------


def test_unsharded_step_equals_jax_loop(jax_params, batch, jax_loop):
    tk = S._shardable_cfg().talker
    params = S._host(jax_params, torch.float32)
    init_opt, step = S.make_train_step(tk, None, LR, device="cpu")
    state, losses = init_opt(params), []
    for _ in range(STEPS):
        params, state, loss = step(params, state, *batch)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jax_loop[0], rtol=LOSS_RTOL)
    _held_params(params, jax_loop[1])


@pytest.mark.parametrize("mesh", ["dp2xtp4", "tp2"])
def test_sharded_losses_equal_jax_loop(sharded, jax_loop, mesh):
    losses = np.array(sharded[mesh]["losses"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jax_loop[0], rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", ["dp2xtp4", "tp2"])
def test_sharded_params_equal_jax_loop(sharded, jax_loop, mesh):
    _held_params(sharded[mesh]["params"], jax_loop[1])


@pytest.mark.parametrize("mesh", ["dp2xtp4", "tp2"])
def test_every_rank_holds_the_same_bits(sharded, mesh):
    """The gathered params of every rank after each step: replicated leaves
    (the norms, the biases) bit-equal across tp ranks, and dp replicas
    bit-equal."""
    assert sharded[mesh]["same_bits"] == [True] * STEPS


@pytest.mark.parametrize("mesh,dp", [("dp2xtp4", 2), ("tp2", 1)])
def test_collectives_a_step_follow_the_formula(sharded, mesh, dp):
    L = S._shardable_cfg().talker.num_hidden_layers
    want = {"forward": {"all_reduce": 2 * L + (dp > 1), "all_gather": 1},
            "backward": {"all_reduce": 2 * L + 1 + 1 + (dp > 1)}}
    assert sharded[mesh]["per_step"] == [want] * STEPS


def test_forward_alone_makes_the_serving_collectives(sharded):
    L = S._shardable_cfg().talker.num_hidden_layers
    want = {"forward": {"all_reduce": 2 * L, "all_gather": 1}, "backward": {"all_reduce": 0}}
    for mesh in sharded:
        assert sharded[mesh]["forward_only"] == {"inference": want, "grad": want}, mesh


def test_train_ranks_import_no_jax(sharded):
    for mesh in sharded:
        assert sharded[mesh]["jax_modules"] == [], mesh


def test_train_step_refuses_what_it_cannot_train(jax_params):
    tk = S._shardable_cfg().talker
    if not torch.cuda.is_available():  # the card by default; never the CPU by itself
        with pytest.raises(RuntimeError, match='device="cpu"'):
            S.make_train_step(tk)
    with torch.inference_mode():
        params = S._host(jax_params, torch.float32)
    init_opt, step = S.make_train_step(tk, None, LR, device="cpu")
    embeds, targets = np.zeros((2, 4, tk.hidden_size), np.float32), np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="inference_mode"):
        step(params, init_opt(S._host(jax_params, torch.float32)), embeds, targets,
             np.zeros(2, np.int32))
