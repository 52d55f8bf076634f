"""The port's ASR self-training tool (``qwen3tts_tpu_torch/tools/train_asr.py``)
and the batched recognizer forward against the JAX package, on the CPU.

- The batched ``forward`` [B, T, n_mels] against JAX's per-utterance
  ``forward`` (what ``jax.vmap`` runs), within 1e-5 + 1e-5 |ref|
  (summation order: logits up to ~5 differ by ~1e-5).
- ``ctc_loss`` (``F.ctc_loss`` as the tool wraps it) and its gradient
  against ``optax.ctc_loss`` (divided and averaged as JAX's tool does) on
  seeded logits and paddings that all have an alignment: 1e-5 relative on
  the loss, 1e-4 of the largest gradient (both run the forward-backward
  recursion in float32 log space, in other orders: 5e-5 seen).
- The jitter's deterministic half on given draws: with no draw it is the
  identity on the valid frames' PAD lead; a gain shifts the valid frames
  by 2 ln g; a shift rolls them behind PAD and lengthens the utterance;
  the noise floor is ``logaddexp``, only on valid frames.
- The tool's numpy pieces (``make_texts``, ``augment``) and its features
  against JAX's: texts and perturbations bit-equal, ``noise_mel_floor``
  and ``featurize``'s mels within 2e-3 (log-power; float32 FFTs).
- ``train(mel_jitter=False)`` against JAX's ``tools/train_asr.py:train``
  from JAX's initial params: 2 epochs of a seeded 16-utterance dataset at
  32 channels x 1 layer, batch 8.  JAX's tool runs in a subprocess: its
  import sets ``jax_num_cpu_devices``, which raises once JAX has started
  (as conftest starts it).
- ``main`` end to end at a toy size into ``tmp_path``: its checkpoint
  loads in both packages' ``CTCRecognizer``, which transcribe the gate
  clips it wrote alike; an ``--out`` under the repository's ``samples/`` is
  refused.
- The tool, the optimiser and the train step run with JAX, optax and the
  JAX package blocked from import.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the tier-1 run's workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from qwen3tts_tpu.models import asr as jasr  # noqa: E402
from qwen3tts_tpu.models import speaker as jspeaker  # noqa: E402
from qwen3tts_tpu_torch.models import asr as A  # noqa: E402
from qwen3tts_tpu_torch.tools import train_asr as TA  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CFG = A.ASRConfig(channels=32, num_layers=1)
MEL_T, LAB_L, N = 128, 12, 16
# After 4 Adam steps (the first at lr 0 of the warm-up) a parameter moves
# ~lr a step whatever its gradient's size, so an element whose gradient is
# at float32 noise level may move another way: held within 1e-5 + 1e-4 |ref|
# but at most 1 in 1,000 of a leaf, and those within lr / 10.
PARAM_ATOL, PARAM_RTOL, PARAM_OUTLIERS, PARAM_MAX = 1e-5, 1e-4, 1e-3, 4e-4 / 10


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}/{k}" if prefix else k).items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def jax_init():
    return jax.tree.map(np.asarray, jasr.init_params(jax.random.PRNGKey(0), CFG))


@pytest.fixture(scope="module")
def dataset():
    """16 utterances: mels of 64-128 valid frames (PAD after), 4-12
    labels of 1..38, log RMS."""
    rs = np.random.RandomState(3)
    mels = np.full((N, MEL_T, CFG.n_mels), A._LOG_MEL_PAD, np.float32)
    mel_lens = rs.randint(64, MEL_T + 1, N).astype(np.int32)
    labels = np.zeros((N, LAB_L), np.int32)
    lab_lens = rs.randint(4, LAB_L + 1, N).astype(np.int32)
    for i in range(N):
        mels[i, :mel_lens[i]] = rs.randn(mel_lens[i], CFG.n_mels) * 2.0 - 6.0
        labels[i, :lab_lens[i]] = rs.randint(1, len(A.VOCAB), lab_lens[i])
    log_rms = (rs.randn(N) * 0.3 - 2.5).astype(np.float32)
    return mels, mel_lens, labels, lab_lens, log_rms


_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[1] + "/tools")
    import train_asr as T  # sets jax_num_cpu_devices before any JAX op
    import jax
    from qwen3tts_tpu.core.loader import flatten
    from qwen3tts_tpu.models.asr import ASRConfig
    d = np.load(sys.argv[2])
    cfg = ASRConfig(channels=32, num_layers=1)
    data = tuple(d[k] for k in ("mels", "mel_lens", "labels", "lab_lens", "log_rms"))
    params = T.train(cfg, data, epochs=2, batch=8, seed=0, mel_jitter=False)
    out = {"params/" + k: np.asarray(v) for k, v in flatten(params).items()}
    rs = np.random.RandomState(5)
    wav = rs.randn(24_000).astype(np.float32) * 0.1
    out["augment"] = np.concatenate([T.augment(wav, np.random.RandomState(s))
                                     for s in (1_000_000, 7_000_003)])
    out["floor"] = T.noise_mel_floor(cfg)
    np.savez(sys.argv[3], **out)
    print(json.dumps({"texts": T.make_texts(20, 11), "unseen": T.make_texts(8, 97)}))
""")


@pytest.fixture(scope="module")
def jax_tool(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_tool")
    np.savez(d / "data.npz", **dict(zip(("mels", "mel_lens", "labels", "lab_lens", "log_rms"),
                                        dataset)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO), str(d / "data.npz"),
                          str(d / "out.npz")], capture_output=True, text=True, env=env,
                         timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-4000:]
    z = np.load(d / "out.npz")
    return {k: z[k] for k in z.files}, json.loads(res.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the batched forward and the loss
# ---------------------------------------------------------------------------


def test_batched_forward_equals_jax_per_utterance(jax_init, dataset):
    mels = dataset[0][:4]
    got = A.forward(A.asr_params_from_jax_numpy(jax_init, "cpu"), torch.tensor(mels))
    assert got.shape == (4, MEL_T // 4, CFG.vocab_size)
    for i, m in enumerate(mels):
        want = np.asarray(jasr.forward(jax.tree.map(jnp.asarray, jax_init), CFG, jnp.asarray(m)))
        np.testing.assert_allclose(got[i].detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_ctc_loss_and_grad_equal_optax(dataset):
    _, mel_lens, labels, lab_lens, _ = dataset
    Tl = MEL_T // 4
    logits = np.random.RandomState(9).randn(N, Tl, CFG.vocab_size).astype(np.float32) * 3.0
    TA.check_alignable(mel_lens, labels, lab_lens, MEL_T)  # every pair can align

    def jloss(lg):
        frames = jnp.arange(Tl)[None, :]
        logit_pad = (frames >= jnp.ceil(jnp.asarray(mel_lens) / 4)[:, None]).astype(jnp.float32)
        lab_pad = (jnp.arange(LAB_L)[None, :] >= jnp.asarray(lab_lens)[:, None]).astype(
            jnp.float32)
        per = optax.ctc_loss(lg, logit_pad, jnp.asarray(labels), lab_pad)
        return jnp.mean(per / jnp.maximum(jnp.asarray(lab_lens), 1))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = TA.ctc_loss(x, torch.tensor(mel_lens), torch.tensor(labels), torch.tensor(lab_lens))
    (g,) = torch.autograd.grad(got, x)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    want_g = np.asarray(want_g)
    assert np.abs(g.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()


def test_no_alignment_is_refused(dataset):
    _, mel_lens, labels, lab_lens, _ = dataset
    short = mel_lens.copy()
    short[2] = 4 * (lab_lens[2] - 1)  # one frame fewer than its labels
    with pytest.raises(ValueError, match="utterance 2"):
        TA.check_alignable(short, labels, lab_lens, MEL_T)
    rep = labels.copy()
    rep[0, :2] = 5  # a repeat needs a blank between: one frame more
    lens = mel_lens.copy()
    lens[0] = 4 * lab_lens[0]
    with pytest.raises(ValueError, match="utterance 0"):
        TA.check_alignable(lens, rep, lab_lens, MEL_T)


# ---------------------------------------------------------------------------
# the jitter's deterministic half
# ---------------------------------------------------------------------------


def _draws(B, shape, gain=1.0, shift=0, snr_db=None):
    z = torch.zeros((B, 1, 1))
    return {"gain_ln": z + np.log(gain), "noise": torch.zeros(shape),
            "shift": torch.tensor(shift), "snr_db": z + (1e9 if snr_db is None else snr_db)}


def test_jitter_deterministic_half(dataset):
    mels, mel_lens, _, _, log_rms = dataset
    mel, ml, lr = torch.tensor(mels[:3]), torch.tensor(mel_lens[:3]), torch.tensor(log_rms[:3])
    floor = torch.tensor(TA.noise_mel_floor(CFG, "cpu"))
    valid = (torch.arange(MEL_T)[None, :, None] < ml[:, None, None]).expand_as(mel)
    # no gain, no shift, the floor ~1e9 dB down: valid frames unchanged
    out, out_len = TA.apply_mel_jitter(mel, ml, lr, floor, _draws(3, mel.shape))
    torch.testing.assert_close(out, mel, rtol=0, atol=1e-6)
    assert torch.equal(out_len, ml)
    # a gain g adds 2 ln g to the valid frames only
    out, _ = TA.apply_mel_jitter(mel, ml, lr, floor, _draws(3, mel.shape, gain=1.5))
    torch.testing.assert_close(out[valid], mel[valid] + 2 * np.log(1.5), rtol=0, atol=1e-5)
    assert torch.equal(out[~valid], mel[~valid])
    # a shift of k rolls behind a PAD lead and lengthens (at most to T)
    k = 7
    out, out_len = TA.apply_mel_jitter(mel, ml, lr, floor, _draws(3, mel.shape, shift=k))
    assert (out[:, :k] == A._LOG_MEL_PAD).all()
    torch.testing.assert_close(out[:, k:], mel[:, :-k], rtol=0, atol=1e-6)
    assert torch.equal(out_len, torch.clamp(ml + k, max=MEL_T))
    # white noise at an SNR: logaddexp with the floor at 2 ln sigma, valid only
    out, _ = TA.apply_mel_jitter(mel, ml, lr, floor, _draws(3, mel.shape, snr_db=20.0))
    sigma_ln = lr[:, None, None] - 20.0 * np.log(10.0) / 20.0
    want = torch.logaddexp(mel, floor[None, None, :] + 2 * sigma_ln)
    torch.testing.assert_close(out[valid], want[valid], rtol=0, atol=1e-5)
    assert torch.equal(out[~valid], mel[~valid])


def test_jitter_draws_distributions():
    g = torch.Generator().manual_seed(0)
    d = TA.jitter_draws(g, (4096, 8, 2), dropout=0.25)
    assert (d["gain_ln"] >= np.log(0.5)).all() and (d["gain_ln"] < np.log(1.6)).all()
    assert (d["snr_db"] >= 12.0).all() and (d["snr_db"] < 38.0).all()
    assert 0 <= int(d["shift"]) < 24
    assert abs(d["keep"].float().mean().item() - 0.75) < 0.01
    # the unmatched jitter: N(0, 1) times a std uniform in [0, 0.25)
    assert abs(d["noise"].std().item() - 0.25 / np.sqrt(3)) < 0.005


# ---------------------------------------------------------------------------
# the tool against JAX's
# ---------------------------------------------------------------------------


def test_numpy_pieces_equal_jax_tool(jax_tool):
    out, texts = jax_tool
    assert TA.make_texts(20, 11) == texts["texts"]
    assert TA.make_texts(8, 97) == texts["unseen"]
    rs = np.random.RandomState(5)
    wav = rs.randn(24_000).astype(np.float32) * 0.1
    mine = np.concatenate([TA.augment(wav, np.random.RandomState(s))
                           for s in (1_000_000, 7_000_003)])
    np.testing.assert_array_equal(mine, out["augment"])
    np.testing.assert_allclose(TA.noise_mel_floor(CFG, "cpu"), out["floor"], rtol=0, atol=2e-3)


def test_featurize_equals_jax_frontend():
    rs = np.random.RandomState(6)
    wavs = [rs.randn(n).astype(np.float32) * 0.1 for n in (24_000, 31_000)]
    texts = ["the cat", "it was hot"]
    mels, mel_lens, labels, lab_lens, log_rms = TA.featurize(wavs, texts, CFG, 256, 16, "cpu")
    for i, w in enumerate(wavs):
        want = np.asarray(jspeaker.log_mel(jnp.asarray(jasr._resample(w, 24_000, 16_000)),
                                           CFG.n_mels, CFG.sample_rate))
        assert mel_lens[i] == len(want)
        np.testing.assert_allclose(mels[i, :mel_lens[i]], want, rtol=0, atol=2e-3)
        assert (mels[i, mel_lens[i]:] == A._LOG_MEL_PAD).all()
        ids = [jasr._CHAR_TO_ID[c] for c in texts[i]]
        assert lab_lens[i] == len(ids) and labels[i, :len(ids)].tolist() == ids
        assert log_rms[i] == np.float32(np.log(np.sqrt((w ** 2).mean()) + 1e-12))


def test_train_equals_jax_train(jax_init, dataset, jax_tool):
    out, _ = jax_tool
    losses = []
    params = TA.train(CFG, dataset, epochs=2, batch=8, seed=0, mel_jitter=False, init=jax_init,
                      device="cpu", losses=losses)
    assert len(losses) == 2 and np.isfinite(losses).all()
    got = _flat(A.asr_params_to_jax_layout(params))
    want = {k[len("params/"):]: v for k, v in out.items() if k.startswith("params/")}
    assert sorted(got) == sorted(want)
    moved = 0
    for name, ref in want.items():
        x = got[name].astype(np.float32)
        d = np.abs(x - ref)
        bad = d > PARAM_ATOL + PARAM_RTOL * np.abs(ref)
        assert bad.sum() <= PARAM_OUTLIERS * ref.size, (name, int(bad.sum()), ref.size)
        assert d.max() <= PARAM_MAX, (name, float(d.max()))
        moved += int((np.abs(ref - _flat(jax_init)[name]) > 0).sum())
    assert moved > 0  # the steps changed the parameters


# ---------------------------------------------------------------------------
# main, end to end
# ---------------------------------------------------------------------------


def test_main_end_to_end_on_the_cpu(tmp_path):
    out = tmp_path / "asr"
    # 4 texts x 3 voices x 3 perturbations = 36 utterances: one batch of 32
    # an epoch (JAX's schedule needs two steps in all)
    res = TA.main(["--model", "random:tiny", "--n-train", "4", "--n-eval", "2", "--epochs", "2",
                   "--channels", "16", "--layers", "1", "--device", "cpu", "--out", str(out)])
    assert res["device"] == "cpu" and len(res["losses"]) == 2
    assert np.isfinite(res["losses"]).all()
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["n_eval"] == 2 and metrics["channels"] == 16
    manifest = json.loads((out / "manifest.json").read_text())
    mine = A.CTCRecognizer.from_pretrained(str(out / "ctc_selftrained"), device="cpu")
    theirs = jasr.CTCRecognizer.from_pretrained(str(out / "ctc_selftrained"))
    from qwen3tts_tpu_torch.audio.wav import read_wav

    for item in manifest:
        wav, sr = read_wav(out / item["wav"])
        assert mine.transcribe(wav, sr) == theirs.transcribe(wav, sr), item


def test_main_refuses_samples_and_needs_a_device(tmp_path):
    with pytest.raises(ValueError, match="samples/"):
        TA.main(["--out", str(REPO / "samples" / "asr"), "--device", "cpu"])
    if not torch.cuda.is_available():  # the card by default; never the CPU by itself
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TA.main(["--out", str(tmp_path / "x")])
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TA.train(CFG, None)


def test_training_modules_run_without_jax():
    """The tool, the optimiser and the train step import and run with
    ``jax``, ``optax`` and ``qwen3tts_tpu`` blocked."""
    script = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "optax", "qwen3tts_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch

        torch.set_num_threads(1)
        from qwen3tts_tpu_torch.models import asr
        from qwen3tts_tpu_torch.models import talker as T
        from qwen3tts_tpu_torch.parallel import sharding as S
        from qwen3tts_tpu_torch.tools import train_asr

        cfg = asr.ASRConfig(channels=8, num_layers=1)
        rs = np.random.RandomState(0)
        data = (rs.randn(8, 64, 80).astype(np.float32), np.full(8, 64, np.int32),
                np.ones((8, 4), np.int32), np.full(8, 4, np.int32), np.zeros(8, np.float32))
        losses = []
        train_asr.train(cfg, data, epochs=2, batch=4, device="cpu", losses=losses)
        tk = S._shardable_cfg().talker
        params = T.init_params(torch.Generator().manual_seed(0), tk, torch.float32, "cpu")
        init_opt, step = S.make_train_step(tk, None, 1e-3, device="cpu")
        _, _, loss = step(params, init_opt(params), rs.randn(2, 4, 64).astype(np.float32),
                          np.zeros((2, 4), np.int32), np.zeros(2, np.int32))
        assert np.isfinite(losses).all() and np.isfinite(loss.item())
        assert not any(k.split(".")[0] in ("jax", "optax", "qwen3tts_tpu") for k in sys.modules)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]
