"""The training half on the card: the talker train step
(``parallel/sharding.py:make_train_step``) and the ASR tool
(``tools/train_asr.py``) against the port on the CPU.

- The talker step on the tiny shardable config, float32 with TF32 off, 3
  steps at lr 1e-2: the card's losses within 1e-5 relative of the CPU's,
  its params as the CPU tests hold them against JAX.
- ``train(mel_jitter=False)`` on a seeded 16-utterance dataset, cuDNN's
  TF32 off: the card's epoch losses within 1e-4 relative, its params as
  the CPU test holds them against JAX.
- ``make_train_step``, ``train`` and ``main`` take the card when given no
  device, and raise (naming ``device="cpu"``) when torch sees none.

These need an NVIDIA card and skip elsewhere.  The card's machine has no
JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda_train.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

LR, STEPS = 1e-2, 3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.fixture
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _held(got: dict, want: dict, outliers: float, max_abs: float):
    """Every element within 1e-5 + 1e-4 |ref| but at most ``outliers`` of a
    leaf (Adam moves an element whose gradient is at noise level by ~lr
    either way), and those within ``max_abs``."""
    from qwen3tts_tpu_torch.utils import optim

    want = dict(optim.named_leaves(want))
    for name, x in optim.named_leaves(got):
        x, ref = x.cpu().numpy(), want[name].cpu().numpy()
        d = np.abs(x - ref)
        assert (d > 1e-5 + 1e-4 * np.abs(ref)).sum() <= outliers * ref.size, name
        assert d.max() <= max_abs, (name, float(d.max()))


def _talker_run(device):
    from qwen3tts_tpu_torch.models import talker as T
    from qwen3tts_tpu_torch.parallel import sharding as S

    tk = S._shardable_cfg().talker
    params = T.init_params(torch.Generator().manual_seed(0), tk, torch.float32, "cpu")
    params = S._placed(params, torch.device(device or "cuda"))
    rs = np.random.RandomState(0)
    batch = ((rs.randn(4, 16, tk.hidden_size) * 0.02).astype(np.float32),
             rs.randint(0, tk.vocab_size, (4, 16)).astype(np.int32),
             np.array([0, 3, 5, 0], np.int32))
    init_opt, step = S.make_train_step(tk, None, LR, device=device)
    state, losses = init_opt(params), []
    for _ in range(STEPS):
        params, state, loss = step(params, state, *batch)
        losses.append(loss.item())
    return params, np.array(losses)


@pytest.mark.cuda
def test_talker_step_card_equals_cpu(no_tf32):
    _need_card()
    card, card_losses = _talker_run(None)  # no device: the card
    assert card["final_norm"].is_cuda
    cpu, cpu_losses = _talker_run("cpu")
    assert card_losses[-1] < card_losses[0]
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-5)
    _held(card, cpu, 1e-4, LR / 50)


def _asr_data():
    from qwen3tts_tpu_torch.models import asr as A

    rs = np.random.RandomState(3)
    N, T, L = 16, 128, 12
    mels = np.full((N, T, 80), A._LOG_MEL_PAD, np.float32)
    mel_lens = rs.randint(64, T + 1, N).astype(np.int32)
    labels = np.zeros((N, L), np.int32)
    lab_lens = rs.randint(4, L + 1, N).astype(np.int32)
    for i in range(N):
        mels[i, :mel_lens[i]] = rs.randn(mel_lens[i], 80) * 2.0 - 6.0
        labels[i, :lab_lens[i]] = rs.randint(1, len(A.VOCAB), lab_lens[i])
    return mels, mel_lens, labels, lab_lens, (rs.randn(N) * 0.3 - 2.5).astype(np.float32)


@pytest.mark.cuda
def test_asr_train_card_equals_cpu(no_tf32):
    _need_card()
    from qwen3tts_tpu_torch.models import asr as A
    from qwen3tts_tpu_torch.tools import train_asr as TA

    cfg = A.ASRConfig(channels=32, num_layers=1)
    init = A.asr_params_to_jax_layout(
        A.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    runs = {}
    for device in (None, "cpu"):
        losses = []
        params = TA.train(cfg, _asr_data(), epochs=2, batch=8, mel_jitter=False, init=init,
                          device=device, losses=losses)
        runs[device] = (params, np.array(losses))
    assert runs[None][0]["head"]["w"].is_cuda
    np.testing.assert_allclose(runs[None][1], runs["cpu"][1], rtol=1e-4)
    _held(runs[None][0], runs["cpu"][0], 1e-3, 4e-4 / 10)


@pytest.mark.cuda
def test_main_takes_the_card(tmp_path):
    _need_card()
    from qwen3tts_tpu_torch.tools import train_asr as TA

    # 4 texts x 3 voices x 3 perturbations: one batch of 32 an epoch
    res = TA.main(["--model", "random:qwen3-tts-0.6b", "--n-train", "4", "--n-eval", "2",
                   "--epochs", "2", "--channels", "16", "--layers", "1",
                   "--out", str(tmp_path / "asr")])
    assert res["device"] == "cuda" and np.isfinite(res["losses"]).all()
    assert (tmp_path / "asr" / "ctc_selftrained" / "model.safetensors").exists()


@pytest.mark.cuda
def test_no_card_raises(monkeypatch, tmp_path):
    _need_card()
    from qwen3tts_tpu_torch.models import asr as A
    from qwen3tts_tpu_torch.parallel import sharding as S
    from qwen3tts_tpu_torch.tools import train_asr as TA

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        S.make_train_step(S._shardable_cfg().talker)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TA.train(A.ASRConfig(channels=16, num_layers=1), _asr_data())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TA.main(["--out", str(tmp_path / "x")])
