"""First-party CTC speech recognizer for the demo's ``/transcribe``.

Port of ``qwen3tts_tpu/models/asr.py``:

  log-mel 80 at 16 kHz (``models/speaker.py:log_mel``)
  -> 2 strided convs (kernel 3, stride 2: 4x fewer frames), each with relu
  -> N residual blocks (layer norm, kernel-5 conv to 2C, GLU)
  -> a linear CTC head over a character vocabulary,

then a greedy CTC decode on the host (collapse repeats, drop blanks).

Activations run channels-first ``[B, C, T]`` for ``F.conv1d``; conv weights
are held ``[Cout, Cin, K]``.  A checkpoint on disk keeps the JAX layout
(``config.json`` + ``model.safetensors`` of the ``/``-joined pytree, conv
weights ``[K, Cin, Cout]``), so each package loads what the other wrote, and
both load the committed ``samples/asr/ctc_selftrained``.

Every conv pads as XLA's ``"SAME"`` does: ``ceil(T / s)`` outputs and
``(ceil(T/s) - 1)·s + k - T`` padding, the smaller half on the left (at
stride 2 and an even length all of it goes on the right, where
``nn.Conv1d(padding=1)`` would put one on each side).  The mel is padded to
the next multiple of 256 frames with the frontend's silence floor, as in the
JAX package, so the logits of the valid frames are the same function of the
audio in both packages.

The forward is plain eager torch (the JAX ``jax.jit`` has no counterpart);
``warmup`` builds cuDNN's plans on the card.  The convs run as cuDNN runs a
float32 conv by default, in TF32 on the H100: over the 16 committed clips
the logits moved by at most 0.0574 against the CPU's, with every transcript
equal, and by 1.2e-4 with TF32 off (``chip_smoke.py`` slice-demo, NVIDIA
H100 80GB HBM3, 700.00 W).  As no transcript moved, the recognizer keeps
the default, and it never sets ``torch.backends.cudnn.allow_tf32``: the
flag is the process's, and the codec's convs of a concurrent TTS request
read it too.  ``random:ctc-*`` weights come from a seeded
``torch.Generator`` with the JAX initialisers' scales, not JAX's numbers.
Everything runs on the card unless ``device`` names another.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.wav import resample
from ..core import safetensors_io
from ..core.loader import (_conv, _conv_to_jax, _t, _to_jax_tree, _tree, flatten,
                           resolve_device, unflatten)
from .layers import randn
from .speaker import log_mel

Params = Dict

# index 0 is the CTC blank
VOCAB = ["<blank>"] + list("abcdefghijklmnopqrstuvwxyz '") + list("0123456789")
_MEL_BUCKET = 256
_LOG_MEL_PAD = -23.0  # log(1e-10): the frontend's silence floor


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    n_mels: int = 80
    channels: int = 192
    num_layers: int = 4
    kernel: int = 5
    vocab_size: int = len(VOCAB)
    sample_rate: int = 16_000

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


PRESETS = {
    "ctc-tiny": ASRConfig(channels=64, num_layers=2),
    "ctc-base": ASRConfig(),
}


def init_params(gen: torch.Generator, cfg: ASRConfig, device) -> Params:
    """Random float32 parameters: conv and head weights N(0, fan_in^-0.5),
    biases 0, norm gains 1."""
    C, K, f32 = cfg.channels, cfg.kernel, torch.float32

    def conv(k, cin, cout):
        return {"w": randn(gen, (cout, cin, k), (k * cin) ** -0.5, f32, device),
                "b": torch.zeros(cout, dtype=f32, device=device)}

    return {
        "down1": conv(3, cfg.n_mels, C),
        "down2": conv(3, C, C),
        "blocks": [{"conv": conv(K, C, 2 * C), "norm": torch.ones(C, dtype=f32, device=device)}
                   for _ in range(cfg.num_layers)],
        "head": {"w": randn(gen, (C, cfg.vocab_size), C ** -0.5, f32, device),
                 "b": torch.zeros(cfg.vocab_size, dtype=f32, device=device)},
    }


def asr_params_from_jax_numpy(tree: Dict, device=None) -> Params:
    """A JAX CTC recognizer's parameters (``qwen3tts_tpu/models/asr.py``, or
    a checkpoint of its layout; numpy, JAX or torch leaves) -> the port's on
    ``device``, float32, conv weights ``[Cout, Cin, K]``."""
    device = resolve_device(device)
    f32 = torch.float32
    return {
        "down1": _conv(tree["down1"], device),
        "down2": _conv(tree["down2"], device),
        "blocks": [{"conv": _conv(b["conv"], device), "norm": _t(b["norm"], f32, device)}
                   for b in tree["blocks"]],
        "head": _tree(tree["head"], f32, device),
    }


def asr_params_to_jax_layout(params: Params, device="cpu") -> Dict:
    """The inverse of ``asr_params_from_jax_numpy``: conv weights back to
    ``[K, Cin, Cout]``; what ``CTCRecognizer.save_pretrained`` writes."""
    return {
        "down1": _conv_to_jax(params["down1"], device),
        "down2": _conv_to_jax(params["down2"], device),
        "blocks": [{"conv": _conv_to_jax(b["conv"], device), "norm": b["norm"].to(device)}
                   for b in params["blocks"]],
        "head": _to_jax_tree(params["head"], device),
    }


def _same_pad(T: int, k: int, stride: int):
    """XLA's ``"SAME"`` padding (left, right) of a length-``T`` input."""
    total = max((-(-T // stride) - 1) * stride + k - T, 0)
    return total // 2, total - total // 2


def _conv1d(x: torch.Tensor, p: Params, stride: int = 1) -> torch.Tensor:
    """x [B, Cin, T] -> [B, Cout, ceil(T / stride)], XLA ``"SAME"`` padding."""
    x = F.pad(x, _same_pad(x.shape[-1], p["w"].shape[-1], stride))
    return F.conv1d(x, p["w"], p["b"], stride=stride)


def _layer_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Over the channels of x [B, C, T]: a gain, no bias."""
    mu = x.mean(1, keepdim=True)
    var = (x - mu).square().mean(1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g[:, None]


def forward(params: Params, mel: torch.Tensor) -> torch.Tensor:
    """mel [T, n_mels] -> CTC logits [ceil(T / 4), vocab]; a batch [B, T,
    n_mels] -> [B, ceil(T / 4), vocab], each row as alone (JAX's
    ``jax.vmap(forward)`` in ``tools/train_asr.py``)."""
    x = mel.transpose(-1, -2)
    x = x[None] if mel.dim() == 2 else x
    x = torch.relu(_conv1d(x, params["down1"], stride=2))
    x = torch.relu(_conv1d(x, params["down2"], stride=2))
    for blk in params["blocks"]:
        a, b = _conv1d(_layer_norm(x, blk["norm"]), blk["conv"]).chunk(2, dim=1)
        x = x + a * torch.sigmoid(b)  # GLU, residual
    out = x.transpose(1, 2) @ params["head"]["w"] + params["head"]["b"]
    return out[0] if mel.dim() == 2 else out


def cer(ref: str, hyp: str) -> float:
    """Character error rate: edit distance / len(ref)."""
    if not ref:
        return float(len(hyp) > 0)
    prev = list(range(len(hyp) + 1))
    for i, rc in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, hc in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (rc != hc))
        prev = cur
    return prev[-1] / len(ref)


def greedy_ctc_decode(token_ids: np.ndarray) -> str:
    """Frame-wise argmax ids -> text: collapse repeats, drop blanks."""
    out = []
    prev = -1
    for t in np.asarray(token_ids).ravel():
        if t != prev and t != 0:
            out.append(VOCAB[int(t)])
        prev = t
    return "".join(out).strip()


class CTCRecognizer:
    """``from_pretrained(...)``, ``transcribe(wav, sr) -> str``, ``warmup()``
    (the surface of the reference demo's recognizer)."""

    def __init__(self, cfg: ASRConfig, params: Params):
        self.cfg = cfg
        self.params = params
        self.device = params["head"]["w"].device

    @classmethod
    def from_pretrained(cls, ref: str = "random:ctc-base", seed: int = 0,
                        device=None) -> "CTCRecognizer":
        """``random:ctc-tiny`` / ``random:ctc-base`` or a checkpoint directory,
        on ``device`` (default: the card; with no card, pass ``device="cpu"``
        or it raises)."""
        device = resolve_device(device)
        if ref.startswith("random:"):
            cfg = PRESETS[ref.split(":", 1)[1]]
            gen = torch.Generator(device=device).manual_seed(seed)
            return cls(cfg, init_params(gen, cfg, device))
        path = Path(ref)
        cfg = ASRConfig.from_dict(json.loads((path / "config.json").read_text()))
        flat = safetensors_io.load_file(path / "model.safetensors")
        return cls(cfg, asr_params_from_jax_numpy(unflatten(flat), device))

    def save_pretrained(self, path) -> None:
        """``config.json`` + ``model.safetensors`` in the JAX package's layout."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "config.json").write_text(json.dumps(self.cfg.to_dict()))
        safetensors_io.save_file(flatten(asr_params_to_jax_layout(self.params)),
                                 path / "model.safetensors")

    def logits(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """CTC logits [ceil(T / 4), vocab] of the valid mel frames, float32."""
        wav = resample(np.asarray(wav, np.float32).ravel(), sr, self.cfg.sample_rate)
        with torch.inference_mode():
            mel = log_mel(torch.from_numpy(np.ascontiguousarray(wav)).to(self.device),
                          self.cfg.n_mels, self.cfg.sample_rate)
            T = mel.shape[0]
            Tb = max(_MEL_BUCKET, -(-T // _MEL_BUCKET) * _MEL_BUCKET)
            mel = F.pad(mel, (0, 0, 0, Tb - T), value=_LOG_MEL_PAD)
            out = forward(self.params, mel)[: -(-T // 4)]  # the convs' 4x downsample
            return out.float().cpu().numpy()

    def transcribe(self, wav: np.ndarray, sr: int) -> str:
        return greedy_ctc_decode(np.argmax(self.logits(wav, sr), axis=-1))

    def warmup(self):
        self.transcribe(np.zeros(self.cfg.sample_rate, np.float32), self.cfg.sample_rate)


def default_checkpoint() -> str:
    """The committed self-trained checkpoint (``samples/asr/ctc_selftrained``)
    when present, else random weights."""
    ckpt = Path(__file__).resolve().parents[2] / "samples/asr/ctc_selftrained"
    if (ckpt / "model.safetensors").exists():
        return str(ckpt)
    return "random:ctc-base"


def builtin_asr(ref: Optional[str] = None, warmup: bool = True, device=None):
    """The demo server's hook: returns ``(audio, sr) -> str``.  ``ref=None``
    takes ``default_checkpoint()``; ``warmup`` runs one transcription first,
    so that the first ``/transcribe`` does not build cuDNN's plans."""
    rec = CTCRecognizer.from_pretrained(ref or default_checkpoint(), device=device)
    if warmup:
        rec.warmup()
    return rec.transcribe
