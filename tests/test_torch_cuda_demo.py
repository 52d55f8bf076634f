"""The web demo and its CTC recognizer on the card.

- The recognizer on the committed checkpoint (``samples/asr/ctc_selftrained``)
  on the card against the same on the CPU, over the 16 committed clips:
  every transcript equal, the logits within TF32_ATOL as cuDNN runs the
  convs by default (TF32) and within ASR_ATOL with TF32 off.
- One streamed clone request through the demo server with its model on the
  card: the events are ``chunk`` ... ``done``, every chunk whole codec frames
  of finite audio, and ``/status`` reports ``cuda:0``.

These need an NVIDIA card and nvcc, and skip elsewhere.  The card's machine
has no JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda_demo.py -q
"""
import base64
import dataclasses
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
ASR_ATOL = 1e-3  # float32 logits, card vs CPU, TF32 off: another summation order (1.2e-4)
# cuDNN's default for float32 convs, TF32, rounds each input to 10 mantissa
# bits: logits of magnitude ~20 moved by up to 0.0574 on the H100
TF32_ATOL = 0.1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_recognizer_on_card_matches_cpu():
    _need_card()
    from qwen3tts_tpu_torch.audio.wav import read_wav
    from qwen3tts_tpu_torch.models import asr

    card = asr.CTCRecognizer.from_pretrained(asr.default_checkpoint())
    cpu = asr.CTCRecognizer.from_pretrained(asr.default_checkpoint(), device="cpu")
    assert card.device.type == "cuda"
    manifest = json.loads((REPO / "samples/asr/manifest.json").read_text())
    assert len(manifest) == 16
    clips = [read_wav(str(REPO / "samples/asr" / e["wav"])) for e in manifest]
    for (wav, sr), e in zip(clips, manifest):
        a, b = card.logits(wav, sr), cpu.logits(wav, sr)
        assert np.isfinite(a).all() and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TF32_ATOL, err_msg=e["wav"])
        assert card.transcribe(wav, sr) == cpu.transcribe(wav, sr), e["wav"]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for (wav, sr), e in zip(clips, manifest):
            np.testing.assert_allclose(card.logits(wav, sr), cpu.logits(wav, sr), rtol=0,
                                       atol=ASR_ATOL, err_msg=e["wav"])
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _small_model():
    """A small float32 model whose talker has a flash-decode instance on the
    card (head_dim 128)."""
    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset

    base = get_preset("tiny")
    cfg = dataclasses.replace(
        base, talker=dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20)))
    return FasterQwen3TTS(cfg, init_random(cfg, seed=8, dtype=torch.float32, device="cuda"),
                          max_seq_len=256)


@pytest.mark.cuda
def test_demo_streams_on_card():
    _need_card()
    from qwen3tts_tpu_torch.apps import demo_server
    from qwen3tts_tpu_torch.audio.wav import read_wav

    httpd, state = demo_server.serve(models=["small"], dtype="fp32", host="127.0.0.1", port=0)
    assert state.device.type == "cuda"
    state.model_cache["small"] = _small_model()  # the tiny preset has no flash-decode instance
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/status") as r:
            assert "cuda:0" in json.loads(r.read())["device_memory"]
        body = {"mode": "clone", "model": "small", "text": "On the card.",
                "preset_ref": "preset_low", "chunk_size": 8, "max_new_tokens": 24}
        req = urllib.request.Request(url + "/generate/stream", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            events = [json.loads(line[6:]) for line in r.read().decode().split("\n\n")
                      if line.startswith("data: ")]
        kinds = [e["event"] for e in events]
        assert kinds[-1] == "done" and set(kinds[:-1]) == {"chunk"}, events[-1]
        for e in events[:-1]:
            audio, sr = read_wav(base64.b64decode(e["wav_b64"]))
            assert sr == 24_000 and len(audio) > 0 and len(audio) % 2000 == 0
            assert np.isfinite(audio).all()
    finally:
        httpd.shutdown()
        httpd.server_close()
