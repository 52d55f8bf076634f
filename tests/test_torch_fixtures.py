"""Golden fixtures across the two packages (``core/fixtures.py``), on the CPU.

A fixture the JAX package's ``export_model_fixture`` wrote on ``random:tiny``
(float32) passes the port's ``check_model_fixture`` on the same weights
(carried across by ``bundle_from_jax_numpy``), with the prefill checksum and
every token equal; a fixture the port wrote passes JAX's check; and the
port tells decode drift from prompt drift as ``tests/test_fixtures.py``
does.  Both policies are greedy, so the tokens do not depend on the two
packages' different random streams.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402

from qwen3tts_tpu.core import fixtures as JF  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.core import fixtures as F  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402

TEXT = "parity check"
STEPS = 10


@pytest.fixture(scope="module")
def port_tts(tiny_tts):
    cfg = get_preset("tiny")
    return FasterQwen3TTS(cfg, bundle_from_jax_numpy(jax.tree.map(np.asarray, tiny_tts.params),
                                                     cfg, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def fixtures(tiny_tts, port_tts, tmp_path_factory):
    root = tmp_path_factory.mktemp("golden")
    jmeta = JF.export_model_fixture(tiny_tts, root / "jax.npz", text=TEXT,
                                    max_new_tokens=STEPS)
    pmeta = F.export_model_fixture(port_tts, root / "port.npz", text=TEXT,
                                   max_new_tokens=STEPS)
    return root / "jax.npz", jmeta, root / "port.npz", pmeta


def test_port_writes_what_jax_writes(fixtures):
    jpath, jmeta, ppath, pmeta = fixtures
    assert pmeta == jmeta
    jt, jm, _ = JF.load_fixture(jpath)
    pt, pm, _ = F.load_fixture(ppath)
    assert pm == jm and pm["fixture_version"] == F.FIXTURE_VERSION == JF.FIXTURE_VERSION
    assert pt.dtype == np.int32 and pt.shape == jt.shape == (STEPS, 16)
    np.testing.assert_array_equal(pt, jt)
    assert len(pm["prefill_sha256"]) == 64 and pm["greedy"]


def test_jax_fixture_passes_port_check(port_tts, fixtures):
    F.check_model_fixture(port_tts, fixtures[0])  # no raise == parity


def test_port_fixture_passes_jax_check(tiny_tts, fixtures):
    JF.check_model_fixture(tiny_tts, fixtures[2])


def test_stored_embeds_round_trip(port_tts, tmp_path):
    meta = F.export_model_fixture(port_tts, tmp_path / "e.npz", text=TEXT, max_new_tokens=2,
                                  store_embeds=True)
    _, meta2, pe = F.load_fixture(tmp_path / "e.npz")
    assert meta2["prefill_sha256"] == F._embeds_sha256(pe) and meta2["text"] == meta["text"]
    _, jmeta, jpe = JF.load_fixture(tmp_path / "e.npz")
    np.testing.assert_array_equal(jpe, pe)


def _rewrite(path, out, tokens=None, meta=None):
    t, m, _ = F.load_fixture(path)
    np.savez(out, tokens=t if tokens is None else tokens,
             meta=np.frombuffer(json.dumps(m if meta is None else meta).encode(), np.uint8))
    return out


def test_port_check_detects_decode_drift(port_tts, fixtures, tmp_path):
    tokens, _, _ = F.load_fixture(fixtures[0])
    bad = tokens.copy()
    bad[1, 0] = (bad[1, 0] + 1) % 100
    with pytest.raises(AssertionError, match="DECODE drift: first token mismatch at step 1"):
        F.check_model_fixture(port_tts, _rewrite(fixtures[0], tmp_path / "bad.npz", tokens=bad))
    with pytest.raises(AssertionError, match="DECODE drift: .* steps vs golden"):
        F.check_model_fixture(port_tts, _rewrite(fixtures[0], tmp_path / "short.npz",
                                                 tokens=tokens[:-1]))


def test_port_check_detects_prompt_drift(port_tts, fixtures, tmp_path):
    _, meta, _ = F.load_fixture(fixtures[0])
    meta["prefill_sha256"] = "0" * 64
    with pytest.raises(AssertionError, match="PROMPT ASSEMBLY drift"):
        F.check_model_fixture(port_tts, _rewrite(fixtures[0], tmp_path / "sha.npz", meta=meta))


def test_newer_fixture_version_refused(fixtures, tmp_path):
    _, meta, _ = F.load_fixture(fixtures[0])
    meta["fixture_version"] = F.FIXTURE_VERSION + 1
    with pytest.raises(ValueError, match="newer format version"):
        F.load_fixture(_rewrite(fixtures[0], tmp_path / "new.npz", meta=meta))


def test_float32_matmuls_restores_flags():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with F.float32_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_custom_voice_fixture_round_trip(tmp_path):
    """A custom-voice fixture (``--speaker``) replays on the model that wrote
    it; it is held to its tokens (no checksum contract, as in JAX)."""
    m = FasterQwen3TTS.from_pretrained("random:tiny-custom", device="cpu", dtype="float32")
    meta = F.export_model_fixture(m, tmp_path / "c.npz", text=TEXT, speaker="aiden",
                                  max_new_tokens=4)
    assert meta["mode"] == "custom" and meta["speaker"] == "aiden"
    F.check_model_fixture(m, tmp_path / "c.npz")
    tokens, meta, _ = F.load_fixture(tmp_path / "c.npz")
    meta["prefill_sha256"] = "0" * 64
    F.check_model_fixture(m, _rewrite(tmp_path / "c.npz", tmp_path / "sha.npz", meta=meta))
    bad = tokens.copy()
    bad[0, 5] += 1
    with pytest.raises(AssertionError, match="DECODE drift"):
        F.check_model_fixture(m, _rewrite(tmp_path / "c.npz", tmp_path / "bad.npz", tokens=bad))
