"""The port's command line (``qwen3tts_tpu_torch/apps/cli.py``), on the CPU.

Every subcommand runs through ``main`` on a canonical checkpoint the port
saved from the JAX ``random:tiny`` weights (``--device cpu``): ``clone``
writes a wav of whole codec frames, non-streamed and streamed;
``custom --list-speakers`` prints the JAX CLI's names; ``check-checkpoint``
exits 0 / 1 with the JAX CLI's report; ``serve`` answers two stdin lines
and stops at ``exit``; ``export-fixture`` / ``check-fixture`` give PASS /
FAIL exit codes.  With no ``--device`` and no card, a subcommand that loads
a model raises the RuntimeError that names ``device="cpu"``.
"""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402

from qwen3tts_tpu.apps import cli as jcli  # noqa: E402
from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.apps import cli  # noqa: E402
from qwen3tts_tpu_torch.audio.wav import read_wav, write_wav  # noqa: E402
from qwen3tts_tpu_torch.core import loader  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402

SPF = 2000  # samples a codec frame at 24 kHz


@pytest.fixture(scope="module")
def dirs(tiny_tts, tmp_path_factory):
    """(canonical dir, sharded torch-layout dir, broken torch-layout dir,
    reference wav), written by the port from the JAX tiny weights."""
    root = tmp_path_factory.mktemp("cli")
    cfg = get_preset("tiny")
    m = FasterQwen3TTS(cfg, bundle_from_jax_numpy(jax.tree.map(np.asarray, tiny_tts.params),
                                                  cfg, torch.float32, "cpu"))
    canon, tdir, broken = root / "canonical", root / "torch", root / "broken"
    m.save_pretrained(canon)
    bundle = loader.bundle_to_jax_layout(m.params)
    loader.export_torch_checkpoint(tdir, cfg, bundle, num_shards=3)
    named = loader.export_torch_layout(bundle, cfg)
    del named["talker.model.layers.1.self_attn.q_proj.weight"]
    named["talker.bogus_unknown.weight"] = torch.zeros(2)
    broken.mkdir()
    (broken / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    loader.safetensors_io.save_file(named, broken / "model.safetensors")
    ref = root / "ref.wav"
    write_wav(ref, (0.3 * np.sin(np.arange(24_000) / 7)).astype(np.float32), 24_000)
    return str(canon), str(tdir), str(broken), str(ref)


def _exit_code(argv, main=cli.main):
    with pytest.raises(SystemExit) as ei:
        main(argv)
    return ei.value.code


@pytest.mark.parametrize("stream", [[], ["--streaming", "--chunk-size", "4"]])
def test_clone_writes_whole_frames(dirs, tmp_path, capsys, stream):
    canon, _, _, ref = dirs
    out = tmp_path / "o.wav"
    cli.main(["clone", "--model", canon, "--device", "cpu", "--ref-audio", ref,
              "--text", "Hello there.", "--max-new-tokens", "6", "--seed", "3",
              "-o", str(out), *stream])
    audio, sr = read_wav(out)
    assert sr == 24_000 and len(audio) % SPF == 0 and 0 < len(audio) <= 6 * SPF
    printed = capsys.readouterr()
    assert f"Wrote {out}" in printed.out and "RTF" in printed.out
    assert ("TTFA" in printed.err) == bool(stream)


def test_list_speakers_as_jax(capsys):
    cli.main(["custom", "--list-speakers", "--model", "random:tiny-custom", "--device", "cpu"])
    ours = capsys.readouterr().out.split()
    jcli.main(["custom", "--list-speakers", "--model", "random:tiny-custom"])
    assert ours == capsys.readouterr().out.split() == sorted(
        get_preset("tiny-custom").talker.spk_id)


@pytest.mark.parametrize("which,code", [(1, 0), (2, 1)])
def test_check_checkpoint_as_jax(dirs, capsys, which, code):
    d = dirs[which]
    assert _exit_code(["check-checkpoint", d, "--limit", "5"]) == code
    ours = capsys.readouterr().out
    assert _exit_code(["check-checkpoint", d, "--limit", "5"], jcli.main) == code
    assert ours == capsys.readouterr().out
    assert ("OK" in ours) == (code == 0) and "matched" in ours


def test_serve_answers_stdin_until_exit(dirs, tmp_path, monkeypatch, capsys):
    canon, _, _, ref = dirs
    monkeypatch.setattr("sys.stdin", io.StringIO("hello\n\nworld\nexit\nnever\n"))
    cli.main(["serve", "--model", canon, "--device", "cpu", "--ref-audio", ref,
              "--ref-text", "a reference", "--max-new-tokens", "4",
              "--output-dir", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.glob("*.wav")) == ["out_0000.wav", "out_0001.wav"]
    assert capsys.readouterr().out.count("Wrote ") == 2


def test_serve_refuses_clone_without_reference(dirs):
    assert _exit_code(["serve", "--model", dirs[0], "--device", "cpu"]) == 2


def test_export_and_check_fixture_exit_codes(dirs, tmp_path, capsys):
    canon = dirs[0]
    fx = tmp_path / "f.npz"
    cli.main(["export-fixture", "--model", canon, "--device", "cpu", "--text", "parity",
              "--max-new-tokens", "6", "-o", str(fx)])
    common = ["check-fixture", "--model", canon, "--device", "cpu"]
    assert _exit_code([*common, str(fx)]) == 0
    with np.load(fx) as z:
        tokens, meta = z["tokens"].copy(), z["meta"]
    tokens[0, 0] += 1
    bad = tmp_path / "bad.npz"
    np.savez(bad, tokens=tokens, meta=meta)
    assert _exit_code([*common, str(fx), str(bad)]) == 1
    out = capsys.readouterr().out
    assert f"PASS {fx}" in out and f"FAIL {bad}: DECODE drift" in out


def test_custom_requires_text_and_speaker():
    assert _exit_code(["custom", "--device", "cpu"]) == 2


def test_no_card_and_no_device_raises(dirs, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["clone", "--model", dirs[0], "--ref-audio", dirs[3], "--text", "hi",
                  "-o", str(tmp_path / "x.wav")])


def test_module_runs_as_a_script():
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-m", "qwen3tts_tpu_torch.apps.cli", "--help"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    for cmd in ("clone", "custom", "design", "serve", "export-fixture", "check-fixture",
                "check-checkpoint"):
        assert cmd in proc.stdout
