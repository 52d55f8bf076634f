"""The port's x-vector examples against the JAX package's, on the CPU.

``examples/torch_extract_speaker.py`` and
``examples/torch_generate_with_embedding.py`` are the port's counterparts of
``examples/extract_speaker.py`` and ``examples/generate_with_embedding.py``.
Each script runs in this process through ``runpy`` with its own ``argv``,
on ``random:tiny`` in float32 from one canonical checkpoint that the JAX
package wrote, so both packages load the same weights.  The module fixture
runs the four scripts once (the JAX generate example's compiles are the
file's main cost):

- the two extract examples on one seeded wav give x-vectors within 1e-4;
- each generate example reads the other package's .npz and writes a wav of
  exactly printed steps x samples per frame (the printed seconds give the
  steps: a frame is 1/12 s, the line has 1/100 s); the port's speaker
  projection of JAX's vector equals JAX's within 1e-5 (the sampled tokens
  cannot match: JAX draws from threefry, the port from Philox);
- with ``jax``, ``jaxlib`` and ``qwen3tts_tpu`` blocked at import, a fresh
  process runs both port examples with ``--device cpu`` to the end;
- with no card and no ``--device``, each port example raises the loader's
  "no CUDA device" error instead of running on the CPU.
"""
import contextlib
import io
import os
import re
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.audio.wav import read_wav, write_wav  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SCRIPTS = {"jax": ("extract_speaker.py", "generate_with_embedding.py"),
           "torch": ("torch_extract_speaker.py", "torch_generate_with_embedding.py")}
DEVICE = {"jax": [], "torch": ["--device", "cpu"]}
MAX_NEW_TOKENS = 6
WROTE = re.compile(r"wrote (\S+): ([0-9.]+)s in ([0-9.]+)s \(([0-9.]+) ms/step\)")


def _run(script: str, *argv) -> str:
    """``examples/<script>`` run as ``__main__`` with ``argv``; its stdout."""
    out = io.StringIO()
    path = str(EXAMPLES / script)
    with mock.patch.object(sys, "argv", [path, *map(str, argv)]), \
            contextlib.redirect_stdout(out):
        runpy.run_path(path, run_name="__main__")
    return out.getvalue()


def _ref_wav(path: Path) -> None:
    rng = np.random.default_rng(16)
    sr = 24_000
    t = np.arange(sr, dtype=np.float32) / sr
    wav = 0.3 * np.sin(2 * np.pi * 190 * t) + 0.02 * rng.standard_normal(sr)
    write_wav(path, wav.astype(np.float32), sr)


@pytest.fixture(scope="module")
def runs(tiny_tts, tmp_path_factory):
    """Both packages' examples, run once: (work dir, checkpoint dir, ref
    wav, {(package, "extract" | "generate"): stdout}).  ``<pkg>.npz`` is
    each package's x-vector; ``<pkg>.wav`` each package's generation from
    the other package's .npz."""
    d = tmp_path_factory.mktemp("examples")
    ckpt, ref = d / "tiny", d / "ref.wav"
    tiny_tts.save_pretrained(ckpt)
    _ref_wav(ref)
    model = ["--model", ckpt, "--dtype", "float32"]
    out = {}
    for pkg, (extract, _) in SCRIPTS.items():
        out[pkg, "extract"] = _run(extract, ref, "-o", d / f"{pkg}.npz", *model, *DEVICE[pkg])
    for pkg, other in (("jax", "torch"), ("torch", "jax")):
        out[pkg, "generate"] = _run(SCRIPTS[pkg][1], d / f"{other}.npz", "-o", d / f"{pkg}.wav",
                                    "--max-new-tokens", MAX_NEW_TOKENS, *model, *DEVICE[pkg])
    return d, ckpt, ref, out


def test_extract_matches_jax(runs):
    d, _, _, out = runs
    vecs = {}
    for pkg in SCRIPTS:
        with np.load(d / f"{pkg}.npz") as f:
            assert list(f.keys()) == ["ref_spk_embedding"]
            vecs[pkg] = f["ref_spk_embedding"]
        assert vecs[pkg].dtype == np.float32 and vecs[pkg].ndim == 1
        assert np.isfinite(vecs[pkg]).all()
        assert out[pkg, "extract"].strip() == (
            f"saved {vecs[pkg].shape} x-vector ({vecs[pkg].nbytes} bytes) -> {d / f'{pkg}.npz'}")
    np.testing.assert_allclose(vecs["torch"], vecs["jax"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("pkg", sorted(SCRIPTS))
def test_generate_reads_the_other_packages_npz(runs, tiny_tts, pkg):
    d, _, _, out = runs
    m = WROTE.fullmatch(out[pkg, "generate"].strip())
    assert m, out[pkg, "generate"]
    assert m.group(1) == str(d / f"{pkg}.wav")
    secs, sr, spf = float(m.group(2)), tiny_tts.sample_rate, tiny_tts.vocoder.spf
    steps = round(secs * sr / spf)
    assert abs(steps * spf / sr - secs) <= 0.005 + 1e-9
    assert 2 <= steps <= MAX_NEW_TOKENS  # min_new_tokens 2
    audio, wav_sr = read_wav(d / f"{pkg}.wav")
    assert wav_sr == sr and audio.shape == (steps * spf,)
    assert np.isfinite(audio).all()


def test_project_speaker_of_jax_vector(runs, tiny_tts):
    d, ckpt, _, _ = runs
    xvec = np.load(d / "jax.npz")["ref_spk_embedding"]
    port = FasterQwen3TTS.from_pretrained(str(ckpt), device="cpu", dtype="float32")
    got = np.asarray(port.prompt_builder.project_speaker(xvec))
    want = np.asarray(tiny_tts.prompt_builder.project_speaker(xvec))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_port_examples_run_without_jax(runs, tmp_path):
    _, ckpt, ref, _ = runs
    script = textwrap.dedent("""
        import importlib.abc, runpy, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "qwen3tts_tpu", "safetensors",
                                          "ml_dtypes", "tokenizers"):
                    raise ImportError("blocked: " + name)

        # scipy probes sys.modules for jax, so block at import time rather
        # than by planting None in sys.modules
        sys.meta_path.insert(0, Block())
        import torch

        torch.set_num_threads(1)  # the tier-1 run's workers share the host's cores
        examples, ckpt, ref, out = sys.argv[1:]
        model = ["--model", ckpt, "--dtype", "float32", "--device", "cpu"]
        for argv in ([examples + "/torch_extract_speaker.py", ref, "-o", out + "/s.npz"],
                     [examples + "/torch_generate_with_embedding.py", out + "/s.npz",
                      "-o", out + "/s.wav", "--max-new-tokens", "4"]):
            sys.argv = argv + model
            runpy.run_path(argv[0], run_name="__main__")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    res = subprocess.run([sys.executable, "-c", script, str(EXAMPLES), str(ckpt), str(ref),
                          str(tmp_path)], capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("saved (") and lines[0].endswith(f"-> {tmp_path}/s.npz")
    assert WROTE.fullmatch(lines[1]) and (tmp_path / "s.wav").exists()


@pytest.mark.parametrize("script", SCRIPTS["torch"])
def test_port_example_refuses_without_card(tmp_path, script):
    # argparse runs first: the first positional is a file neither script reaches
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        _run(script, tmp_path / "never_read", "--model", "random:tiny", "--dtype", "float32")
