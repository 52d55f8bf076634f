"""Web demo server: live streaming TTS with TTFA / RTF metrics.

Port of ``qwen3tts_tpu/apps/demo_server.py``, with the same routes, guards
and JSON / SSE shapes: ``/`` (the single-page UI, ``demo/index.html``),
``/status`` (loading state, queue depth, cached models, speakers, the cards'
memory), ``/load`` (switch model, an LRU cache of ``MODEL_CACHE_SIZE``),
``/generate/stream`` (server-sent events of base64 WAV chunks with live
``ttfa_ms`` / ``rtf`` / ``total_audio_s``, and a ``queued`` event with the
request's place), ``/generate`` (non-streaming JSON), ``/preset_ref/{id}``
and ``/transcribe`` (the CTC recognizer of ``models/asr.py``, or any hook;
501 without one), with the input guards ``MAX_TEXT_CHARS`` /
``MAX_AUDIO_BYTES``.

Models load on the card unless ``device`` (``--device``) names another; with
no card and no device it raises.  Requests run one at a time under
``gen_lock``: ``ThreadingHTTPServer`` gives each request a thread of its
own, so a model's CUDA graphs are captured on one thread and replayed on
another, always under the lock.  A model evicted from the cache keeps its
weights, KV caches and graph pools until Python's cycle collector frees
them, and destroying a graph while another thread captures breaks that
capture (``runtime/graphs.py:_no_gc``).  So a model is loaded, and the
least recently used one evicted and released (``gc.collect()``,
``torch.cuda.empty_cache()``), only under ``gen_lock``, where no capture
runs; and a handler holds no reference to a model outside that lock.

    python -m qwen3tts_tpu_torch.apps.demo_server --port 7860 [--device cpu]
"""
from __future__ import annotations

import argparse
import base64
import collections
import gc
import hashlib
import json
import logging
import os
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..audio.wav import read_wav, to_pcm16, wav_header, write_wav
from ..core.loader import resolve_device
from ..ops.quant import MODES as QUANT_MODES

logger = logging.getLogger("qwen3tts_tpu_torch.demo")

MAX_TEXT_CHARS = int(os.environ.get("MAX_TEXT_CHARS", 1000))
MAX_AUDIO_BYTES = int(os.environ.get("MAX_AUDIO_BYTES", 10 * 1024 * 1024))
MODEL_CACHE_SIZE = int(os.environ.get("MODEL_CACHE_SIZE", 2))
ASSET_DIR = Path(os.environ.get("ASSET_DIR", Path(tempfile.gettempdir()) / "qwen3tts_demo"))

DEFAULT_MODELS = ["random:tiny", "random:qwen3-tts-0.6b", "random:qwen3-tts-1.7b"]


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    return wav_header(sr, data_size=len(audio) * 2) + to_pcm16(audio)


def _write_wav_once(path: Path, audio: np.ndarray, sr: int) -> None:
    """Write ``path`` unless it exists, through a temporary file renamed into
    place: servers that share ``ASSET_DIR`` never read a half-written file."""
    if path.exists():
        return
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".wav.tmp")
    os.close(fd)
    try:
        write_wav(tmp, audio, sr)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _drop_frames(exc: Optional[BaseException]) -> None:
    """Clear the locals of the finished frames that an exception and its
    context hold (a generation's frames hold its model)."""
    while exc is not None:
        traceback.clear_frames(exc.__traceback__)
        exc = exc.__context__


class DemoState:
    def __init__(self, models, dtype="bf16", quantize=None, kv_quant=False, device=None):
        self.available_models = models
        self.dtype = dtype
        self.quantize = quantize
        self.kv_quant = kv_quant
        self.device = resolve_device(device)
        self.model_cache: "collections.OrderedDict[str, object]" = collections.OrderedDict()
        self.cache_lock = threading.Lock()
        self.gen_lock = threading.Lock()
        self.waiters = 0
        self.waiters_lock = threading.Lock()
        self.loading: Optional[str] = None
        self.ref_cache_dir = ASSET_DIR / "refs"
        self.ref_cache_dir.mkdir(parents=True, exist_ok=True)
        self.asr: Optional[Callable] = None  # pluggable ASR hook
        self.presets = self._make_presets()  # synthesized: nothing is downloaded

    def _make_presets(self) -> Dict[str, Path]:
        presets = {}
        sr = 24_000
        for name, f0, vib in (("preset_low", 140.0, 3.0), ("preset_high", 260.0, 5.0)):
            path = self.ref_cache_dir / f"{name}.wav"
            t = np.linspace(0, 3.0, 3 * sr, dtype=np.float32)
            wav = (0.25 * np.sin(2 * np.pi * f0 * t)
                   * (0.7 + 0.3 * np.sin(2 * np.pi * vib * t))).astype(np.float32)
            _write_wav_once(path, wav, sr)
            presets[name] = path
        return presets

    # -- LRU model cache ------------------------------------------------
    def get_model(self, name: str):
        """The model ``name``, loaded if it is not cached.  Call with
        ``gen_lock`` held: an eviction frees a model's graphs, which must not
        happen while another thread captures."""
        from ..api.model import FasterQwen3TTS

        with self.cache_lock:
            if name in self.model_cache:
                self.model_cache.move_to_end(name)
                return self.model_cache[name]
            self.loading = name
        try:
            model = FasterQwen3TTS.from_pretrained(
                name, device=self.device, dtype=self.dtype, quantize=self.quantize,
                kv_quant=self.kv_quant)
        finally:
            self.loading = None
        with self.cache_lock:
            self.model_cache[name] = model
        while len(self.model_cache) > MODEL_CACHE_SIZE:
            self.evict_lru()
        return model

    def evict_lru(self) -> None:
        """Drop the least recently used model and give its card memory back
        (``get_model``, under ``gen_lock``)."""
        with self.cache_lock:  # keeps no reference: the collection below frees it
            name = self.model_cache.popitem(last=False)[0]
        logger.info("evicted model %s", name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def cache_ref_audio(self, data: bytes) -> str:
        """The reference audio under the sha1 of its bytes."""
        path = self.ref_cache_dir / f"{hashlib.sha1(data).hexdigest()}.wav"
        if not path.exists():
            _write_wav_once(path, *read_wav(data))
        return str(path)

    def status(self) -> Dict:
        from ..core.presets import get_preset
        from ..utils.timing import device_memory_stats

        speakers = sorted(get_preset("qwen3-tts-0.6b").talker.spk_id)
        return {
            "available_models": self.available_models,
            "cached_models": list(self.model_cache),
            "loading": self.loading,
            "queue_depth": self.waiters,
            "speakers": speakers,
            "preset_refs": sorted(self.presets),
            "max_text_chars": MAX_TEXT_CHARS,
            "device_memory": device_memory_stats(),
        }


def make_handler(state: DemoState, index_html: Path):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.info(fmt, *args)

        def _send(self, code, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode())

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            if n > MAX_AUDIO_BYTES:
                raise ValueError(f"payload too large (max {MAX_AUDIO_BYTES} bytes)")
            return self.rfile.read(n)

        # ---------------- GET ----------------
        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, index_html.read_bytes(), "text/html; charset=utf-8")
            elif self.path == "/status":
                self._json(state.status())
            elif self.path.startswith("/preset_ref/"):
                name = self.path.rsplit("/", 1)[1]
                if name in state.presets:
                    self._send(200, state.presets[name].read_bytes(), "audio/wav")
                else:
                    self._json({"error": f"unknown preset {name}"}, 404)
            else:
                self._json({"error": "not found"}, 404)

        # ---------------- POST ----------------
        def do_POST(self):
            try:
                if self.path == "/generate/stream":
                    self._generate(stream=True)
                elif self.path == "/generate":
                    self._generate(stream=False)
                elif self.path == "/load":
                    req = json.loads(self._read_body() or b"{}")
                    name = req.get("model")
                    if name not in state.available_models:
                        return self._json({"error": f"unknown model {name}"}, 400)
                    with state.gen_lock:  # load, and evict, under the generation lock
                        state.get_model(name)
                    self._json({"ok": True, "cached": list(state.model_cache)})
                elif self.path == "/transcribe":
                    if state.asr is None:
                        return self._json(
                            {"error": "ASR unavailable; register an ASR hook"}, 501)
                    audio, sr = read_wav(self._read_body())
                    self._json({"text": state.asr(audio, sr)})
                else:
                    self._json({"error": "not found"}, 404)
            except ValueError as e:
                self._json({"error": str(e)}, 400)
            except BrokenPipeError:
                pass
            except Exception as e:
                logger.exception("request failed")
                try:
                    self._json({"error": str(e)}, 500)
                except Exception:
                    pass

        # ---------------- generation ----------------
        def _parse_gen_request(self):
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                raise ValueError("multipart unsupported; send JSON with base64 ref_audio")
            req = json.loads(self._read_body() or b"{}")
            text = req.get("text", "")
            if not text:
                raise ValueError("missing 'text'")
            if len(text) > MAX_TEXT_CHARS:
                raise ValueError(f"text too long (max {MAX_TEXT_CHARS} chars)")
            ref_path = None
            if req.get("preset_ref"):
                name = req["preset_ref"]
                if name not in state.presets:
                    raise ValueError(f"unknown preset {name}")
                ref_path = str(state.presets[name])
            elif req.get("ref_audio_b64"):
                data = base64.b64decode(req["ref_audio_b64"])
                if len(data) > MAX_AUDIO_BYTES:
                    raise ValueError("ref audio too large")
                ref_path = state.cache_ref_audio(data)
            return req, text, ref_path

        def _sse(self, obj):
            data = f"data: {json.dumps(obj)}\n\n".encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def _generate(self, stream: bool):
            req, text, ref_path = self._parse_gen_request()
            mode = req.get("mode", "clone")
            model_name = req.get("model", state.available_models[0])
            if model_name not in state.available_models:  # as /load: no other name loads
                raise ValueError(f"unknown model {model_name}")
            chunk_size = max(1, min(int(req.get("chunk_size", 8)), 24))
            max_new = max(1, min(int(req.get("max_new_tokens", 360)), 720))  # 30 s cap
            # sampling knobs, clamped (the CLI's defaults)
            sampling = {
                "temperature": min(max(float(req.get("temperature", 0.9)), 0.1), 2.0),
                "top_k": min(max(int(req.get("top_k", 50)), 1), 500),
                "repetition_penalty": min(max(float(
                    req.get("repetition_penalty", 1.05)), 1.0), 2.0),
                "do_sample": not bool(req.get("greedy", False)),
            }

            def run_stream(model):
                if mode == "clone":
                    if not ref_path:
                        raise ValueError("clone mode requires ref_audio_b64")
                    return model.generate_voice_clone_streaming(
                        text=text, language=req.get("language", "English"),
                        ref_audio=ref_path, ref_text=req.get("ref_text", ""),
                        chunk_size=chunk_size, max_new_tokens=max_new,
                        xvec_only=bool(req.get("xvec_only", True)),
                        first_chunks=(2, 4), **sampling,
                    )
                if mode == "custom":
                    return model.generate_custom_voice_streaming(
                        text=text, speaker=req.get("speaker", "vivian"),
                        language=req.get("language", "English"),
                        instruct=req.get("instruct") or None,
                        chunk_size=chunk_size, max_new_tokens=max_new, **sampling,
                    )
                if mode == "design":
                    return model.generate_voice_design_streaming(
                        text=text, instruct=req.get("instruct", ""),
                        language=req.get("language", "English"),
                        chunk_size=chunk_size, max_new_tokens=max_new, **sampling,
                    )
                raise ValueError(f"unknown mode {mode}")

            with state.waiters_lock:
                state.waiters += 1
                pos = state.waiters
            try:
                if stream:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    if pos > 1:
                        self._sse({"event": "queued", "position": pos - 1})
                with state.gen_lock:
                    try:
                        self._run(model_name, run_stream, stream)
                    except BaseException as e:
                        # its frames hold the model, which may be evicted (and
                        # freed) as soon as the lock is released
                        _drop_frames(e)
                        raise
            finally:
                with state.waiters_lock:
                    state.waiters -= 1

        def _run(self, model_name: str, run_stream, stream: bool):
            """One generation, under ``gen_lock``: the model is looked up (or
            loaded) here and referenced nowhere else."""
            ttfa_ms = None
            total_samples = 0
            if stream:
                try:
                    model = state.get_model(model_name)
                    t0, sr = time.time(), model.sample_rate
                    for audio, sr, timing in run_stream(model):
                        if ttfa_ms is None:
                            ttfa_ms = (time.time() - t0) * 1000
                        total_samples += len(audio)
                        elapsed = time.time() - t0
                        total_s = total_samples / sr
                        self._sse({
                            "event": "chunk",
                            "wav_b64": base64.b64encode(_wav_bytes(audio, sr)).decode(),
                            "ttfa_ms": round(ttfa_ms, 1),
                            "rtf": round(total_s / elapsed, 3) if elapsed > 0 else 0,
                            "total_audio_s": round(total_s, 2),
                            "chunk_index": timing["chunk_index"],
                        })
                    self._sse({"event": "done",
                               "total_audio_s": round(total_samples / sr, 2)})
                except Exception as e:
                    self._sse({"event": "error", "error": str(e),
                               "traceback": traceback.format_exc()})
                finally:
                    self.wfile.write(b"0\r\n\r\n")
            else:
                model = state.get_model(model_name)
                t0, sr = time.time(), model.sample_rate
                parts = [a for a, sr, _ in run_stream(model)]
                full = np.concatenate(parts) if parts else np.zeros(1, np.float32)
                wall = time.time() - t0
                self._json({
                    "wav_b64": base64.b64encode(_wav_bytes(full, sr)).decode(),
                    "duration_s": round(len(full) / sr, 2),
                    "wall_s": round(wall, 2),
                    "rtf": round(len(full) / sr / wall, 3) if wall > 0 else 0,
                })

    return Handler


def serve(models=None, dtype="bf16", host="0.0.0.0", port=7860, asr=None,
          quantize=None, kv_quant=False, device=None):
    state = DemoState(models or DEFAULT_MODELS, dtype, quantize=quantize,
                      kv_quant=kv_quant, device=device)
    state.asr = asr
    index = Path(__file__).parent / "demo" / "index.html"
    httpd = ThreadingHTTPServer((host, port), make_handler(state, index))
    logger.info("demo server on %s:%d (%s)", host, port, state.device)
    return httpd, state


def resolve_asr(spec: Optional[str], device=None):
    """The ``/transcribe`` hook for ``spec``:

      - ``builtin`` / ``builtin:<model-ref>`` (the default): the CTC
        recognizer of ``models/asr.py`` on ``device`` (default: the card).
        Bare ``builtin`` loads the committed self-trained checkpoint when
        present, random weights otherwise; ``<model-ref>`` is a checkpoint
        directory or ``random:ctc-tiny`` / ``random:ctc-base``;
      - ``none``: no hook, ``/transcribe`` answers 501;
      - ``module:callable``: any ``(audio_f32, sr) -> str``.
    """
    if not spec or spec == "none":
        return None
    if spec == "builtin" or spec.startswith("builtin:"):
        from ..models.asr import builtin_asr, default_checkpoint

        _, _, ref = spec.partition(":")
        hook = builtin_asr(ref or None, device=device)
        logger.info("builtin CTC ASR registered (%s)", ref or default_checkpoint())
        return hook
    import importlib

    mod, _, fn = spec.partition(":")
    hook = getattr(importlib.import_module(mod), fn or "transcribe")
    logger.info("ASR hook registered: %s", spec)
    return hook


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Qwen3-TTS web demo on a CUDA card")
    p.add_argument("--models", nargs="*", default=DEFAULT_MODELS)
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--quantize", default=None, choices=sorted(QUANT_MODES))
    p.add_argument("--kv-quant", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; without one, pass cpu)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--asr", default="builtin",
                   help="'builtin[:model-ref]' (first-party CTC, default), "
                        "'none' (501), or 'module:callable' with signature "
                        "(audio_f32, sr) -> str")
    args = p.parse_args(argv)
    httpd, _ = serve(args.models, args.dtype, args.host, args.port,
                     asr=resolve_asr(args.asr, device=args.device), quantize=args.quantize,
                     kv_quant=args.kv_quant, device=args.device)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    main()
