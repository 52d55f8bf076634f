"""OpenAI-compatible TTS server: POST /v1/audio/speech + GET /health.

Port of ``qwen3tts_tpu/apps/openai_server.py``, on the standard library's
``ThreadingHTTPServer`` with chunked transfer encoding: a voice registry
from ``voices.json`` or one ``--ref-audio`` default voice, streamed ``wav``
(an unknown-length header), ``pcm`` or ``mp3`` (``audio/mp3.py``, streamed
from libmp3lame; HTTP 501 when the library is missing).  By default
requests are served one at a time behind a lock; ``--continuous-batching
N`` serves them through one N-row ``ContinuousBatcher`` on the card, where
concurrent requests join the running batch, stream independently and retire
at their own EOS; ``--replicas R`` puts one batcher on each of R cards
(``ReplicaPool``).  The model takes the card unless ``--device cpu`` asks
for the CPU; with no card and no ``--device`` it raises.  ``--trace`` turns
the port's tracer on (``utils/timing.py:TRACE``): ``/health`` then shows
the last minute's spans by name (count, median, largest and total ms: the
prompt builds, the batcher's set-ups, joins, dispatches, fetches and emits,
the loops' chunks) and the tracer's counters.  ``/health`` always shows
``predictor_frames``: the frame steps dispatched through the predictor's
whole-micro-step kernel (``kernel``) and its eager block chain (``eager``).

    python -m qwen3tts_tpu_torch.apps.openai_server --model random:qwen3-tts-0.6b \
        --continuous-batching 4
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..audio import mp3
from ..audio.wav import to_pcm16, wav_header
from ..ops.quant import MODES as QUANT_MODES
from ..utils.timing import TRACE

logger = logging.getLogger("qwen3tts_tpu_torch.openai_server")

MAX_INPUT_CHARS = 4096
TRACE_WINDOW_S = 60.0  # the spans /health summarises, while tracing


class VoiceRegistry:
    """name → {ref_audio, ref_text}; falls back to the default voice
    (the reference server's ``resolve_voice``)."""

    def __init__(self, voices: Dict[str, Dict[str, str]], default: Optional[str]):
        self.voices = voices
        self.default = default or (next(iter(voices)) if voices else None)

    @classmethod
    def from_args(cls, voices_json: Optional[str], ref_audio: Optional[str],
                  ref_text: str) -> "VoiceRegistry":
        if voices_json:
            raw = json.loads(Path(voices_json).read_text())
            voices = raw.get("voices", raw)
            return cls(voices, raw.get("default"))
        if ref_audio:
            return cls({"default": {"ref_audio": ref_audio, "ref_text": ref_text}},
                       "default")
        return cls({}, None)

    def resolve(self, name: Optional[str]) -> Optional[Dict[str, str]]:
        if name and name in self.voices:
            return self.voices[name]
        if self.default:
            return self.voices.get(self.default)
        return None


class TTSState:
    """Shared model + either a serializing lock (the reference server's
    behaviour) or a continuous batcher: concurrent requests share one
    batched engine, joining/leaving it mid-flight — aggregate throughput
    scales with occupancy instead of queueing."""

    def __init__(self, model, registry: VoiceRegistry, chunk_size: int = 8,
                 batcher=None):
        self.model = model
        self.registry = registry
        self.lock = threading.Lock()
        self.chunk_size = chunk_size
        self.batcher = batcher


def make_handler(state: TTSState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.address_string(), *args)

        def _json_error(self, code: int, message: str):
            body = json.dumps({"error": {"message": message}}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # ---- chunked transfer helpers ----
        def _start_chunked(self, content_type: str):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _write_chunk(self, data: bytes):
            if not data:
                return
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        def _end_chunked(self):
            self.wfile.write(b"0\r\n\r\n")

        # ---- routes ----
        def do_GET(self):
            if self.path == "/health":
                payload = {
                    "status": "ok",
                    "voices": sorted(state.registry.voices),
                    "default_voice": state.registry.default,
                }
                if state.batcher is not None:
                    payload["scheduler"] = state.batcher.stats
                # frame steps by predictor path (kept whether tracing or not)
                payload["predictor_frames"] = {
                    k.split(".", 1)[1]: v for k, v in TRACE.counters.items()
                    if k.startswith("predictor_frames.")}
                if TRACE.on:
                    payload["trace"] = TRACE.summary(lo=time.perf_counter() - TRACE_WINDOW_S)
                body = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json_error(404, "not found")

        def do_POST(self):
            if self.path != "/v1/audio/speech":
                return self._json_error(404, "not found")
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                return self._json_error(400, "invalid JSON body")

            text = req.get("input")
            if not text or not isinstance(text, str):
                return self._json_error(400, "missing 'input'")
            if len(text) > MAX_INPUT_CHARS:
                return self._json_error(400, f"input too long (max {MAX_INPUT_CHARS})")
            # `speed` is part of the OpenAI schema; accepted and ignored, as
            # the reference server does (the model has no rate control), so
            # standard clients that always send it don't break.
            req.pop("speed", None)
            fmt = req.get("response_format", "wav")
            if fmt == "mp3" and not mp3.is_available():
                return self._json_error(
                    501, "mp3 encoding unavailable (libmp3lame not found); "
                         "use wav or pcm")
            if fmt not in ("wav", "pcm", "mp3"):
                return self._json_error(400, f"unsupported response_format '{fmt}'")

            voice = state.registry.resolve(req.get("voice"))
            if voice is None:
                return self._json_error(400, "no voice configured; pass --voices or --ref-audio")

            language = req.get("language", "English")
            sr = state.model.sample_rate
            handle = None  # continuous-batching stream handle, for cancel
            try:
                ctype = {"wav": "audio/wav", "pcm": "audio/pcm",
                         "mp3": "audio/mpeg"}[fmt]
                self._start_chunked(ctype)
                if fmt == "wav":
                    self._write_chunk(wav_header(sr))  # unknown-length header
                encoder = mp3.Mp3Encoder(sr) if fmt == "mp3" else None
                max_new = int(req.get("max_new_tokens", 2048))
                if state.batcher is not None:
                    # continuous batching: no lock — the scheduler's worker
                    # owns the card and this request joins the running batch.
                    # arriving(): a concurrent burst is advertised before
                    # the host-side prompt prep so the batch-start collector
                    # waits for the whole flood (scheduler.py)
                    with state.batcher.arriving():
                        handle = state.batcher.submit(
                            text, language, voice["ref_audio"],
                            voice.get("ref_text", ""), max_new_tokens=max_new)
                    stream = handle.chunks()
                else:
                    stream = None
                if stream is not None:
                    for audio, _, _t in stream:
                        if encoder is not None:
                            self._write_chunk(encoder.encode(audio))
                        else:
                            self._write_chunk(to_pcm16(audio))
                else:
                    with state.lock:  # one request at a time on the card
                        for audio, _, _t in state.model.generate_voice_clone_streaming(
                            text=text,
                            language=language,
                            ref_audio=voice["ref_audio"],
                            ref_text=voice.get("ref_text", ""),
                            chunk_size=state.chunk_size,
                            max_new_tokens=max_new,
                            first_chunks=(2, 4),  # cut TTFA: bytes flow sooner
                        ):
                            if encoder is not None:
                                self._write_chunk(encoder.encode(audio))
                            else:
                                self._write_chunk(to_pcm16(audio))
                if encoder is not None:
                    self._write_chunk(encoder.flush())
                self._end_chunked()
            except ConnectionError:  # BrokenPipe / ConnectionReset
                logger.info("client disconnected mid-stream")
                if handle is not None:
                    # release the batch row — otherwise the dead request
                    # keeps generating to max_new_tokens and, once its
                    # queue fills, stalls every request sharing the batch
                    handle.cancel()
            except Exception:  # pragma: no cover — surfaced to client
                logger.exception("generation failed")
                if handle is not None:
                    handle.cancel()
                try:
                    self._write_chunk(b"")
                    self._end_chunked()
                except Exception:
                    pass

    return Handler


def replica_devices(model, replicas: int) -> list:
    """The devices of ``replicas`` replicas: the host's cards, at most as many
    as there are (fewer warns); on the CPU (a model given ``device="cpu"``)
    ``replicas`` entries of it."""
    import torch

    from ..runtime.replicas import local_devices

    if model.device.type != "cuda":
        return [model.device] * replicas
    devs = local_devices()[:replicas]
    if len(devs) < replicas:
        logger.warning("requested %d replicas but only %d devices; using %d",
                       replicas, len(devs), len(devs))
    return devs or [torch.device("cuda")]


def serve(model, registry: VoiceRegistry, host: str = "0.0.0.0", port: int = 8000,
          chunk_size: int = 8, max_batch: int = 0,
          replicas: int = 0) -> ThreadingHTTPServer:
    batcher = None
    if replicas > 1:
        # data-parallel scale-out: one model replica + batcher per device,
        # least-loaded routing; the same surface as one batcher
        from ..runtime.replicas import ReplicaPool

        batcher = ReplicaPool(model, replica_devices(model, replicas),
                              max_batch=max(max_batch, 1), chunk_size=chunk_size,
                              first_chunks=(2, 4))
    elif max_batch > 1:
        from ..runtime.scheduler import ContinuousBatcher

        batcher = ContinuousBatcher(model, max_batch=max_batch,
                                    chunk_size=chunk_size,
                                    first_chunks=(2, 4))
    state = TTSState(model, registry, chunk_size, batcher=batcher)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.tts_state = state  # exposes the batcher for tests / shutdown
    mode = ""
    if replicas > 1:
        mode = f" ({len(batcher.batchers)} replicas × max_batch={max(max_batch, 1)})"
    elif batcher is not None:
        mode = f" (continuous batching, max_batch={max_batch})"
    logger.info("OpenAI-compatible TTS server on %s:%d%s", host, port, mode)
    return httpd


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="OpenAI-compatible TTS server")
    p.add_argument("--model", default="random:qwen3-tts-0.6b")
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; without one, pass cpu)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--quantize", default=None, choices=sorted(QUANT_MODES),
                   help="int8 decode modes: int8 (weight-only) or w8a8 (int8 "
                   "activations too), -talker / -predictor for one component")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache (serving-batch memory headroom)")
    p.add_argument("--voices", default=None, help="voices.json registry")
    p.add_argument("--ref-audio", default=None, help="single default voice")
    p.add_argument("--ref-text", default="")
    p.add_argument("--chunk-size", type=int, default=8)
    p.add_argument("--continuous-batching", type=int, default=0, metavar="N",
                   help="serve concurrent requests through one N-row batched "
                        "engine (requests join/leave the running batch); 0 = "
                        "serialize requests behind a lock (reference behavior). "
                        "Sampling knobs are fixed per server in this mode.")
    p.add_argument("--replicas", type=int, default=0, metavar="R",
                   help="data-parallel scale-out: copy the model to R local "
                        "cards, one continuous batcher each, least-loaded "
                        "routing (combine with --continuous-batching N for "
                        "R×N concurrent rows); 0/1 = single device")
    p.add_argument("--warmup-all", action=argparse.BooleanOptionalAction, default=True,
                   help="capture every chunk graph the server replays at "
                        "startup, so that no request waits on a capture")
    p.add_argument("--warmup-buckets", default="64,128,256",
                   help="comma-separated prefill buckets the batched engine "
                        "warms at startup (continuous-batching mode); cover "
                        "your real prompt sizes")
    p.add_argument("--trace", action="store_true",
                   help="record the tracer's spans; /health shows the last "
                        "minute's by name")
    args = p.parse_args(argv)
    if args.trace:
        TRACE.enable()

    from ..api.model import FasterQwen3TTS

    model = FasterQwen3TTS.from_pretrained(
        args.model, device=args.device, dtype=args.dtype, quantize=args.quantize,
        kv_quant=args.kv_quant)
    registry = VoiceRegistry.from_args(args.voices, args.ref_audio, args.ref_text)
    httpd = serve(model, registry, args.host, args.port, args.chunk_size,
                  max_batch=args.continuous_batching, replicas=args.replicas)
    batcher = httpd.tts_state.batcher
    if args.warmup_all and batcher is None:
        # the lock path streams with the (2, 4) ramp at --chunk-size
        logger.info("capturing the chunk graphs (one-time)...")
        model.warmup_all(chunk_sizes=(2, 4, args.chunk_size))
    elif args.warmup_all:
        # the batched engine's graphs (decode + batched vocode at the ramp
        # and chunk sizes, every trailing-text width), before any request
        buckets = tuple(int(x) for x in args.warmup_buckets.split(",") if x)
        batcher.warmup(prefill_buckets=buckets)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
        if batcher is not None:
            batcher.close()


if __name__ == "__main__":
    main()
