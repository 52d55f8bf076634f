"""The port's OpenAI-compatible server (``qwen3tts_tpu_torch/apps/
openai_server.py``) over real HTTP sockets on the CPU, with the JAX
``random:tiny`` weights (float32) carried across by
``bundle_from_jax_numpy``; and the port's ``utils/timing.py`` and
``audio/mp3.py``.

- The openai-server part of ``tests/test_servers.py`` that is not slow:
  ``/health`` (with the predictor's frame steps by path), the 400s,
  ``/health``'s scheduler stats on a batched server
  (and the tracer's summary while it is on), a client that disconnects mid-stream has its batch row cancelled and the
  row serves the next request.
- Streamed wav (whole codec frames), pcm and mp3 (or its 501) through the
  one-at-a-time server and through the batched one; the lock server's
  audio equals the API's streamed request under the same seed.
- ``main`` with no card raises and names ``device="cpu"``.
- the tracer's spans (``TRACE``, which replaced the stopwatch), ``device_memory_stats``,
  ``QWEN3TTS_PROFILE_DIR``.
- The mp3 round trip of ``tests/test_mp3.py`` on the port's copy (skipped
  without libmp3lame / libmpg123).
"""
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import jax  # noqa: E402

from qwen3tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.apps.openai_server import (TTSState, VoiceRegistry,  # noqa: E402
                                                   main, make_handler, serve)
from qwen3tts_tpu_torch.audio import mp3  # noqa: E402
from qwen3tts_tpu_torch.audio.wav import write_wav  # noqa: E402
from qwen3tts_tpu_torch.core.loader import bundle_from_jax_numpy  # noqa: E402
from qwen3tts_tpu_torch.core.presets import get_preset  # noqa: E402
from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy  # noqa: E402
from qwen3tts_tpu_torch.runtime.scheduler import ContinuousBatcher  # noqa: E402
from qwen3tts_tpu_torch.utils.timing import TRACE, Tracer, device_memory_stats  # noqa: E402

SR = 24_000
STEPS = 16


@pytest.fixture(scope="module")
def port_tts(tiny_tts):
    cfg = get_preset("tiny")
    return FasterQwen3TTS(cfg, bundle_from_jax_numpy(jax.tree.map(np.asarray, tiny_tts.params),
                                                     cfg, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    path = tmp_path_factory.mktemp("oai") / "v.wav"
    write_wav(path, (0.3 * np.sin(np.linspace(0, 400, SR))).astype(np.float32), SR)
    return str(path)


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def oai_server(port_tts, voice):
    httpd = serve(port_tts, VoiceRegistry.from_args(None, voice, "ref"), host="127.0.0.1",
                  port=0)
    yield _start(httpd)
    httpd.shutdown()


@pytest.fixture(scope="module")
def oai_server_batched(port_tts, voice):
    httpd = serve(port_tts, VoiceRegistry.from_args(None, voice, "ref"), host="127.0.0.1",
                  port=0, max_batch=2)
    yield _start(httpd), httpd.tts_state
    httpd.shutdown()
    httpd.tts_state.batcher.close()


def _post(url, body, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _speech(url, fmt, text="Hello."):
    with _post(url + "/v1/audio/speech", {"input": text, "response_format": fmt,
                                          "max_new_tokens": STEPS}) as r:
        return r.headers["Content-Type"], r.read()


def test_health(oai_server):
    with urllib.request.urlopen(oai_server + "/health") as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert body["default_voice"] == "default"
    assert "scheduler" not in body


def test_speech_errors(oai_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(oai_server + "/v1/audio/speech", {"voice": "x"})
    assert e.value.code == 400  # missing input
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(oai_server + "/v1/audio/speech", {"input": "x", "response_format": "flac"})
    assert e.value.code == 400  # unsupported format
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(oai_server + "/v1/audio/speech", {"input": "x" * 5000})
    assert e.value.code == 400  # too long
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(oai_server + "/nope", {"input": "x"})
    assert e.value.code == 404


@pytest.mark.parametrize("batched", [False, True])
def test_speech_wav_pcm_mp3(oai_server, oai_server_batched, batched):
    """Streamed wav (unknown-length header, whole codec frames), pcm and
    mp3 (or 501 without libmp3lame), one at a time and batched."""
    url = oai_server_batched[0] if batched else oai_server
    ctype, data = _speech(url, "wav")
    assert ctype == "audio/wav"
    assert data[:4] == b"RIFF" and data[4:8] == b"\xff\xff\xff\xff"
    pcm = np.frombuffer(data[44:], "<i2")
    # whole codec frames, at most the budget (the server samples: an EOS may end it)
    assert 0 < len(pcm) <= STEPS * 2000 and len(pcm) % 2000 == 0
    ctype, data = _speech(url, "pcm")
    assert ctype == "audio/pcm" and 0 < len(data) <= STEPS * 2000 * 2
    assert len(data) % (2000 * 2) == 0
    if not mp3.is_available():
        with pytest.raises(urllib.error.HTTPError) as e:
            _speech(url, "mp3")
        assert e.value.code == 501
        return
    ctype, data = _speech(url, "mp3")
    assert ctype == "audio/mpeg" and len(data) > 200
    if mp3.decode_available():
        dec, sr = mp3.decode_mp3(data)
        assert sr == SR and len(dec) > 0


def test_lock_server_audio_equals_the_api_stream(port_tts, oai_server, voice):
    """The one-at-a-time server streams what the API streams: greedy
    requests give the API's streamed samples as 16-bit PCM."""
    pol = dict(do_sample=False, min_new_tokens=STEPS)
    port_tts._gen.manual_seed(5)  # the predictor samples
    want = np.concatenate([a for a, _, _ in port_tts.generate_voice_clone_streaming(
        "Hello.", "English", voice, "ref", max_new_tokens=STEPS, chunk_size=8,
        first_chunks=(2, 4), **pol)])
    orig = port_tts.generate_voice_clone_streaming
    try:
        port_tts.generate_voice_clone_streaming = (
            lambda *a, **k: orig(*a, **{**k, **pol}))
        port_tts._gen.manual_seed(5)
        _, data = _speech(oai_server, "pcm")
    finally:
        del port_tts.generate_voice_clone_streaming
    got = np.frombuffer(data, "<i2").astype(np.float32) / 32767.0
    # to_pcm16 truncates to 16 bits: within one step of 1/32767
    np.testing.assert_allclose(got, np.clip(want, -1, 1), rtol=0, atol=1.001 / 32767)


def test_health_exposes_scheduler_stats(oai_server_batched):
    url, _ = oai_server_batched
    with urllib.request.urlopen(url + "/health") as r:
        body = json.loads(r.read())
    sched = body["scheduler"]
    for key in ("served", "joined_mid_batch", "batches", "cancelled", "active_rows",
                "queue_depth"):
        assert key in sched, key


def test_health_exposes_the_trace_summary(oai_server_batched):
    """While the tracer is on, /health summarises the batcher's spans by
    name; while it is off, it shows none."""
    url, _ = oai_server_batched
    TRACE.clear()
    TRACE.enable()
    try:
        _speech(url, "pcm")
        with urllib.request.urlopen(url + "/health") as r:
            trace = json.loads(r.read())["trace"]
    finally:
        TRACE.disable()
        TRACE.clear()
    spans = trace["spans"]
    for name in ("prompt", "batch_setup", "dispatch", "fetch", "emit", "read_wait"):
        assert spans[name]["n"] >= 1, name
        assert 0 <= spans[name]["p50_ms"] <= spans[name]["max_ms"] <= spans[name]["total_ms"]
    assert spans["batch_setup"]["n"] == 1 and trace["device"] == {}
    assert trace["counters"] == dict(TRACE.counters)
    with urllib.request.urlopen(url + "/health") as r:
        assert "trace" not in json.loads(r.read())


def test_health_counts_predictor_frames(oai_server_batched):
    """/health shows the frame steps dispatched on each predictor path,
    tracing or not: a request on the CPU adds to the eager chain's only."""
    url, _ = oai_server_batched

    def frames():
        with urllib.request.urlopen(url + "/health") as r:
            return json.loads(r.read())["predictor_frames"]

    before = frames()
    _speech(url, "pcm")
    after = frames()
    assert after.get("eager", 0) > before.get("eager", 0)
    assert after.get("kernel", 0) == before.get("kernel", 0)


def test_client_disconnect_cancels_batched_row(port_tts, voice):
    """A client that disconnects mid-stream has its batch row cancelled, and
    the batcher serves the next request."""
    batcher = ContinuousBatcher(
        port_tts, max_batch=2, chunk_size=4, max_new_tokens=2000,
        policy=GenerationPolicy(do_sample=False, min_new_tokens=10_000))
    state = TTSState(port_tts, VoiceRegistry.from_args(None, voice, "ref"), 4, batcher=batcher)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        body = json.dumps({"input": "An endless stream to abandon.",
                           "response_format": "pcm"}).encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.sendall(b"POST /v1/audio/speech HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        assert s.recv(4096)  # headers and the first audio are flowing
        s.close()  # abandon the stream

        deadline = time.time() + 180
        while time.time() < deadline and batcher.stats["cancelled"] < 1:
            time.sleep(0.2)
        assert batcher.stats["cancelled"] == 1, "disconnect did not cancel the batch row"
        h = batcher.submit("After the disconnect.", "English", voice, "ref", max_new_tokens=8)
        wav = np.concatenate([a for a, _, _ in h.chunks()])
        assert len(wav) == 8 * port_tts.vocoder.spf
    finally:
        httpd.shutdown()
        batcher.close()


def test_main_without_a_card_names_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(["--model", "random:tiny", "--port", "0"])


# ---------------------------------------------------------------------------
# utils/timing.py
# ---------------------------------------------------------------------------

def test_stopwatch_and_device_memory_stats(monkeypatch):
    # the tracer in the stopwatch's place: timed spans, by name and time range
    tr = Tracer()
    tr.enable()
    with tr.timed("a") as a:
        time.sleep(0.01)
    with tr.span("b"):
        pass
    with tr.timed("a"):
        pass
    assert a.seconds >= 0.01
    got = tr.spans("a")
    assert len(got) == 2 and got[0].end - got[0].start == a.seconds
    assert {s.name for s in tr.spans()} == {"a", "b"}
    assert tr.spans("a", lo=got[1].start) == got[1:]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (30, 80))
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 5, "allocated_bytes.all.peak": 7})
    assert device_memory_stats() == {"cuda:0": {"bytes_in_use": 5, "peak_bytes_in_use": 7,
                                                "bytes_free": 30, "bytes_limit": 80}}


def test_profile_dir_traces_a_generation(port_tts, voice, tmp_path, monkeypatch):
    monkeypatch.setenv("QWEN3TTS_PROFILE_DIR", str(tmp_path))
    wavs, _ = port_tts.generate_voice_clone("Hi.", "English", voice, "", max_new_tokens=4,
                                            min_new_tokens=4)
    assert wavs[0].shape == (4 * port_tts.vocoder.spf,)
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "talker_step" for e in events)


# ---------------------------------------------------------------------------
# audio/mp3.py (the port's copy), as tests/test_mp3.py
# ---------------------------------------------------------------------------

needs_mp3 = pytest.mark.skipif(not (mp3.is_available() and mp3.decode_available()),
                               reason="libmp3lame/libmpg123 not present")


def _sine(freq=440.0, secs=1.0, sr=SR):
    t = np.arange(int(sr * secs)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@needs_mp3
def test_mp3_roundtrip_one_shot_and_streamed():
    src = _sine()
    data = mp3.encode_mp3(src, SR, bitrate=128)
    dec, sr = mp3.decode_mp3(data)
    assert sr == SR and len(dec) >= len(src)
    # the codec delays the signal: align by correlation
    best = max(range(0, len(dec) - len(src) + 1, 16),
               key=lambda off: float(np.dot(dec[off:off + len(src)], src)))
    seg = dec[best:best + len(src)]
    assert float(np.dot(seg, src) / (np.linalg.norm(seg) * np.linalg.norm(src))) > 0.97

    enc = mp3.Mp3Encoder(SR, bitrate=96)
    parts = [enc.encode(src[i:i + 1777]) for i in range(0, len(src), 1777)]
    parts.append(enc.flush())
    assert sum(map(len, parts[:-1])) > 0  # bytes flowed before the flush
    dec, sr = mp3.decode_mp3(b"".join(parts))
    assert sr == SR and float(np.max(np.abs(dec))) > 0.2
    assert enc.flush() == b""
    with pytest.raises(RuntimeError):
        enc.encode(src)
