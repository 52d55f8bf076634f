"""The port's web demo (``qwen3tts_tpu_torch/apps/demo_server.py``) over real
HTTP sockets on the CPU, with the port's ``random:tiny`` (float32,
``device="cpu"``).

- ``tests/test_servers.py``'s demo tests on the port: index, status, guards,
  the LRU cache, and the SSE stream (``slow`` in the JAX package, which
  compiles; the port compiles nothing).
- More routes: ``/generate`` (non-streamed JSON), ``/preset_ref``,
  ``/transcribe`` through ``builtin:random:ctc-tiny``, and a queued second
  request's ``queued`` event.
- Eviction: with a cache of 1, the evicted model is freed by the load that
  evicted it (a weak reference to it dies).
- The same shapes as the JAX demo: for the same request, the SSE event
  kinds and each kind's keys, and ``/status``'s keys, equal the JAX demo's
  (structural: the predictor samples, so the audio cannot match).
- The page equals the JAX page line for line, except the four lines that
  name the device.
"""
import base64
import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # several xdist workers share the host

import qwen3tts_tpu_torch.apps.demo_server as ds  # noqa: E402
from qwen3tts_tpu_torch.audio.wav import read_wav, write_wav  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SPF = 2000  # samples per codec frame at 24 kHz


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def _post(url, body, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _events(raw: str):
    return [json.loads(line[6:]) for line in raw.split("\n\n") if line.startswith("data: ")]


def _stream(url, body):
    with _post(url + "/generate/stream", body) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        return _events(r.read().decode())


def _chunk_audio(event) -> np.ndarray:
    audio, sr = read_wav(base64.b64decode(event["wav_b64"]))
    assert sr == 24_000
    return audio


@pytest.fixture(scope="module")
def demo_server():
    httpd, state = ds.serve(models=["random:tiny"], dtype="fp32", host="127.0.0.1", port=0,
                            device="cpu")
    yield _start(httpd), state
    _stop(httpd)


@pytest.fixture()
def ref_b64(ref_wav):
    return base64.b64encode(open(ref_wav, "rb").read()).decode()


# ---------------------------------------------------------------------------
# tests/test_servers.py's demo tests, on the port
# ---------------------------------------------------------------------------

def test_demo_index_and_status(demo_server):
    url, _ = demo_server
    with urllib.request.urlopen(url + "/") as r:
        html = r.read().decode()
    assert "Qwen3-TTS" in html and "generate" in html
    with urllib.request.urlopen(url + "/status") as r:
        st = json.loads(r.read())
    assert st["available_models"] == ["random:tiny"]
    assert "speakers" in st and st["queue_depth"] == 0
    assert st["device_memory"] == {}  # the CPU: no card to report


def test_demo_generate_stream_sse(demo_server, ref_b64):
    url, _ = demo_server
    events = _stream(url, {"mode": "clone", "text": "Hi.", "ref_audio_b64": ref_b64,
                           "max_new_tokens": 8, "chunk_size": 4})
    kinds = [e["event"] for e in events]
    assert "chunk" in kinds and kinds[-1] == "done"
    first = next(e for e in events if e["event"] == "chunk")
    assert first["ttfa_ms"] > 0 and "wav_b64" in first
    chunks = [e for e in events if e["event"] == "chunk"]
    assert [e["chunk_index"] for e in chunks] == list(range(len(chunks)))
    total = 0
    for e in chunks:
        audio = _chunk_audio(e)
        assert len(audio) % SPF == 0 and len(audio) > 0 and np.isfinite(audio).all()
        total += len(audio)
    assert total <= 8 * SPF
    assert events[-1]["total_audio_s"] == round(total / 24_000, 2)


def test_demo_guards(demo_server):
    url, _ = demo_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/generate", {"text": "x" * 2000})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/load", {"model": "nope"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/transcribe", {})
    assert e.value.code == 501  # no ASR hook registered
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/generate", {"text": "Hi.", "preset_ref": "nope"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:  # only the served models load
        _post(url + "/generate", {"text": "Hi.", "preset_ref": "preset_low",
                                  "model": "random:qwen3-tts-1.7b"})
    assert e.value.code == 400 and "unknown model" in e.value.read().decode()


def test_demo_model_cache_lru(demo_server):
    _, state = demo_server
    with state.gen_lock:  # get_model loads and evicts only under the lock
        state.get_model("random:tiny")
    assert list(state.model_cache) == ["random:tiny"]
    assert next(iter(state.model_cache.values())).device.type == "cpu"


# ---------------------------------------------------------------------------
# the other routes
# ---------------------------------------------------------------------------

def test_generate_non_streamed(demo_server):
    url, _ = demo_server
    with _post(url + "/generate", {"mode": "clone", "text": "Hello there.",
                                   "preset_ref": "preset_high", "max_new_tokens": 6}) as r:
        body = json.loads(r.read())
    assert set(body) == {"wav_b64", "duration_s", "wall_s", "rtf"}
    audio = _chunk_audio(body)
    assert 0 < len(audio) <= 6 * SPF and len(audio) % SPF == 0 and np.isfinite(audio).all()
    assert body["duration_s"] == round(len(audio) / 24_000, 2) and body["rtf"] > 0


def test_preset_ref(demo_server):
    url, state = demo_server
    with urllib.request.urlopen(url + "/preset_ref/preset_low") as r:
        assert r.headers["Content-Type"] == "audio/wav"
        audio, sr = read_wav(r.read())
    assert sr == 24_000 and len(audio) == 3 * sr and np.abs(audio).max() <= 0.25
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/preset_ref/nope")
    assert e.value.code == 404
    assert sorted(state.presets) == ["preset_high", "preset_low"]


def test_transcribe_through_builtin_hook(demo_server, tmp_path):
    url, state = demo_server
    state.asr = ds.resolve_asr("builtin:random:ctc-tiny", device="cpu")
    try:
        path = tmp_path / "u.wav"
        write_wav(path, (0.1 * np.sin(np.linspace(0, 600, 24_000))).astype(np.float32), 24_000)
        req = urllib.request.Request(url + "/transcribe", data=path.read_bytes(),
                                     headers={"Content-Type": "audio/wav"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert set(body) == {"text"} and isinstance(body["text"], str)
    finally:
        state.asr = None


def test_second_request_is_told_its_queue_position(demo_server, ref_b64):
    """A request that arrives while another waits for the generation lock
    gets a ``queued`` event with its place before its chunks."""
    url, state = demo_server
    body = {"mode": "clone", "text": "Queued.", "ref_audio_b64": ref_b64, "max_new_tokens": 4,
            "chunk_size": 4}
    out = {}

    def run(name):
        out[name] = _stream(url, body)

    def wait_for(n):
        deadline = time.time() + 60
        while state.waiters != n and time.time() < deadline:
            time.sleep(0.01)
        assert state.waiters == n

    with state.gen_lock:  # both requests wait: the second is behind the first
        first = threading.Thread(target=run, args=("first",))
        first.start()
        wait_for(1)
        second = threading.Thread(target=run, args=("second",))
        second.start()
        wait_for(2)
    first.join(timeout=300)
    second.join(timeout=300)
    assert [e["event"] for e in out["first"]][0] == "chunk"
    assert out["second"][0] == {"event": "queued", "position": 1}
    assert out["second"][-1]["event"] == "done"
    wait_for(0)  # each handler leaves the queue once its last byte is written


# ---------------------------------------------------------------------------
# eviction
# ---------------------------------------------------------------------------

def test_eviction_frees_the_evicted_model(monkeypatch, ref_wav):
    """With a cache of 1, the load that evicts a model releases it (under
    the generation lock): nothing keeps it alive afterwards.  The model is
    given a reference cycle, as a card model's graphs give it, and automatic
    collection is off: only the eviction's own collection can free it."""
    monkeypatch.setattr(ds, "MODEL_CACHE_SIZE", 1)
    httpd, state = ds.serve(models=["random:tiny", "random:tiny-custom"], dtype="fp32",
                            host="127.0.0.1", port=0, device="cpu")
    url = _start(httpd)
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        with _post(url + "/load", {"model": "random:tiny"}) as r:
            assert json.loads(r.read()) == {"ok": True, "cached": ["random:tiny"]}
        model = state.model_cache["random:tiny"]
        model.cycle = model
        gone = weakref.ref(model)
        del model
        with pytest.raises(urllib.error.HTTPError) as e:  # fails inside the generation
            _post(url + "/generate", {"mode": "nope", "model": "random:tiny", "text": "Hi."})
        assert e.value.code == 400 and "unknown mode" in e.value.read().decode()
        events = _stream(url, {"mode": "clone", "model": "random:tiny", "text": "Hi.",
                               "ref_audio_b64": base64.b64encode(
                                   open(ref_wav, "rb").read()).decode(),
                               "max_new_tokens": 4, "chunk_size": 4})
        assert events[-1]["event"] == "done"
        with _post(url + "/load", {"model": "random:tiny-custom"}) as r:
            assert json.loads(r.read()) == {"ok": True, "cached": ["random:tiny-custom"]}
        assert gone() is None, "the evicted model is still alive"
        assert list(state.model_cache) == ["random:tiny-custom"]
        events = _stream(url, {"mode": "custom", "model": "random:tiny-custom", "text": "Hi.",
                               "speaker": "aiden", "max_new_tokens": 4, "chunk_size": 4})
        assert events[-1]["event"] == "done", events[-1]
    finally:
        if gc_was_enabled:
            gc.enable()
        _stop(httpd)


def test_servers_sharing_asset_dir_see_whole_presets(monkeypatch, tmp_path):
    """Demo states started together on one ASSET_DIR each read whole preset
    files: a file is written under a temporary name and renamed into place."""
    monkeypatch.setattr(ds, "ASSET_DIR", tmp_path)
    states, errors = [], []

    def make():
        try:
            states.append(ds.DemoState(["random:tiny"], device="cpu"))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=make) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(states) == 8
    for name in ("preset_low", "preset_high"):
        audio, sr = read_wav(str(tmp_path / "refs" / f"{name}.wav"))
        assert sr == 24_000 and len(audio) == 3 * sr
    assert sorted(f.name for f in (tmp_path / "refs").iterdir()) == [
        "preset_high.wav", "preset_low.wav"]


# ---------------------------------------------------------------------------
# the same shapes as the JAX demo
# ---------------------------------------------------------------------------

def _shape(events):
    """Event kinds in order of first appearance, and each kind's keys."""
    kinds = {}
    for e in events:
        kinds.setdefault(e["event"], set()).update(e)
    return list(kinds), {k: sorted(v) for k, v in kinds.items()}


def test_sse_and_status_shapes_equal_jax_demo(demo_server, ref_b64, monkeypatch, tmp_path):
    import qwen3tts_tpu.apps.demo_server as jds

    monkeypatch.setattr(jds, "ASSET_DIR", tmp_path)  # its default is a fixed path

    body = {"mode": "clone", "text": "Same shape.", "ref_audio_b64": ref_b64,
            "max_new_tokens": 8, "chunk_size": 4, "greedy": True}
    url, _ = demo_server
    jhttpd, _ = jds.serve(models=["random:tiny"], dtype="fp32", host="127.0.0.1", port=0)
    jurl = _start(jhttpd)
    try:
        shapes = [_shape(_stream(u, body)) for u in (url, jurl)]
        status = []
        for u in (url, jurl):
            with urllib.request.urlopen(u + "/status") as r:
                status.append(json.loads(r.read()))
    finally:
        _stop(jhttpd)
    assert shapes[0] == shapes[1]
    assert shapes[0][0] == ["chunk", "done"]
    assert sorted(status[0]) == sorted(status[1])
    for key in ("available_models", "cached_models", "speakers", "preset_refs",
                "max_text_chars", "queue_depth", "loading"):
        assert status[0][key] == status[1][key], key


# ---------------------------------------------------------------------------
# the page
# ---------------------------------------------------------------------------

def test_page_equals_jax_page_but_the_device_lines():
    jax_page = (REPO / "qwen3tts_tpu/apps/demo/index.html").read_text().split("\n")
    page = (REPO / "qwen3tts_tpu_torch/apps/demo/index.html").read_text().split("\n")
    assert len(page) == len(jax_page)
    differ = [i + 1 for i, (a, b) in enumerate(zip(jax_page, page)) if a != b]
    assert differ == [6, 98, 99, 180]
    for i in differ:
        assert "TPU" in jax_page[i - 1] and "TPU" not in page[i - 1]
        assert "CUDA" in page[i - 1]
