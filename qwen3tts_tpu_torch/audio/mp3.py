"""MP3 encode (libmp3lame) and decode (libmpg123) through ctypes.

A copy of ``qwen3tts_tpu/audio/mp3.py`` (the port imports nothing of the JAX
package): the OpenAI-compatible server's ``response_format="mp3"``, streamed
incrementally from LAME's streaming encoder, with no Python dependency.
Decode exists so that the tests can round-trip a waveform.

``is_available()`` is False when the shared library is missing; the server
then answers HTTP 501, as the JAX server does.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------- lame


def _load(name: str, fallbacks: Tuple[str, ...]) -> Optional[ctypes.CDLL]:
    for cand in (ctypes.util.find_library(name),) + fallbacks:
        if not cand:
            continue
        try:
            return ctypes.CDLL(cand)
        except OSError:
            continue
    return None


_lame = _load("mp3lame", ("libmp3lame.so.0", "libmp3lame.so"))
_mpg123 = _load("mpg123", ("libmpg123.so.0", "libmpg123.so"))

if _lame is not None:
    _lame.lame_init.restype = ctypes.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
               "lame_set_out_samplerate", "lame_set_brate", "lame_set_quality",
               "lame_set_mode", "lame_set_VBR", "lame_init_params",
               "lame_close"):
        getattr(_lame, fn).argtypes = [ctypes.c_void_p] + (
            [ctypes.c_int] if fn.startswith("lame_set") else [])
        getattr(_lame, fn).restype = ctypes.c_int
    _lame.lame_encode_buffer.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_short),
        ctypes.POINTER(ctypes.c_short), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
    _lame.lame_encode_buffer.restype = ctypes.c_int
    _lame.lame_encode_flush.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
    _lame.lame_encode_flush.restype = ctypes.c_int

_MONO = 3      # MPEG_mode MONO
_VBR_OFF = 0   # vbr_off — CBR, predictable streaming bitrate


def is_available() -> bool:
    """True when libmp3lame was found (encode path usable)."""
    return _lame is not None


def decode_available() -> bool:
    """True when libmpg123 was found (test/verification path usable)."""
    return _mpg123 is not None


class Mp3Encoder:
    """Streaming mono MP3 encoder over libmp3lame.

    ``encode(chunk)`` accepts float32 [-1, 1] (or int16) mono audio and
    returns whatever complete mp3 bytes the encoder produced; ``flush()``
    drains the final frames.  Safe to call ``encode`` with arbitrary chunk
    sizes — LAME buffers internally across frame boundaries.
    """

    def __init__(self, sample_rate: int, bitrate: int = 128, quality: int = 2):
        if _lame is None:
            raise RuntimeError("libmp3lame not available")
        gfp = _lame.lame_init()
        if not gfp:
            raise RuntimeError("lame_init failed")
        self._gfp = gfp
        _lame.lame_set_in_samplerate(gfp, int(sample_rate))
        _lame.lame_set_out_samplerate(gfp, int(sample_rate))
        _lame.lame_set_num_channels(gfp, 1)
        _lame.lame_set_mode(gfp, _MONO)
        _lame.lame_set_brate(gfp, int(bitrate))
        _lame.lame_set_quality(gfp, int(quality))
        _lame.lame_set_VBR(gfp, _VBR_OFF)
        if _lame.lame_init_params(gfp) < 0:
            _lame.lame_close(gfp)
            self._gfp = None
            raise RuntimeError("lame_init_params failed (unsupported config)")

    def encode(self, audio: np.ndarray) -> bytes:
        if self._gfp is None:
            raise RuntimeError("encoder closed")
        pcm = np.asarray(audio)
        if pcm.dtype != np.int16:
            pcm = np.clip(pcm.astype(np.float32), -1.0, 1.0)
            pcm = (pcm * 32767.0).astype(np.int16)
        pcm = np.ascontiguousarray(pcm.reshape(-1))
        n = pcm.size
        if n == 0:
            return b""
        # LAME's documented worst case: 1.25*n + 7200 bytes.
        buf = (ctypes.c_ubyte * (n + n // 4 + 7200))()
        ptr = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
        written = _lame.lame_encode_buffer(self._gfp, ptr, ptr, n, buf, len(buf))
        if written < 0:
            raise RuntimeError(f"lame_encode_buffer error {written}")
        return bytes(buf[:written])

    def flush(self) -> bytes:
        if self._gfp is None:
            return b""
        buf = (ctypes.c_ubyte * 7200)()
        written = _lame.lame_encode_flush(self._gfp, buf, len(buf))
        out = bytes(buf[:written]) if written > 0 else b""
        _lame.lame_close(self._gfp)
        self._gfp = None
        return out

    def __del__(self):  # pragma: no cover — best-effort cleanup
        if getattr(self, "_gfp", None):
            try:
                _lame.lame_close(self._gfp)
            except Exception:
                pass


def encode_mp3(audio: np.ndarray, sample_rate: int, bitrate: int = 128) -> bytes:
    """One-shot mono mp3 encode (the reference's buffered-pydub analog)."""
    enc = Mp3Encoder(sample_rate, bitrate=bitrate)
    return enc.encode(audio) + enc.flush()


# ---------------------------------------------------------------- mpg123

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_MPG123_ENC_SIGNED_16 = 0xD0
_inited = False


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an mp3 byte string → (float32 mono [-1,1], sample_rate).

    Uses libmpg123's feed API (no temp files); exists so tests can verify
    the encoder's output actually decodes back to the source audio.
    """
    global _inited
    if _mpg123 is None:
        raise RuntimeError("libmpg123 not available")
    lib = _mpg123
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_getformat.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    if not _inited:
        lib.mpg123_init()
        _inited = True
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        lib.mpg123_open_feed(h)
        lib.mpg123_feed(h, data, len(data))
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        out = bytearray()
        buf = (ctypes.c_ubyte * 65536)()
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                out += bytes(buf[:done.value])
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                     ctypes.byref(enc))
                if enc.value != _MPG123_ENC_SIGNED_16:  # pragma: no cover
                    raise RuntimeError(f"unexpected mpg123 encoding {enc.value:#x}")
            elif rc in (_MPG123_DONE, _MPG123_NEED_MORE):
                break  # feed exhausted — all frames decoded
            elif rc != _MPG123_OK:  # pragma: no cover
                raise RuntimeError(f"mpg123_read error {rc}")
        pcm = np.frombuffer(bytes(out), np.int16).astype(np.float32) / 32767.0
        ch = max(1, channels.value)
        if ch > 1:
            pcm = pcm.reshape(-1, ch).mean(axis=1)
        return pcm, int(rate.value) or 24000
    finally:
        lib.mpg123_delete(h)
