"""WAV read/write + resampling without external audio deps.

Copy of ``qwen3tts_tpu/audio/wav.py`` for the PyTorch port, which cannot
import the JAX package.

The reference uses ``soundfile`` (model.py:194) which is not available here;
stdlib ``wave`` + numpy cover PCM16/24/32 and float32 WAVs, and
``scipy.signal.resample_poly`` handles rate conversion (e.g. 24 kHz ref audio
→ 16 kHz for the speaker encoder).
"""
from __future__ import annotations

import io
import struct
import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def read_wav(path: Union[str, Path, bytes, io.BytesIO]) -> Tuple[np.ndarray, int]:
    """Returns (mono float32 waveform in [-1,1], sample_rate)."""
    if isinstance(path, bytes):
        fh = io.BytesIO(path)
    elif isinstance(path, io.BytesIO):
        fh = path
    else:
        fh = open(str(path), "rb")
    try:
        # Try stdlib wave first (PCM); fall back to manual RIFF parse (float32).
        try:
            with wave.open(fh, "rb") as w:
                sr = w.getframerate()
                n = w.getnframes()
                ch = w.getnchannels()
                sw = w.getsampwidth()
                raw = w.readframes(n)
            if sw == 2:
                data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
            elif sw == 4:
                data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
            elif sw == 1:
                data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
            elif sw == 3:
                b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
                ints = (
                    b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16)
                )
                ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
                data = ints.astype(np.float32) / float(1 << 23)
            else:
                raise wave.Error(f"unsupported sample width {sw}")
        except wave.Error:
            fh.seek(0)
            data, ch, sr = _read_riff_float(fh.read())
        if ch > 1:
            data = data.reshape(-1, ch).mean(axis=1)
        return np.ascontiguousarray(data, np.float32), sr
    finally:
        if not isinstance(path, io.BytesIO):
            fh.close()


def _read_riff_float(buf: bytes) -> Tuple[np.ndarray, int, int]:
    """Minimal RIFF parser for IEEE-float WAVs (format tag 3)."""
    assert buf[:4] == b"RIFF" and buf[8:12] == b"WAVE", "not a WAV file"
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        size = struct.unpack("<I", buf[pos + 4 : pos + 8])[0]
        body = buf[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    assert fmt is not None and data is not None, "malformed WAV"
    tag, ch, sr, _, _, bits = fmt
    if tag == 3 and bits == 32:
        arr = np.frombuffer(data, "<f4").astype(np.float32)
    elif tag == 3 and bits == 64:
        arr = np.frombuffer(data, "<f8").astype(np.float32)
    elif tag == 1 and bits == 16:
        arr = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    else:
        raise ValueError(f"unsupported WAV format tag={tag} bits={bits}")
    return arr, ch, sr


def write_wav(path: Union[str, Path], audio: np.ndarray, sr: int) -> None:
    """Write mono float32 [-1,1] as 16-bit PCM WAV."""
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())


def to_pcm16(audio: np.ndarray) -> bytes:
    """float32 [-1,1] → little-endian PCM16 bytes (reference
    examples/openai_server.py:91)."""
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def wav_header(sample_rate: int, data_size: int = 0xFFFFFFFF, channels: int = 1,
               bits: int = 16) -> bytes:
    """Streaming WAV header with unknown length (reference
    examples/openai_server.py:96-112)."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    if data_size == 0xFFFFFFFF:
        riff_size = 0xFFFFFFFF
    else:
        riff_size = 36 + data_size
    return b"".join([
        b"RIFF", struct.pack("<I", riff_size), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, block_align, bits),
        b"data", struct.pack("<I", data_size),
    ])


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return audio
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g).astype(np.float32)
