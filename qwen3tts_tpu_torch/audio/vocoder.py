"""Codec vocoder: full decode, streaming decode (a fixed window or a
carried state), and encode.

Port of ``qwen3tts_tpu/audio/vocoder.py`` (``Vocoder.decode``,
``stream_decoder``, ``stateful_stream_decoder``, ``stream_state``,
``stream_state_batched``, ``scatter_stream_row``, ``stream_feed``,
``encode``, ``StreamDecoder`` and ``StatefulStreamDecoder``).  Codec weights
(decoder and encoder) are stored in float32 and computed in
``compute_dtype`` (bfloat16 by default, as in the JAX package).  PyTorch
runs every length eagerly, so ``decode`` needs no shape buckets; the
stream carries conv tails and attention windows (models/codec.py), which
makes chunked output sample-exact against a full decode.

``StreamDecoder`` is the JAX package's fixed-window scheme: each feed
decodes the last ``context_frames + chunk_size`` frames right-padded to that
window (a chunk longer than the window: everything so far, right-padded to
its ``FULL_BUCKETS`` bucket) and returns the new frames' samples, exact by
the codec's strict causality while the context covers the receptive field.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import CodecConfig
from ..models import codec as codec_lib

FULL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int, buckets=FULL_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree


class Vocoder:
    """Codec decode on ``params``' device."""

    def __init__(self, params: Dict, cfg: CodecConfig, context_frames: int = 25,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        self.cfg = cfg
        self.context_frames = context_frames  # StreamDecoder's left context
        self.spf = cfg.total_upsample  # samples per frame — exact
        if compute_dtype is not None and compute_dtype != torch.float32:
            params = _cast_tree(params, compute_dtype)
        self.params = params
        self.device = params["decoder"]["dec_in"]["w"].device

    def _codes(self, codes) -> torch.Tensor:
        return torch.as_tensor(np.asarray(codes, np.int64)).to(self.device)

    @torch.inference_mode()
    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes [T, 16] -> waveform [T*spf] float32."""
        wav = codec_lib.decode(self.params, self.cfg, self._codes(codes)[None])
        return wav[0].cpu().numpy()

    @torch.inference_mode()
    def _decode_padded(self, codes: np.ndarray, frames: int) -> np.ndarray:
        """codes [T, 16] right-padded with zeros to ``frames`` frames ->
        the padded waveform [frames * spf] (its first T * spf samples are
        the decode of ``codes``: the codec is strictly causal)."""
        buf = np.zeros((1, frames, self.cfg.num_quantizers), np.int64)
        buf[0, : len(codes)] = codes
        wav = codec_lib.decode(self.params, self.cfg, self._codes(buf))
        return wav[0].cpu().numpy()

    def stream_decoder(self, chunk_size: int) -> "StreamDecoder":
        """A fixed-window streaming decoder (``StreamDecoder``)."""
        return StreamDecoder(self, chunk_size)

    def stateful_stream_decoder(self) -> "StatefulStreamDecoder":
        """An exact streaming decoder carrying the codec's state (no
        context window): ``StatefulStreamDecoder``."""
        return StatefulStreamDecoder(self)

    def stream_state(self) -> Dict:
        """Fresh batch-1 codec streaming state."""
        return codec_lib.stream_init(self.params, self.cfg, 1)

    def stream_state_batched(self, batch: int) -> Dict:
        """Fresh codec streaming state of ``batch`` rows: every leaf has a
        leading batch axis, and each row its own frame counter."""
        return codec_lib.stream_init(self.params, self.cfg, batch)

    @torch.inference_mode()
    def scatter_stream_row(self, batched_state: Dict, row_state: Dict, row: int) -> Dict:
        """Write a batch-1 stream state into row ``row`` of a batched one, in
        place (a captured chunk keeps reading the same tensors), and return
        the batched state; ``row_state`` is left as it was."""
        def scatter(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    scatter(dst[k], src[k])
            elif isinstance(dst, list):
                for d, s in zip(dst, src, strict=True):
                    scatter(d, s)
            else:
                dst[row].copy_(src[0])

        scatter(batched_state, row_state)
        return batched_state

    @torch.inference_mode()
    def stream_feed(self, state: Dict, codes, collect_audio: bool = True
                    ) -> Tuple[Optional[np.ndarray], Dict]:
        """Feed frames [n, 16] through the streaming state.  Returns
        (audio float32 [n*spf], state').  With ``collect_audio=False`` the
        audio stays on the device and ``None`` is returned in its place (ICL
        priming discards it), so nothing waits for the card."""
        codes = np.asarray(codes, np.int64)
        if len(codes) == 0:
            return (np.zeros((0,), np.float32) if collect_audio else None), state
        wav, state = codec_lib.decode_stream(self.params, self.cfg, state,
                                             self._codes(codes)[None])
        return (wav[0].cpu().numpy() if collect_audio else None), state

    @torch.inference_mode()
    def encode(self, wav: np.ndarray) -> np.ndarray:
        """waveform [N] at ``cfg.sample_rate`` -> codes [T, 16] int32,
        T = N // spf (the trailing partial frame is dropped)."""
        T = len(wav) // self.spf
        if T == 0:
            return np.zeros((0, self.cfg.num_quantizers), np.int32)
        x = torch.from_numpy(np.ascontiguousarray(wav[: T * self.spf], np.float32))
        codes = codec_lib.encode(self.params, self.cfg, x.to(self.device)[None])
        return codes[0].cpu().numpy()


class StreamDecoder:
    """Per-generation streaming decoder over a fixed window: each ``feed``
    decodes ``context_frames + chunk_size`` frames (the latest ones,
    right-padded to the window while there are fewer) and returns only the
    new frames' samples, exact by the codec's strict causality."""

    def __init__(self, vocoder: Vocoder, chunk_size: int):
        self.v = vocoder
        self.window = vocoder.context_frames + chunk_size
        self.history: List[np.ndarray] = []  # every frame so far, [n, 16] each
        self.n_emitted_frames = 0

    def feed(self, new_codes: np.ndarray) -> np.ndarray:
        """new_codes [n, 16] -> the new audio samples [n * spf] float32."""
        n_new = new_codes.shape[0]
        if n_new == 0:
            return np.zeros((0,), np.float32)
        self.history.append(np.asarray(new_codes, np.int64))
        all_codes = np.concatenate(self.history, axis=0)
        total, spf, W = all_codes.shape[0], self.v.spf, self.window
        if n_new > W:  # a chunk longer than the window: decode everything, bucketed
            wav = self.v._decode_padded(all_codes, _bucket(total))
            out = wav[self.n_emitted_frames * spf: total * spf]
        else:
            win = all_codes[max(0, total - W):]
            n_valid = win.shape[0]
            wav = self.v._decode_padded(win, W)
            out = wav[(n_valid - n_new) * spf: n_valid * spf]
        self.n_emitted_frames = total
        return out


class StatefulStreamDecoder:
    """Streaming decoder over the codec's stream state: each ``feed`` decodes
    only its own frames, and the concatenated output equals a full decode."""

    def __init__(self, vocoder: Vocoder):
        self.v = vocoder
        self.state = vocoder.stream_state()

    def feed(self, new_codes: np.ndarray) -> np.ndarray:
        audio, self.state = self.v.stream_feed(self.state, new_codes)
        return audio
