"""Codec vocoder: full decode and stateful streaming decode.

Port of ``qwen3tts_tpu/audio/vocoder.py`` (``Vocoder.decode``,
``stream_state`` and ``stream_feed``).  Codec
weights are stored in float32 and computed in ``compute_dtype`` (bfloat16 by
default, as in the JAX package).  PyTorch runs every length eagerly, so no
shape buckets are needed; the stream carries conv tails and attention
windows (models/codec.py), which makes chunked output sample-exact against a
full decode.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import CodecConfig
from ..models import codec as codec_lib


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

    def __init__(self, params: Dict, cfg: CodecConfig,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        self.cfg = cfg
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

    def stream_state(self) -> Dict:
        """Fresh batch-1 codec streaming state."""
        return codec_lib.stream_init(self.params, self.cfg, 1)

    @torch.inference_mode()
    def stream_feed(self, state: Dict, codes) -> Tuple[np.ndarray, Dict]:
        """Feed frames [n, 16] through the streaming state.  Returns
        (audio float32 [n*spf], state')."""
        codes = np.asarray(codes, np.int64)
        if len(codes) == 0:
            return np.zeros((0,), np.float32), state
        wav, state = codec_lib.decode_stream(self.params, self.cfg, state,
                                             self._codes(codes)[None])
        return wav[0].cpu().numpy(), state
