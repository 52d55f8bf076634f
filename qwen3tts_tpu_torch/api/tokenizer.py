"""Text tokenizer + chat templating.

Copy of ``qwen3tts_tpu/api/tokenizer.py`` for the PyTorch port, which cannot
import the JAX package.

The reference delegates to upstream ``_tokenize_texts`` / ``_build_*_text``
(model.py:223-228,260-261).  Here:

  - with a real checkpoint: wraps a HF ``tokenizers.Tokenizer`` loaded from
    ``tokenizer.json`` (same Rust tokenizer the upstream uses);
  - without (random presets): a deterministic byte-level fallback.

Template contract (consumed by prompt.py — indices must line up with the
layout slicing, reference model.py:434-436 role = ids[:,:3], text =
ids[:,3:-5], ref text = ids[:,3:-2]):

  assistant: [im_start, role_assistant, nl] + text + [im_end, nl, r0, r1, r2]
  ref:       [im_start, role_ref, nl]       + text + [im_end, nl]
  instruct:  [im_start, role_user, nl]      + text + [im_end, nl]
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

# special token ids for the byte-level fallback (first 16 ids reserved)
_IM_START, _IM_END, _NL = 0, 1, 2
_ROLE_ASSISTANT, _ROLE_USER, _ROLE_REF = 3, 4, 5
_R0, _R1, _R2 = 6, 7, 8
_BYTE_OFFSET = 16


class TextTokenizer:
    """Tokenizer + chat templates for talker prompts."""

    def __init__(self, tokenizer_json: Optional[str] = None, vocab_size: int = 512):
        self._hf = None
        self.vocab_size = vocab_size
        if tokenizer_json and Path(tokenizer_json).exists():
            from tokenizers import Tokenizer

            self._hf = Tokenizer.from_file(str(tokenizer_json))
            self.vocab_size = self._hf.get_vocab_size()

    # -- raw text → ids -------------------------------------------------
    def encode(self, text: str) -> List[int]:
        if self._hf is not None:
            return self._hf.encode(text, add_special_tokens=False).ids
        return [_BYTE_OFFSET + b for b in text.encode("utf-8")]

    # -- templates ------------------------------------------------------
    def _special(self, name: str) -> int:
        if self._hf is not None:
            tid = self._hf.token_to_id(name)
            if tid is not None:
                return tid
        return {
            "<|im_start|>": _IM_START,
            "<|im_end|>": _IM_END,
            "\n": _NL,
            "assistant": _ROLE_ASSISTANT,
            "user": _ROLE_USER,
            "ref": _ROLE_REF,
        }.get(name, _R0)

    def build_assistant_ids(self, text: str) -> np.ndarray:
        """3 role tokens + text + 5 suffix tokens (layout slices [:3], [3:-5])."""
        ids = (
            [self._special("<|im_start|>"), self._special("assistant"), self._special("\n")]
            + self.encode(text)
            + [self._special("<|im_end|>"), self._special("\n"), _R0, _R1, _R2]
        )
        return np.asarray([ids], np.int32)

    def build_ref_ids(self, text: str) -> np.ndarray:
        """3 role tokens + text + 2 suffix tokens (layout slice [3:-2])."""
        ids = (
            [self._special("<|im_start|>"), self._special("ref"), self._special("\n")]
            + self.encode(text)
            + [self._special("<|im_end|>"), self._special("\n")]
        )
        return np.asarray([ids], np.int32)

    def build_instruct_ids(self, text: str) -> np.ndarray:
        ids = (
            [self._special("<|im_start|>"), self._special("user"), self._special("\n")]
            + self.encode(text)
            + [self._special("<|im_end|>"), self._special("\n")]
        )
        return np.asarray([ids], np.int32)
