"""Golden-fixture parity: export a greedy token sequence, replay it later.

Port of ``qwen3tts_tpu/core/fixtures.py``, with the same ``.npz`` format and
``FIXTURE_VERSION``, so that each package checks the fixtures the other
exported:

  tokens            int32 [steps, 16]  — the full codec-id parity sequence
  prefill_embeds    float32 [T, H]     — OPTIONAL full prefill embeddings
  meta              json str: {text, language, speaker, mode, seed,
                     max_new_tokens, greedy, prefill_sha256, fixture_version}

``export_model_fixture`` runs the model's parity path (the per-step loop,
``runtime/loops.py:parity_generate``) with both policies greedy, so the
tokens do not depend on the generator (the port samples with Philox, JAX
with threefry), and stores them with a checksum of the host float32 prompt.
``check_model_fixture`` replays the stored recipe and asserts (a) the
checksum — a mismatch means the PROMPT ASSEMBLY drifted — and (b) every
token — a mismatch with the checksum equal means the DECODE NUMERICS
drifted.  On the card both run with TF32 off for matmuls and cuDNN (the
counterpart of JAX's ``default_matmul_precision("float32")``), restored
after.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

FIXTURE_VERSION = 1


def _embeds_sha256(embeds: np.ndarray) -> str:
    """Checksum of the prompt embeddings as contiguous float32 bytes (the
    host prompt assembly is deterministic numpy)."""
    arr = np.ascontiguousarray(np.asarray(embeds, np.float32))
    return hashlib.sha256(arr.tobytes()).hexdigest()


def export_fixture(path, *, tokens: np.ndarray, prefill_embeds: np.ndarray, meta: Dict,
                   store_embeds: bool = False) -> None:
    """Write a golden parity fixture.  ``meta`` must carry the prompt recipe
    (text/language/mode/seed/sampling knobs) so ``check_fixture`` can replay
    it without ambiguity.  ``prefill_embeds``: [B, T, H] or [T, H]."""
    pe = np.asarray(prefill_embeds, np.float32)
    if pe.ndim == 3:
        pe = pe[0]
    meta = dict(meta)
    meta["prefill_sha256"] = _embeds_sha256(pe)
    meta["fixture_version"] = FIXTURE_VERSION
    arrays = {"tokens": np.asarray(tokens, np.int32),
              "meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
    if store_embeds:
        arrays["prefill_embeds"] = pe
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_fixture(path) -> Tuple[np.ndarray, Dict, Optional[np.ndarray]]:
    """Returns (tokens, meta, prefill_embeds|None)."""
    with np.load(Path(path)) as z:
        tokens = z["tokens"]
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        pe = z["prefill_embeds"] if "prefill_embeds" in z.files else None
    if meta.get("fixture_version", 0) > FIXTURE_VERSION:
        raise ValueError(f"fixture {path} is from a newer format version")
    return tokens, meta, pe


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for matmuls and cuDNN inside the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _greedy_tokens(model, embeds, trailing, tpe, seed: int, max_new_tokens: int) -> np.ndarray:
    from ..models.predictor import SamplingPolicy
    from ..runtime import loops
    from ..runtime.engine import GenerationPolicy

    gen = torch.Generator(device=model.device).manual_seed(seed)
    with float32_matmuls():
        tokens, _ = loops.parity_generate(
            model.engine, embeds, trailing, tpe, generator=gen,
            max_new_tokens=max_new_tokens, policy=GenerationPolicy(do_sample=False),
            pred_policy=SamplingPolicy(do_sample=False))
    return np.zeros((0, 16), np.int32) if tokens is None else np.asarray(tokens)


def _plain_prompt(model, text: str, language: str):
    """The host float32 prompt of a plain (no voice) request."""
    return model.prompt_builder.build(input_ids=model.tokenizer.build_assistant_ids(text),
                                      language=language, non_streaming_mode=True)


def export_model_fixture(model, path, *, text: str, language: str = "english",
                         speaker: Optional[str] = None, seed: int = 1337,
                         max_new_tokens: int = 64, store_embeds: bool = False) -> Dict:
    """One-command fixture export: run ``model``'s parity path, greedy, and
    store the token sequence + prompt checksum.  Returns the meta dict."""
    if speaker is not None:
        embeds, trailing, tpe = model._prepare_custom(text, language, speaker, None)
        # the custom path has no checksum contract; as the JAX package, it
        # stores the checksum of the prompt in the model dtype
        hashed = torch.from_numpy(np.asarray(embeds, np.float32)).to(model.dtype).float().numpy()
        mode = "custom"
    else:
        # checksum the HOST float32 prompt (check_model_fixture hashes the
        # same representation, before the model-dtype cast)
        embeds, trailing, tpe = _plain_prompt(model, text, language)
        hashed = embeds
        mode = "plain"
    tokens = _greedy_tokens(model, embeds, trailing, tpe, seed, max_new_tokens)
    meta = {"text": text, "language": language, "speaker": speaker,
            "mode": mode, "seed": seed, "max_new_tokens": max_new_tokens,
            "greedy": True}
    export_fixture(path, tokens=tokens, prefill_embeds=hashed, meta=meta,
                   store_embeds=store_embeds)
    return meta


def check_model_fixture(model, path) -> None:
    """Replay a fixture through ``model`` and check exact parity.

    Raises AssertionError (also under ``python -O``) with a targeted
    message: a prefill-checksum mismatch means the PROMPT ASSEMBLY drifted;
    a token mismatch with matching checksum means the DECODE NUMERICS
    drifted.  A custom-voice fixture (``speaker`` set) is held to its tokens
    only."""
    golden_tokens, meta, _ = load_fixture(path)
    if meta.get("speaker") is not None:
        embeds, trailing, tpe = model._prepare_custom(
            meta["text"], meta["language"], meta["speaker"], None)
    else:
        embeds, trailing, tpe = _plain_prompt(model, meta["text"], meta["language"])
        got_sha = _embeds_sha256(np.asarray(embeds)[0])
        if got_sha != meta["prefill_sha256"]:
            raise AssertionError(
                f"PROMPT ASSEMBLY drift: prefill embedding checksum {got_sha[:12]} "
                f"!= fixture {meta['prefill_sha256'][:12]} (layout/tokenizer/"
                f"embedding-table change)")
    tokens = _greedy_tokens(model, embeds, trailing, tpe, meta["seed"], meta["max_new_tokens"])
    if tokens.shape != golden_tokens.shape:
        raise AssertionError(
            f"DECODE drift: {tokens.shape[0]} steps vs golden {golden_tokens.shape[0]}")
    bad = np.argwhere(tokens != golden_tokens)
    if bad.size:
        raise AssertionError(f"DECODE drift: first token mismatch at step {bad[0][0]} "
                             f"codebook {bad[0][1]}")
