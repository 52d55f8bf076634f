"""Talker prompt assembly on the host, in numpy.

Copy of ``qwen3tts_tpu/api/prompt.py`` for the PyTorch port (the JAX
package cannot be imported without JAX).  The layout is unchanged:

  [role(3)] [think block + optional speaker + codec_pad] then either
    streaming:      [text0+codec_bos]                  (trailing = text1.. + tts_eos)
    non-streaming:  [all text + tts_eos over codec_pad] [tts_pad+codec_bos]
                                                       (trailing = tts_pad)
    ICL:            [text0+codec_bos] [text_j+ref_frame_j-1 ...]
                                                       (trailing = unconsumed text)

Every codec-frame embedding is the sum of the talker codebook-0 embedding
and the 15 predictor codebook embeddings.  The only change from the JAX
module is the constructor, which takes torch parameters: numpy has no
bfloat16, so the text-embedding table stays a CPU torch tensor in the model
dtype and its rows are gathered in torch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import TTSModelConfig

Array = np.ndarray


class PromptError(ValueError):
    pass


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


class PromptBuilder:
    """Host-side prompt assembler.  Copies the embedding-related params to
    the host once at construction; ``build`` runs on the host."""

    def __init__(self, tparams: Dict, pparams: Dict, cfg: TTSModelConfig):
        self.cfg = cfg
        # device→host copies (once per model load)
        self.codec_embedding = _np32(tparams["codec_embedding"])  # [V, H]
        self.text_embedding = tparams["text_embedding"].detach().cpu()  # keep dtype
        self.text_proj_w = _np32(tparams["text_projection"]["w"])
        self.text_proj_b = _np32(tparams["text_projection"]["b"])
        self.spk_proj_w = _np32(tparams["spk_proj"]["w"])
        self.spk_proj_b = _np32(tparams["spk_proj"]["b"])
        self.pred_codec_embeddings = _np32(pparams["codec_embeddings"])  # [15, CB, H]

    # -- primitive embeddings -----------------------------------------
    def etext(self, ids: Array) -> Array:
        """text ids [1, T] → projected talker-space embeddings [1, T, H]."""
        idx = np.asarray(ids, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.text_embedding.shape[0]):
            raise PromptError(
                f"text token id out of range: {idx.min()}..{idx.max()} for "
                f"vocab {self.text_embedding.shape[0]}")
        rows = self.text_embedding[torch.from_numpy(idx)].float().numpy()
        return rows @ self.text_proj_w + self.text_proj_b

    def ecodec(self, ids) -> Array:
        return self.codec_embedding[np.asarray(ids, np.int64)]

    def project_speaker(self, xvec: Array) -> Array:
        return _np32(xvec) @ self.spk_proj_w + self.spk_proj_b

    def frame_embeds(self, codes: Array) -> Array:
        """codes [T,16] → per-frame summed embeddings [1, T, H]
        (reference generate.py:163-166 representation)."""
        codes = np.asarray(codes, np.int64)
        emb = self.codec_embedding[codes[:, 0]]
        for i in range(self.pred_codec_embeddings.shape[0]):
            emb = emb + self.pred_codec_embeddings[i][codes[:, i + 1]]
        return emb[None]

    # -- the layout ----------------------------------------------------
    def build(
        self,
        *,
        input_ids: Array,  # [1, L] assistant-templated target text
        ref_ids: Optional[Array] = None,  # [1, Lr] ref transcript (ICL)
        spk_embedding: Optional[Array] = None,  # [H] talker-space speaker embed
        ref_codes: Optional[Array] = None,  # [Tr, 16]
        icl_mode: bool = False,
        language: str = "English",
        speaker: Optional[str] = None,
        non_streaming_mode: bool = False,
        instruct_ids: Optional[Array] = None,
    ) -> Tuple[Array, Array, Array]:
        """Returns float32 (talker_input_embeds [1,T,H], trailing [1,Tt,H],
        tts_pad_embed [1,1,H]).  Raises PromptError for unknown
        speaker/language (reference model.py:367-368, 383-384)."""
        tk = self.cfg.talker
        cfg = self.cfg

        parts = []
        if instruct_ids is not None:
            parts.append(self.etext(instruct_ids))

        # --- speaker embedding (reference model.py:362-377)
        if spk_embedding is not None:
            speaker_embed = np.reshape(_np32(spk_embedding), (1, 1, -1))
        elif speaker:
            if speaker.lower() not in tk.spk_id:
                raise PromptError(f"Speaker {speaker} not implemented")
            speaker_embed = self.ecodec([[tk.spk_id[speaker.lower()]]])
        else:
            speaker_embed = None

        # --- language id + dialect override (reference model.py:379-393)
        if language is None or language.lower() == "auto":
            language_id = None
        else:
            if language.lower() not in tk.codec_language_id:
                raise PromptError(f"Language {language} not implemented")
            language_id = tk.codec_language_id[language.lower()]
        if (
            (language is None or language.lower() in ("chinese", "auto"))
            and speaker
            and tk.spk_is_dialect.get(speaker.lower())
        ):
            language_id = tk.codec_language_id[tk.spk_is_dialect[speaker.lower()]]

        # --- tts control-token text embeddings (reference model.py:395-403)
        ctl = self.etext([[cfg.tts_bos_token_id, cfg.tts_eos_token_id,
                           cfg.tts_pad_token_id]])
        tts_bos, tts_eos, tts_pad = ctl[:, 0:1], ctl[:, 1:2], ctl[:, 2:3]

        # --- think/language block (reference model.py:405-417)
        if language_id is None:
            prefill_ids = [tk.codec_nothink_id, tk.codec_think_bos_id,
                           tk.codec_think_eos_id]
        else:
            prefill_ids = [tk.codec_think_id, tk.codec_think_bos_id, language_id,
                           tk.codec_think_eos_id]
        codec_emb_0 = self.ecodec([prefill_ids])
        codec_emb_1 = self.ecodec([[tk.codec_pad_id, tk.codec_bos_id]])
        if speaker_embed is None:
            codec_input = np.concatenate([codec_emb_0, codec_emb_1], axis=1)
        else:
            codec_input = np.concatenate(
                [codec_emb_0, speaker_embed, codec_emb_1], axis=1)

        # --- role prefix + head (reference model.py:434-445)
        role = self.etext(input_ids[:, :3])
        n_head = codec_input.shape[1] - 2
        head = (
            np.concatenate(
                [np.broadcast_to(tts_pad, (1, n_head, tts_pad.shape[-1])), tts_bos],
                axis=1,
            )
            + codec_input[:, :-1]
        )
        talker_input = np.concatenate([role, head], axis=1)
        bos_emb = codec_input[:, -1:]

        text_ids = input_ids[:, 3:-5]

        if icl_mode and ref_codes is not None and ref_ids is not None:
            # --- ICL: position-aligned text+codec sum over reference frames
            full_text = np.concatenate(
                [self.etext(ref_ids[:, 3:-2]), self.etext(text_ids)], axis=1)
            L = full_text.shape[1]
            frames = self.frame_embeds(ref_codes)
            Tr = frames.shape[1]
            text_seq = np.concatenate([full_text, tts_eos], axis=1)  # [1, L+1, H]

            if non_streaming_mode:
                pad_codes = self.ecodec([[tk.codec_pad_id] * (L + 1)])
                part1 = text_seq + pad_codes
                part2 = tts_pad + bos_emb
                part3 = np.broadcast_to(tts_pad, (1, Tr, tts_pad.shape[-1])) + frames
                talker_input = np.concatenate(
                    [talker_input, part1, part2, part3], axis=1)
                trailing = tts_pad
            else:
                need = 1 + Tr
                if text_seq.shape[1] < need:
                    pad_n = need - text_seq.shape[1]
                    text_seq_p = np.concatenate(
                        [text_seq,
                         np.broadcast_to(tts_pad, (1, pad_n, tts_pad.shape[-1]))],
                        axis=1)
                else:
                    text_seq_p = text_seq
                pos0 = text_seq_p[:, 0:1] + bos_emb
                body = text_seq_p[:, 1 : 1 + Tr] + frames
                talker_input = np.concatenate([talker_input, pos0, body], axis=1)
                if 1 + Tr < L + 1:
                    trailing = text_seq[:, 1 + Tr :]
                else:
                    trailing = tts_pad  # exhausted — engine falls back to pad
        else:
            first_tok = self.etext(input_ids[:, 3:4]) + bos_emb
            talker_input = np.concatenate([talker_input, first_tok], axis=1)
            if non_streaming_mode:
                # (reference model.py:472-504): full text + tts_eos over
                # codec_pad packed into the prefill, then tts_pad + codec_bos
                talker_input = talker_input[:, :-1]
                n_text = text_ids.shape[1]
                pad_codes = self.ecodec([[tk.codec_pad_id] * (n_text + 1)])
                packed = np.concatenate([self.etext(text_ids), tts_eos], axis=1) + pad_codes
                last = tts_pad + self.ecodec([[tk.codec_bos_id]])
                talker_input = np.concatenate([talker_input, packed, last], axis=1)
                trailing = tts_pad
            else:
                trailing = np.concatenate(
                    [self.etext(input_ids[:, 4:-5]), tts_eos], axis=1)

        parts.append(talker_input)
        talker_input = np.concatenate(parts, axis=1)
        return talker_input, np.ascontiguousarray(trailing), tts_pad


def build_talker_inputs(
    tparams: Dict,
    pparams: Dict,
    cfg: TTSModelConfig,
    **kwargs,
):
    """Functional wrapper (constructs a throwaway PromptBuilder — fine for
    tests; the API layer holds a persistent one)."""
    return PromptBuilder(tparams, pparams, cfg).build(**kwargs)
