"""Plain PyTorch reference of Qwen3-TTS voice clone from an x-vector.

What the benchmark's check recomputes, in float32 with TF32 off, from the
weights and inputs the harness made: the x-vector of a reference waveform,
the talker prompt of the x-vector, non-streaming layout, the talker's
logits along given codec frames (one causal forward pass over prompt and
frames, no cache), the code predictor's logits along the same frames
(teacher forced, all frames at once) and the codec decoder's waveform of
the frames.  It follows the published architecture: Qwen3-style decoder
blocks (RMSNorm, GQA with per-head q/k RMSNorm and rotary positions,
SwiGLU), an ECAPA-style speaker encoder and a causal convolutional codec
decoder with a sliding-window pre-transformer.  The talker's decoder
stack is one method, ``Reference.talker_stack``: a reference of another
talker subclasses ``Reference``, replaces that method and keeps the rest.

It imports nothing but torch and numpy.  ``params`` is the nested dict of
tensors the harness drew (``bench_h100/weights.py``), in the layout the
program under test takes; ``cfg`` the configuration file's dict.  Matrices
are ``[in, out]``, stacked decoder weights carry a leading layer axis,
convolutions are ``[Cout, Cin, K]`` and transposed convolutions ``[Cin, Cout,
K]`` with K already reversed.

``lowp`` runs the codec decoder with every convolution and product input
rounded to float8 (e4m3, a per-tensor scale): the control of the audio
comparison, one precision below the decoder's bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict

# the byte-level text tokenizer's template ids (no tokenizer.json)
IM_START, IM_END, NL, ROLE_ASSISTANT = 0, 1, 2, 3
R0, R1, R2 = 6, 7, 8
BYTE_OFFSET = 16


def text_ids(text: str) -> list:
    """Assistant template: 3 role ids, the text's bytes, 5 suffix ids."""
    return ([IM_START, ROLE_ASSISTANT, NL] + [BYTE_OFFSET + b for b in text.encode("utf-8")]
            + [IM_END, NL, R0, R1, R2])


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _f(w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., T, heads, D] rotated by positions ``pos`` [T] (rotate-half)."""
    D = x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = pos.double()[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos().float()[:, None, :], emb.sin().float()[:, None, :]
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def attention(q, k, v, mask) -> torch.Tensor:
    """q [N, T, NH, D], k / v [N, S, KVH, D], mask [T, S] bool -> [N, T, NH*D]."""
    N, T, NH, D = q.shape
    G = NH // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("nthd,nshd->nhts", q, k) / math.sqrt(D)
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("nhts,nshd->nthd", torch.softmax(s, dim=-1), v)
    return o.reshape(N, T, NH * D)


def decoder_stack(blocks: Params, x: torch.Tensor, c: Dict, pos: torch.Tensor) -> torch.Tensor:
    """Causal Qwen3 blocks over x [N, T, H] at positions ``pos`` [T]."""
    if c.get("sliding_window") is not None:
        raise ValueError("the reference's decoder stack covers full attention only")
    L = blocks["input_norm"].shape[0]
    NH, KVH, D = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    I, eps = c["intermediate_size"], c["rms_norm_eps"]
    N, T, _ = x.shape
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    for li in range(L):
        h = rms(x, blocks["input_norm"][li], eps)
        qkv = h @ _f(blocks["qkv_proj"][li])
        q = qkv[..., : NH * D].reshape(N, T, NH, D)
        k = qkv[..., NH * D: (NH + KVH) * D].reshape(N, T, KVH, D)
        v = qkv[..., (NH + KVH) * D:].reshape(N, T, KVH, D)
        q = rope(rms(q, blocks["q_norm"][li], eps), pos, c["rope_theta"])
        k = rope(rms(k, blocks["k_norm"][li], eps), pos, c["rope_theta"])
        x = x + attention(q, k, v, mask) @ _f(blocks["o_proj"][li])
        h = rms(x, blocks["post_norm"][li], eps)
        gu = h @ _f(blocks["gateup_proj"][li])
        x = x + (F.silu(gu[..., :I]) * gu[..., I:]) @ _f(blocks["down_proj"][li])
    return x


class Reference:
    """The plain model of one configuration, on ``params``' device."""

    def __init__(self, params: Params, cfg: Dict):
        self.p = params
        self.cfg = cfg
        self.tc = cfg["talker_config"]
        self.pc = self.tc["code_predictor_config"]
        self.cc = cfg["speech_tokenizer_config"]
        self.sc = cfg["speaker_encoder_config"]
        self.device = params["talker"]["codec_embedding"].device

    # -- the x-vector ---------------------------------------------------
    def log_mel(self, wav: torch.Tensor) -> torch.Tensor:
        """25 ms Hann frames every 10 ms at 16 kHz, 512-point power
        spectrum, triangular mel filters, natural log floored at 1e-10."""
        win, hop, n_fft, sr, n_mels = 400, 160, 512, self.sc["sample_rate"], self.sc["mel_bins"]
        if wav.shape[0] < win:
            wav = F.pad(wav, (0, win - wav.shape[0]))
        frames = wav.unfold(0, win, hop)
        n = np.arange(win)
        hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (win - 1))
        spec = torch.fft.rfft(frames * torch.tensor(hann, dtype=torch.float32,
                                                    device=wav.device), n=n_fft).abs() ** 2
        mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
        hz = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)  # noqa: E731
        edges = np.floor((n_fft + 1) * hz(np.linspace(mel(0.0), mel(sr / 2), n_mels + 2)) / sr)
        edges = edges.astype(int)
        fb = np.zeros((n_fft // 2 + 1, n_mels), np.float32)
        for m in range(n_mels):
            lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
            fb[lo:mid, m] = (np.arange(lo, mid) - lo) / (mid - lo)
            fb[mid:hi, m] = (hi - np.arange(mid, hi)) / (hi - mid)
        return torch.log(torch.clamp_min(spec @ torch.tensor(fb, device=wav.device), 1e-10))

    @staticmethod
    def _same_conv(x, p, dilation: int = 1):
        """'Same' padding, (K-1)d//2 on the left and the rest on the right."""
        K = p["w"].shape[-1]
        tot = (K - 1) * dilation
        return F.conv1d(F.pad(x, (tot // 2, tot - tot // 2)), _f(p["w"]), _f(p["b"]),
                        dilation=dilation)

    def xvector(self, wav16k: np.ndarray) -> torch.Tensor:
        """The L2-normalised speaker embedding [emb_dim] of 16 kHz audio."""
        sp, sc = self.p["speaker"], self.sc
        mel = self.log_mel(torch.tensor(np.asarray(wav16k, np.float32), device=self.device))
        x = (mel - mel.mean(0, keepdim=True)).t()[None]
        x = F.relu(self._same_conv(x, sp["in_conv"]))
        feats = [x]
        dil = sc["dilations"]
        for i, blk in enumerate(sp["blocks"]):
            h = F.relu(self._same_conv(x, blk["conv"], dil[min(i + 1, len(dil) - 1)]))
            x = x + F.relu(self._same_conv(h, blk["pw"]))
            feats.append(x)
        x = F.relu(self._same_conv(torch.cat(feats, 1), sp["cat_conv"]))
        a = torch.softmax(self._same_conv(torch.tanh(self._same_conv(x, sp["att_w1"])),
                                          sp["att_w2"]), dim=-1)
        mean = (a * x).sum(-1)
        std = torch.sqrt(torch.clamp_min((a * x * x).sum(-1) - mean ** 2, 1e-9))
        emb = (torch.cat([mean, std], -1) @ _f(sp["out"]["w"]) + _f(sp["out"]["b"]))[0]
        return emb / torch.clamp_min(emb.norm(), 1e-9)

    # -- the prompt -----------------------------------------------------
    def _etext(self, ids) -> torch.Tensor:
        t = self.p["talker"]
        rows = _f(t["text_embedding"][torch.tensor(ids, device=self.device)])
        return rows @ _f(t["text_projection"]["w"]) + _f(t["text_projection"]["b"])

    def _ecodec(self, ids) -> torch.Tensor:
        return _f(self.p["talker"]["codec_embedding"][torch.tensor(ids, device=self.device)])

    def prompt(self, text: str, xvec: torch.Tensor, language: str = "english"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prompt embeddings [T, H], the tts_pad embedding [H]): role, the
        think block with the language, the speaker, codec pad, then every
        text token and tts_eos over codec pad, then tts_pad over codec bos."""
        tc, cfg, t = self.tc, self.cfg, self.p["talker"]
        ids = text_ids(text)
        bos, eos, pad = self._etext([cfg["tts_bos_token_id"], cfg["tts_eos_token_id"],
                                     cfg["tts_pad_token_id"]])
        spk = xvec @ _f(t["spk_proj"]["w"]) + _f(t["spk_proj"]["b"])
        think = self._ecodec([tc["codec_think_id"], tc["codec_think_bos_id"],
                              tc["codec_language_id"][language], tc["codec_think_eos_id"]])
        codec = torch.cat([think, spk[None], self._ecodec([tc["codec_pad_id"],
                                                           tc["codec_bos_id"]])])
        head = torch.cat([pad.expand(codec.shape[0] - 2, -1), bos[None]]) + codec[:-1]
        body = ids[3:-5]
        packed = torch.cat([self._etext(body), eos[None]]) + self._ecodec(
            [tc["codec_pad_id"]] * (len(body) + 1))
        last = pad[None] + self._ecodec([tc["codec_bos_id"]])
        return torch.cat([self._etext(ids[:3]), head, packed, last]), pad

    # -- the talker -----------------------------------------------------
    def frame_embeds(self, codes: torch.Tensor) -> torch.Tensor:
        """[F, 16] codes -> [F, H]: codebook 0's talker embedding plus the
        15 predictor codebook embeddings."""
        t, pr = self.p["talker"], self.p["predictor"]
        e = _f(t["codec_embedding"][codes[:, 0]])
        for i in range(codes.shape[1] - 1):
            e = e + _f(pr["codec_embeddings"][i][codes[:, i + 1]])
        return e

    def talker_stack(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The talker's decoder blocks over x [1, T, H] at positions ``pos``
        [T], before the final norm."""
        return decoder_stack(self.p["talker"]["blocks"], x, self.tc, pos)

    def talker(self, prompt: torch.Tensor, codes: torch.Tensor, tts_pad: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [F, V], final hidden [F, H]) that precede each frame's
        codebook-0 token: the prompt's last position for frame 0, the
        position fed frame f - 1 for frame f."""
        t, tc = self.p["talker"], self.tc
        x = torch.cat([prompt, self.frame_embeds(codes[:-1]) + tts_pad[None]])[None]
        T0 = prompt.shape[0]
        pos = torch.arange(x.shape[1], device=self.device)
        h = rms(self.talker_stack(x, pos)[0, T0 - 1:], t["final_norm"], tc["rms_norm_eps"])
        return h @ _f(t["codec_head"]), h

    # -- the code predictor ---------------------------------------------
    def predictor(self, hidden: torch.Tensor, codes: torch.Tensor,
                  block: int = 256) -> torch.Tensor:
        """Logits [F, 15, CB] of codebooks 1..15: per frame the sequence
        (talker hidden, codebook 0's talker embedding, codebooks 1..14's
        predictor embeddings), projected, through the blocks; head i reads
        position i + 1."""
        pr, pc, t = self.p["predictor"], self.pc, self.p["talker"]
        out = []
        for s in range(0, codes.shape[0], block):
            c, h = codes[s:s + block], hidden[s:s + block]
            seq = [h, _f(t["codec_embedding"][c[:, 0]])]
            seq += [_f(pr["codec_embeddings"][i][c[:, i + 1]]) for i in range(c.shape[1] - 2)]
            x = torch.stack(seq, 1) @ _f(pr["small_to_mtp"]["w"]) + _f(pr["small_to_mtp"]["b"])
            x = decoder_stack(pr["blocks"], x, pc, torch.arange(x.shape[1], device=self.device))
            x = rms(x, pr["final_norm"], pc["rms_norm_eps"])
            heads = _f(pr["lm_heads"])
            out.append(torch.einsum("nih,ihv->niv", x[:, 1:], heads))
        return torch.cat(out)

    # -- the codec decoder ------------------------------------------------
    def decode(self, codes: torch.Tensor, lowp: bool = False) -> torch.Tensor:
        """codes [F, 16] -> waveform [F * samples a frame], clamped to [-1, 1]."""
        cc, dec = self.cc, self.p["codec"]["decoder"]
        q = _fp8 if lowp else (lambda z: z)

        def lin(p, x):
            return q(x) @ q(_f(p["w"])) + _f(p["b"])

        def conv(x, p, dilation=1, groups=1, left=None):
            K = p["w"].shape[-1]
            pad = (K - 1) * dilation if left is None else left
            return F.conv1d(F.pad(q(x), (pad, 0)), q(_f(p["w"])), _f(p["b"]),
                            dilation=dilation, groups=groups)

        def tconv(x, p, stride):
            T = x.shape[-1]
            return (F.conv_transpose1d(q(x), q(_f(p["w"])), stride=stride)[..., : T * stride]
                    + _f(p["b"])[:, None])

        def snake(x, a, b):
            return x + torch.sin(x * torch.exp(_f(a))[:, None]) ** 2 / (
                torch.exp(_f(b))[:, None] + 1e-9)

        off = torch.arange(cc["num_quantizers"], device=self.device) * cc["codebook_size"]
        x = _f(dec["code_embedding"][codes.long() + off]).mean(1)[None]
        T = x.shape[1]
        NH, KVH, D = cc["num_attention_heads"], cc["num_key_value_heads"], cc["head_dim"]
        i = torch.arange(T, device=self.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - cc["sliding_window"])
        for p in dec["pre_transformer"]:
            h = rms(x, p["ln1"], cc["rms_norm_eps"])
            qh = rope(lin(p["q"], h).reshape(1, T, NH, D), i, cc["rope_theta"])
            kh = rope(lin(p["k"], h).reshape(1, T, KVH, D), i, cc["rope_theta"])
            vh = lin(p["v"], h).reshape(1, T, KVH, D)
            x = x + lin(p["o"], attention(qh, kh, vh, mask)) * _f(p["scale1"])
            h = rms(x, p["ln2"], cc["rms_norm_eps"])
            x = x + lin(p["down"], F.silu(lin(p["gate"], h)) * lin(p["up"], h)) * _f(p["scale2"])
        h = x.transpose(1, 2)
        for st, r in zip(dec["upsample"], cc["upsampling_ratios"]):
            h = tconv(h, st["tconv"], r)
            cn = st["convnext"]
            y = conv(h, cn["dw"], groups=h.shape[1]).transpose(1, 2)
            mu = y.mean(-1, keepdim=True)
            y = (y - mu) * torch.rsqrt((y - mu).pow(2).mean(-1, keepdim=True) + 1e-6)
            y = y * _f(cn["norm_w"]) + _f(cn["norm_b"])
            y = lin(cn["pw2"], F.gelu(lin(cn["pw1"], y), approximate="tanh"))
            h = h + (y * _f(cn["scale"])).transpose(1, 2)
        w = conv(h, dec["dec_in"])
        for blk, r in zip(dec["blocks"], cc["upsample_rates"]):
            w = tconv(snake(w, blk["alpha"], blk["beta"]), blk["tconv"], r)
            for unit, d in zip(blk["units"], (1, 3, 9)):
                y = conv(snake(w, unit["alpha1"], unit["beta1"]), unit["conv1"], dilation=d)
                w = w + conv(snake(y, unit["alpha2"], unit["beta2"]), unit["conv2"])
        w = conv(snake(w, dec["out_alpha"], dec["out_beta"]), dec["dec_out"])
        return torch.clamp(w[0, 0], -1.0, 1.0)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448)."""
    s = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s
