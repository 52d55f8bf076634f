"""Configuration dataclasses for the PyTorch port of Qwen3-TTS.

The same dataclasses as ``qwen3tts_tpu/core/config.py``, with its
``config.json`` readers and writers (``from_json`` / ``from_dict`` parse the
upstream HF key layout, ``to_hf_dict`` writes it, ``to_dict`` is the
canonical nested layout); the dtype mapping differs (torch dtypes instead
of jnp).

Every sub-model has an explicit config dataclass; ``presets.py`` provides
self-consistent architectures for the 0.6B / 1.7B model families.  The codec
runs at 12 Hz with 16 codebooks per frame, and the static talker cache
defaults to 2048 slots.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch


DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": torch.float32, "fp32": torch.float32,
          "float16": torch.float16, "fp16": torch.float16}


def _dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def dtype_name(dtype) -> str:
    """torch dtype (or any name in DTYPES) -> canonical config name."""
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    return {torch.bfloat16: "bfloat16", torch.float32: "float32",
            torch.float16: "float16"}[dtype]


def normalize_model_size(size: Any) -> str:
    """Canonicalize the model-size tag: '0b6' / '0.6B' / '600m' → '0.6b'.

    Upstream checkpoints spell it '0b6'; normalizing at config load means
    size checks are plain equality."""
    s = str(size).strip().lower()
    return {"0b6": "0.6b", "0.6b": "0.6b", "600m": "0.6b",
            "1b7": "1.7b", "1.7b": "1.7b"}.get(s, s)


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    """28-layer Qwen3-style decoder that emits the first codec codebook.

    MRoPE with 3 position axes (reference: talker_graph.py:53 keeps a
    ``[3,1,1]`` position buffer); for TTS all three axes carry the same
    position, ``mrope_section`` controls the per-axis split of rotary dims.
    """

    hidden_size: int = 1024
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: Tuple[int, int, int] = (24, 20, 20)  # sums to head_dim // 2
    # Codec-token vocabulary: first `codec_codebook_size` ids are acoustic
    # codes; the trailing 1024-id zone holds control tokens (suppressed during
    # sampling except EOS — reference generate.py:46-50).
    vocab_size: int = 3072
    codec_codebook_size: int = 2048
    num_code_groups: int = 16
    # Text side: token embeddings come from the text LM vocab and are projected
    # into the talker's hidden space (reference model.py:353, 395-403).
    text_vocab_size: int = 151_936
    text_hidden_size: int = 1024
    # x-vector dimension accepted by the speaker projection
    # (reference artifact: 2048-dim bf16, README.md:411)
    speaker_embed_dim: int = 2048
    # Sliding-window attention: layer_types[i] in {"full_attention",
    # "sliding_attention"}; None => all full.
    sliding_window: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None
    max_position_embeddings: int = 32768
    # --- the hybrid (LFM2) talker, under its source config's names: a
    # layer_types entry "conv" is a gated short convolution of conv_L_cache
    # taps, the rest "full_attention"; the first num_dense_layers layers have
    # a SwiGLU FFN of intermediate_size, the others num_experts routed experts
    # of moe_intermediate_size, num_experts_per_tok a token (models/lfm2.py).
    # A Qwen3 talker's dicts leave them out where they are at their defaults.
    conv_L_cache: int = 3
    conv_bias: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    num_dense_layers: int = 0
    use_expert_bias: bool = False
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0

    # --- special codec token ids (control zone, near top of vocab) ---
    codec_eos_token_id: int = 2150
    codec_pad_id: int = 2148
    codec_bos_id: int = 2149
    codec_nothink_id: int = 2155
    codec_think_id: int = 2154
    codec_think_bos_id: int = 2156
    codec_think_eos_id: int = 2157
    # language-id and speaker-id tables live in the control zone as well
    codec_language_id: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "chinese": 2160,
            "english": 2161,
            "german": 2162,
            "italian": 2163,
            "portuguese": 2164,
            "spanish": 2165,
            "japanese": 2166,
            "korean": 2167,
            "french": 2168,
            "russian": 2169,
            "cantonese": 2170,
            "beijing_dialect": 2171,
            "sichuan_dialect": 2172,
            "shanghai_dialect": 2173,
        }
    )
    spk_id: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "vivian": 2300,
            "serena": 2301,
            "uncle_fu": 2302,
            "dylan": 2303,
            "eric": 2304,
            "ryan": 2305,
            "aiden": 2306,
            "lulu": 2307,
            "patrick": 2308,
        }
    )
    spk_is_dialect: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {
            "vivian": False,
            "serena": False,
            "uncle_fu": "beijing_dialect",
            "dylan": "beijing_dialect",
            "eric": "sichuan_dialect",
            "ryan": False,
            "aiden": False,
            "lulu": False,
            "patrick": False,
        }
    )

    def __hash__(self):
        # dict fields break the dataclass-generated hash; hash a stable repr.
        return hash(repr(self))

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    def layer_is_sliding(self, idx: int) -> bool:
        if self.sliding_window is None or self.layer_types is None:
            return False
        return self.layer_types[idx] == "sliding_attention"

    @property
    def is_hybrid(self) -> bool:
        """An LFM2 talker: some layer is a short convolution."""
        return self.layer_types is not None and "conv" in self.layer_types

    def as_dict(self) -> Dict[str, Any]:
        """``dataclasses.asdict``; a Qwen3 talker's without the hybrid keys,
        left at their defaults (so that its dict is the JAX package's)."""
        d = dataclasses.asdict(self)
        if not self.is_hybrid:
            for f in dataclasses.fields(self):
                if f.name in HYBRID_KEYS and d[f.name] == f.default:
                    del d[f.name]
        return d


HYBRID_KEYS = ("conv_L_cache", "conv_bias", "num_experts", "num_experts_per_tok",
               "moe_intermediate_size", "num_dense_layers", "use_expert_bias",
               "norm_topk_prob", "routed_scaling_factor")


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    """5-layer MTP transformer producing codebooks 1..15.

    Reference: predictor_graph.py:44-57 — ``num_codebooks = num_code_groups-1``,
    ``max_seq = 2 + num_codebooks``, per-codebook lm heads and embeddings.
    """

    hidden_size: int = 1024
    num_hidden_layers: int = 5
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    num_code_groups: int = 16
    codebook_size: int = 2048
    sliding_window: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None

    @property
    def num_codebooks(self) -> int:
        return self.num_code_groups - 1

    @property
    def max_seq(self) -> int:
        return 2 + self.num_codebooks

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """12 Hz neural codec (speech tokenizer): decoder (code→wav) and encoder.

    Decoder architecture follows the public Code2Wav family: summed RVQ code
    embeddings → sliding-window pre-transformer → ConvNeXt upsampling →
    BigVGAN-style SnakeBeta conv stack.  Total upsample must equal
    sample_rate / frame_rate (24000 / 12 = 2000).
    """

    codebook_size: int = 2048
    num_quantizers: int = 16
    hidden_size: int = 512
    num_hidden_layers: int = 4
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 1536
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    sliding_window: int = 72
    layer_scale_initial_scale: float = 0.01
    upsampling_ratios: Tuple[int, ...] = (2, 2)        # pre-decoder ConvNeXt stages
    upsample_rates: Tuple[int, ...] = (5, 5, 4, 5)     # decoder transposed-conv stages
    decoder_dim: int = 1024
    sample_rate: int = 24_000
    frame_rate: int = 12

    @property
    def total_upsample(self) -> int:
        t = 1
        for r in self.upsample_rates:
            t *= r
        for r in self.upsampling_ratios:
            t *= r
        return t

    def __post_init__(self):
        if self.total_upsample != self.sample_rate // self.frame_rate:
            raise ValueError(
                f"codec upsample {self.total_upsample} != "
                f"{self.sample_rate}/{self.frame_rate}"
            )


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    """ECAPA-TDNN-style x-vector speaker encoder → 2048-dim embedding.

    Reference artifact contract: 2048-dim bf16 ≈ 4 KB (README.md:411,
    examples/extract_speaker.py:32-39).
    """

    mel_bins: int = 80
    channels: int = 512
    emb_dim: int = 2048
    num_blocks: int = 3
    kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3)
    dilations: Tuple[int, ...] = (1, 2, 3, 4)
    attention_channels: int = 128
    sample_rate: int = 16_000


@dataclasses.dataclass(frozen=True)
class TTSModelConfig:
    """Top-level config for one Qwen3-TTS model instance."""

    model_type: str = "base"  # base | custom_voice | voice_design
    model_size: str = "0.6b"
    talker: TalkerConfig = dataclasses.field(default_factory=TalkerConfig)
    predictor: PredictorConfig = dataclasses.field(default_factory=PredictorConfig)
    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)
    speaker_encoder: SpeakerEncoderConfig = dataclasses.field(
        default_factory=SpeakerEncoderConfig
    )
    # Text-side special ids used by prompt assembly (reference model.py:395-403)
    tts_bos_token_id: int = 151_672
    tts_eos_token_id: int = 151_673
    tts_pad_token_id: int = 151_671
    dtype: str = "bfloat16"
    sample_rate: int = 24_000

    def __post_init__(self):
        object.__setattr__(self, "model_size", normalize_model_size(self.model_size))

    @property
    def torch_dtype(self) -> torch.dtype:
        return _dtype_of(self.dtype)

    # ------------------------------------------------------------------
    @staticmethod
    def from_json(path) -> "TTSModelConfig":
        """Load a HF-style checkpoint config.json (upstream key layout)."""
        return TTSModelConfig.from_dict(json.loads(Path(path).read_text()))

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "TTSModelConfig":
        tk = dict(raw.get("talker_config", {}))
        pred = dict(tk.pop("code_predictor_config", raw.get("code_predictor_config", {})))
        codec = dict(raw.get("speech_tokenizer_config", raw.get("code2wav_config", {})))
        spk = dict(raw.get("speaker_encoder_config", {}))

        def filt(cls, d):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in d.items() if k in names})

        return TTSModelConfig(
            model_type=raw.get("tts_model_type", raw.get("model_type", "base")),
            model_size=str(raw.get("tts_model_size", "0.6b")),
            talker=filt(TalkerConfig, tk),
            predictor=filt(PredictorConfig, pred),
            codec=filt(CodecConfig, codec) if codec else CodecConfig(),
            speaker_encoder=filt(SpeakerEncoderConfig, spk) if spk else SpeakerEncoderConfig(),
            tts_bos_token_id=raw.get("tts_bos_token_id", 151_672),
            tts_eos_token_id=raw.get("tts_eos_token_id", 151_673),
            tts_pad_token_id=raw.get("tts_pad_token_id", 151_671),
            dtype=raw.get("torch_dtype", "bfloat16"),
            sample_rate=raw.get("sample_rate", 24_000),
        )

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["talker"] = self.talker.as_dict()
        return d

    def to_hf_dict(self) -> Dict[str, Any]:
        """Serialize in the upstream HF key layout that ``from_dict`` parses
        (the config format of a torch-layout checkpoint dir)."""
        tk = self.talker.as_dict()
        tk["code_predictor_config"] = dataclasses.asdict(self.predictor)
        return {
            "tts_model_type": self.model_type,
            "tts_model_size": self.model_size,
            "talker_config": tk,
            "speech_tokenizer_config": dataclasses.asdict(self.codec),
            "speaker_encoder_config": dataclasses.asdict(self.speaker_encoder),
            "tts_bos_token_id": self.tts_bos_token_id,
            "tts_eos_token_id": self.tts_eos_token_id,
            "tts_pad_token_id": self.tts_pad_token_id,
            "torch_dtype": self.dtype,
            "sample_rate": self.sample_rate,
        }
