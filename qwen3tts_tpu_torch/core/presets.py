"""Built-in model architecture presets.

With no checkpoint on disk, ``from_pretrained("random:<preset>")`` builds a
deterministic randomly-initialised model of the given architecture.  The
full-size presets match the compute shape of the published Qwen3-TTS-12Hz
checkpoints (0.6B / 1.7B talkers — reference README model table), so
benchmarks on random weights measure the same FLOP/byte profile as real ones.
"""
from __future__ import annotations

from .config import (
    CodecConfig,
    PredictorConfig,
    SpeakerEncoderConfig,
    TalkerConfig,
    TTSModelConfig,
)


def _talker_06b() -> TalkerConfig:
    return TalkerConfig(
        hidden_size=1024,
        num_hidden_layers=28,
        num_attention_heads=16,
        num_key_value_heads=8,
        head_dim=128,
        intermediate_size=3072,
        text_hidden_size=1024,
    )


def _talker_17b() -> TalkerConfig:
    return TalkerConfig(
        hidden_size=2048,
        num_hidden_layers=28,
        num_attention_heads=16,
        num_key_value_heads=8,
        head_dim=128,
        intermediate_size=6144,
        text_hidden_size=2048,
    )


# LFM2-8B-A1B's layer pattern (huggingface.co/LiquidAI/LFM2-8B-A1B config.json)
LFM2_8B_A1B_LAYERS = tuple("full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv"
                           for i in range(24))


def _talker_lfm2_8b_a1b() -> TalkerConfig:
    """LFM2-8B-A1B's backbone at its published widths as the talker: 18
    gated short-convolution layers and 6 GQA layers (32 / 8 heads of 64),
    two dense SwiGLU layers, then 32 routed experts of 1,792, top 4.  The TTS
    side (codec vocabulary and ids, the 151,936-id text side at width 2,048,
    the 2,048-wide x-vector) is the 1.7B's; LFM2's own 65,536-id embedding
    and head are not used.  With one position on all three axes the MRoPE
    sections (summing to 32) give LFM2's 1-D rotary positions."""
    return TalkerConfig(
        hidden_size=2048,
        num_hidden_layers=24,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=64,
        intermediate_size=7168,
        rms_norm_eps=1e-5,
        rope_theta=1_000_000.0,
        mrope_section=(12, 10, 10),
        text_hidden_size=2048,
        layer_types=LFM2_8B_A1B_LAYERS,
        max_position_embeddings=128_000,
        conv_L_cache=3,
        conv_bias=False,
        num_experts=32,
        num_experts_per_tok=4,
        moe_intermediate_size=1792,
        num_dense_layers=2,
        use_expert_bias=True,
        norm_topk_prob=True,
        routed_scaling_factor=1.0,
    )


def _predictor(hidden: int) -> PredictorConfig:
    return PredictorConfig(
        hidden_size=1024,
        num_hidden_layers=5,
        num_attention_heads=16,
        num_key_value_heads=8,
        head_dim=64,
        intermediate_size=3072,
    )


def _tiny_talker() -> TalkerConfig:
    return TalkerConfig(
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        intermediate_size=128,
        mrope_section=(4, 2, 2),
        vocab_size=3072,
        text_vocab_size=512,
        text_hidden_size=64,
        speaker_embed_dim=64,
    )


def _tiny_lfm2_talker() -> TalkerConfig:
    """A hybrid talker for the CPU tests: conv, conv, attention twice, one
    dense layer, then 8 routed experts at top 2, head_dim 16."""
    return TalkerConfig(
        hidden_size=64,
        num_hidden_layers=6,
        num_attention_heads=4,
        num_key_value_heads=1,
        head_dim=16,
        intermediate_size=128,
        rms_norm_eps=1e-5,
        mrope_section=(4, 2, 2),
        vocab_size=3072,
        text_vocab_size=512,
        text_hidden_size=64,
        speaker_embed_dim=64,
        layer_types=("conv", "conv", "full_attention") * 2,
        conv_L_cache=3,
        num_experts=8,
        num_experts_per_tok=2,
        moe_intermediate_size=32,
        num_dense_layers=1,
        use_expert_bias=True,
        norm_topk_prob=True,
        routed_scaling_factor=1.0,
    )


def _tiny_predictor() -> PredictorConfig:
    return PredictorConfig(
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=2,
        num_key_value_heads=1,
        head_dim=16,
        intermediate_size=64,
    )


def _tiny_codec() -> CodecConfig:
    return CodecConfig(
        codebook_size=2048,
        num_quantizers=16,
        hidden_size=32,
        num_hidden_layers=1,
        num_attention_heads=2,
        num_key_value_heads=2,
        head_dim=16,
        intermediate_size=64,
        decoder_dim=32,
        upsample_rates=(5, 5, 4, 5),
        upsampling_ratios=(2, 2),
    )


def _tiny_speaker() -> SpeakerEncoderConfig:
    return SpeakerEncoderConfig(mel_bins=20, channels=32, emb_dim=64, attention_channels=16)


PRESETS = {}


def _register(name: str, cfg: TTSModelConfig):
    PRESETS[name] = cfg


_register(
    "qwen3-tts-0.6b",
    TTSModelConfig(model_type="base", model_size="0.6b", talker=_talker_06b(), predictor=_predictor(1024)),
)
_register(
    "qwen3-tts-1.7b",
    TTSModelConfig(model_type="base", model_size="1.7b", talker=_talker_17b(), predictor=_predictor(2048)),
)
_register(
    "qwen3-tts-0.6b-custom",
    TTSModelConfig(model_type="custom_voice", model_size="0.6b", talker=_talker_06b(), predictor=_predictor(1024)),
)
_register(
    "qwen3-tts-1.7b-custom",
    TTSModelConfig(model_type="custom_voice", model_size="1.7b", talker=_talker_17b(), predictor=_predictor(2048)),
)
_register(
    "qwen3-tts-1.7b-design",
    TTSModelConfig(model_type="voice_design", model_size="1.7b", talker=_talker_17b(), predictor=_predictor(2048)),
)
_register(
    "lfm2-8b-a1b-tts",
    TTSModelConfig(model_type="base", model_size="lfm2-8b-a1b", talker=_talker_lfm2_8b_a1b(),
                   predictor=_predictor(2048)),
)
# tiny presets: tts control-token ids must live inside the small text vocab
_TINY_TTS_IDS = dict(tts_pad_token_id=505, tts_bos_token_id=506, tts_eos_token_id=507)

_register(
    "tiny",
    TTSModelConfig(
        model_type="base",
        model_size="tiny",
        talker=_tiny_talker(),
        predictor=_tiny_predictor(),
        codec=_tiny_codec(),
        speaker_encoder=_tiny_speaker(),
        dtype="float32",
        **_TINY_TTS_IDS,
    ),
)
_register(
    "tiny-custom",
    TTSModelConfig(
        model_type="custom_voice",
        model_size="tiny",
        talker=_tiny_talker(),
        predictor=_tiny_predictor(),
        codec=_tiny_codec(),
        speaker_encoder=_tiny_speaker(),
        dtype="float32",
        **_TINY_TTS_IDS,
    ),
)
_register(
    "tiny-design",
    TTSModelConfig(
        model_type="voice_design",
        model_size="tiny",
        talker=_tiny_talker(),
        predictor=_tiny_predictor(),
        codec=_tiny_codec(),
        speaker_encoder=_tiny_speaker(),
        dtype="float32",
        **_TINY_TTS_IDS,
    ),
)
_register(
    "tiny-lfm2",
    TTSModelConfig(
        model_type="base",
        model_size="tiny",
        talker=_tiny_lfm2_talker(),
        predictor=_tiny_predictor(),
        codec=_tiny_codec(),
        speaker_encoder=_tiny_speaker(),
        dtype="float32",
        **_TINY_TTS_IDS,
    ),
)


def get_preset(name: str) -> TTSModelConfig:
    key = name.lower()
    if key not in PRESETS:
        raise KeyError(f"Unknown preset '{name}'. Available: {sorted(PRESETS)}")
    return PRESETS[key]
