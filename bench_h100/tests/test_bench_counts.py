"""Operations and bytes from the configurations' shapes, worked by hand."""
import json
from pathlib import Path

import pytest

from counts import qwen3tts as c

CONF = Path(__file__).resolve().parents[1] / "configs"
CFG = {n: json.loads((CONF / f"{n}.json").read_text())
       for n in ("qwen3-tts-0.6b", "qwen3-tts-1.7b")}


@pytest.mark.parametrize("name,H,I", [("qwen3-tts-0.6b", 1024, 3072),
                                      ("qwen3-tts-1.7b", 2048, 6144)])
def test_step_products_by_hand(name, H, I):
    # talker block: qkv H x (16 + 2*8)*128, o 2048 x H, gate|up H x 2I, down I x H
    talker = 28 * (H * 4096 + 2048 * H + H * 2 * I + I * H) + H * 3072
    # predictor: proj H x 1024, 5 blocks of 1024 x 2048 + 1024 x 1024 + 1024 x 6144
    # + 3072 x 1024, run on 16 positions (2 + 14); 15 heads of 1024 x 2048
    pred = H * 1024 + 5 * (1024 * 2048 + 1024 * 1024 + 1024 * 6144 + 3072 * 1024)
    heads = 1024 * 2048
    ops, nbytes = c.step_products(CFG[name], 1)
    assert ops == pytest.approx(2 * (talker + 16 * pred + 15 * heads))
    weights = talker + 15 * pred + 15 * heads
    assert 2 * weights < nbytes < 2 * weights * 1.01  # activations add under 1 %
    ops16, nbytes16 = c.step_products(CFG[name], 16)
    assert ops16 == pytest.approx(16 * ops) and nbytes16 > nbytes


def test_bounds_by_hand():
    ops, nbytes = c.step_products(CFG["qwen3-tts-0.6b"], 1)
    assert nbytes == pytest.approx(2.873e9, rel=1e-3)  # 0.88 GB talker + 1.99 GB predictor
    assert c.bound_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)  # bytes-bound
    assert c.bound_s(1e15, 1.0) == pytest.approx(1e15 / 989e12)


def test_flash_decode_call_by_hand():
    ops, nbytes = c.flash_decode_call(CFG["qwen3-tts-0.6b"], 2, 300)
    assert ops == 4 * 2 * 16 * 128 * 300
    assert nbytes == 2 * 2 * (2 * 300 * 8 * 128 + 2 * 16 * 128)


def test_codec_and_frame_ops():
    cfg = CFG["qwen3-tts-0.6b"]
    codec = c.codec_ops_per_frame(cfg)
    # the last stage alone: 2000 samples a frame, 64 channels, three units of a
    # 7-tap and a 1-tap conv: 3 * 2 * 2000 * (7 + 1) * 64 * 64
    assert codec > 3 * 2 * 2000 * 8 * 64 * 64
    f100, f200 = c.frame_ops(cfg, 100), c.frame_ops(cfg, 200)
    assert f200 - f100 == pytest.approx(28 * 4 * 16 * 128 * 100)
    assert f100 > c.step_products(cfg, 1)[0] + codec


@pytest.mark.parametrize("name", sorted(CFG))
@pytest.mark.parametrize("B,live", [(1, 300), (16, 2000)])
def test_flash_decode_roofline_counts_every_qwen3_layer(name, B, live):
    """The reader's bound, its layers from the counts module, equals every
    talker layer's call: 28 x ``flash_decode_call`` in both configurations."""
    import devtrace
    import harness

    cfg = CFG[name]
    assert c.decode_attention_layers(cfg) == cfg["talker_config"]["num_hidden_layers"] == 28
    spent = 1e-3
    ctx = {"counts": harness.load_counts(cfg), "cfg": cfg, "devtrace": devtrace,
           "profile": {"kernels": {"flash_decode_kernel": spent}, "batch": B,
                       "pos0": live - 1, "steps": 1}}
    bound = cfg["talker_config"]["num_hidden_layers"] * c.bound_s(*c.flash_decode_call(
        cfg, B, live))
    assert harness.load_reader("flash_decode_roofline")(ctx) == 100.0 * bound / spent
