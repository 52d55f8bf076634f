"""Command-line interface of the PyTorch port: clone / custom / design /
serve / export-fixture / check-fixture / check-checkpoint.

Port of ``qwen3tts_tpu/apps/cli.py``, with its subcommands, options and
defaults (--chunk-size 8, --max-new-tokens 2048, --temperature 0.9,
--top-k 50, --repetition-penalty 1.05, --greedy, --xvec-only,
--non-streaming-mode on, ``serve`` = a stdin REPL with the model kept hot).
``--device`` picks where the model runs: the card by default; with no card
and no ``--device`` the model refuses to load (``--device cpu`` runs on the
CPU).

    qwen3tts-tpu-torch clone --model <checkpoint dir or random:<preset>> \\
        --ref-audio ref.wav --text "Hello." -o out.wav
    python -m qwen3tts_tpu_torch.apps.cli check-checkpoint <torch-layout dir>
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

import numpy as np

from ..ops.quant import MODES as QUANT_MODES

logger = logging.getLogger("qwen3tts_tpu_torch.cli")


def _load_model(args):
    from ..api.model import FasterQwen3TTS

    t0 = time.time()
    model = FasterQwen3TTS.from_pretrained(
        args.model, device=args.device, dtype=args.dtype, max_seq_len=args.max_seq_len,
        seed=args.seed, quantize=getattr(args, "quantize", None),
        kv_quant=getattr(args, "kv_quant", False),
    )
    print(f"Model loaded in {time.time()-t0:.1f}s", file=sys.stderr)
    return model


def _parse_first_chunks(args):
    raw = getattr(args, "first_chunks", "") or ""
    return tuple(int(x) for x in raw.split(",") if x.strip())


def _gen_kwargs(args):
    return dict(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_k=args.top_k,
        repetition_penalty=args.repetition_penalty,
        do_sample=not args.greedy,
    )


def _write_and_report(audio: np.ndarray, sr: int, out: str, wall: float):
    from ..audio.wav import write_wav

    write_wav(out, audio, sr)
    dur = len(audio) / sr
    rtf = dur / wall if wall > 0 else 0.0
    print(f"Wrote {out}: {dur:.2f}s audio in {wall:.2f}s (RTF {rtf:.2f})")


def _run_streaming(gen, out):
    from ..audio.wav import write_wav

    t0 = time.time()
    parts = []
    ttfa = None
    sr = 24_000
    for audio, sr, _timing in gen:
        if ttfa is None:
            ttfa = time.time() - t0
            print(f"TTFA: {ttfa*1000:.0f}ms", file=sys.stderr)
        parts.append(audio)
    wall = time.time() - t0
    full = np.concatenate(parts) if parts else np.zeros(1, np.float32)
    write_wav(out, full, sr)
    dur = len(full) / sr
    print(f"Wrote {out}: {dur:.2f}s audio in {wall:.2f}s "
          f"(TTFA {ttfa*1000:.0f}ms, RTF {dur/wall:.2f})" if ttfa else f"Wrote {out}")


def cmd_clone(args):
    model = _load_model(args)
    kw = dict(
        text=args.text, language=args.language, ref_audio=args.ref_audio,
        ref_text=args.ref_text, xvec_only=args.xvec_only,
        non_streaming_mode=args.non_streaming_mode, instruct=args.instruct,
        **_gen_kwargs(args),
    )
    if args.streaming:
        _run_streaming(
            model.generate_voice_clone_streaming(
                **kw, chunk_size=args.chunk_size, first_chunks=_parse_first_chunks(args)),
            args.output,
        )
    else:
        t0 = time.time()
        audio_list, sr = model.generate_voice_clone(**kw)
        _write_and_report(audio_list[0], sr, args.output, time.time() - t0)


def cmd_custom(args):
    model = _load_model(args)
    if args.list_speakers:
        for name in sorted(model.cfg.talker.spk_id):
            print(name)
        return
    kw = dict(text=args.text, speaker=args.speaker, language=args.language,
              instruct=args.instruct, **_gen_kwargs(args))
    if args.streaming:
        _run_streaming(
            model.generate_custom_voice_streaming(**kw, chunk_size=args.chunk_size),
            args.output,
        )
    else:
        t0 = time.time()
        audio_list, sr = model.generate_custom_voice(**kw)
        _write_and_report(audio_list[0], sr, args.output, time.time() - t0)


def cmd_design(args):
    model = _load_model(args)
    kw = dict(text=args.text, instruct=args.instruct, language=args.language,
              **_gen_kwargs(args))
    if args.streaming:
        _run_streaming(
            model.generate_voice_design_streaming(**kw, chunk_size=args.chunk_size),
            args.output,
        )
    else:
        t0 = time.time()
        audio_list, sr = model.generate_voice_design(**kw)
        _write_and_report(audio_list[0], sr, args.output, time.time() - t0)


def cmd_serve(args):
    """stdin REPL with the model kept hot."""
    model = _load_model(args)
    if getattr(args, "warmup_all", False):
        print("Capturing every trailing-text bucket's chunk graphs (one-time)...",
              file=sys.stderr)
        model.warmup_all(chunk_sizes=(args.chunk_size, 16))
    mode = args.mode
    if mode == "clone" and not args.ref_audio:
        print("serve --mode clone requires --ref-audio", file=sys.stderr)
        sys.exit(2)
    if mode == "custom" and not args.speaker:
        print("serve --mode custom requires --speaker", file=sys.stderr)
        sys.exit(2)
    if mode == "design" and not args.instruct:
        print("serve --mode design requires --instruct", file=sys.stderr)
        sys.exit(2)

    print(f"Serving in {mode} mode. Type text, or 'exit'/'quit'/'stop' to end.",
          file=sys.stderr)
    idx = 0
    for line in sys.stdin:
        text = line.strip()
        if not text:
            continue
        if text.lower() in ("exit", "quit", "stop"):
            break
        out = str(Path(args.output_dir) / f"out_{idx:04d}.wav")
        t0 = time.time()
        try:
            if mode == "clone":
                # clone serve forces full ICL for best quality
                audio_list, sr = model.generate_voice_clone(
                    text=text, language=args.language, ref_audio=args.ref_audio,
                    ref_text=args.ref_text, xvec_only=False,
                    non_streaming_mode=args.non_streaming_mode,
                    **_gen_kwargs(args),
                )
            elif mode == "custom":
                audio_list, sr = model.generate_custom_voice(
                    text=text, speaker=args.speaker, language=args.language,
                    instruct=args.instruct, **_gen_kwargs(args),
                )
            else:
                audio_list, sr = model.generate_voice_design(
                    text=text, instruct=args.instruct, language=args.language,
                    **_gen_kwargs(args),
                )
        except Exception as e:  # keep the REPL alive
            print(f"error: {e}", file=sys.stderr)
            continue
        _write_and_report(audio_list[0], sr, out, time.time() - t0)
        idx += 1


def cmd_export_fixture(args):
    from ..core.fixtures import export_model_fixture

    model = _load_model(args)
    meta = export_model_fixture(
        model, args.output, text=args.text, speaker=args.speaker,
        seed=args.fixture_seed, max_new_tokens=min(args.max_new_tokens, 256))
    print(f"Wrote {args.output}: {meta}")


def cmd_check_fixture(args):
    from ..core.fixtures import check_model_fixture

    model = _load_model(args)
    failed = 0
    for fx in args.fixtures:
        try:
            check_model_fixture(model, fx)
            print(f"PASS {fx}")
        except AssertionError as e:
            failed += 1
            print(f"FAIL {fx}: {e}")
    sys.exit(1 if failed else 0)


def cmd_check_checkpoint(args):
    """Dry-run the torch-layout conversion and print the full diagnostic
    report (RUNBOOK.md step 2); exit 1 on any problem."""
    from ..core.loader import diagnose_torch_checkpoint

    report = diagnose_torch_checkpoint(args.checkpoint)
    print(report.summary(limit=args.limit))
    sys.exit(0 if report.ok else 1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen3tts-tpu-torch",
        description="Real-time Qwen3-TTS on PyTorch and CUDA (faster-qwen3-tts capabilities)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--model", default="random:qwen3-tts-0.6b",
                        help="checkpoint dir or random:<preset>")
        sp.add_argument("--device", default=None,
                        help="torch device for the model (default: the CUDA card; "
                        "'cpu' runs the kernels' plain versions on the CPU)")
        sp.add_argument("--dtype", default="bf16", choices=["bf16", "fp16", "fp32",
                                                            "bfloat16", "float16", "float32"])
        sp.add_argument("--max-seq-len", type=int, default=2048)
        sp.add_argument("--quantize", default=None, choices=sorted(QUANT_MODES),
                        help="int8 decode weights: int8 (weight-only) or w8a8 "
                        "(int8 activations too); -predictor/-talker suffixes "
                        "quantize one component")
        sp.add_argument("--kv-quant", action="store_true",
                        help="int8 KV cache (halves KV memory)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--language", default="English")
        sp.add_argument("--streaming", action="store_true")
        sp.add_argument("--chunk-size", type=int, default=8)
        sp.add_argument("--first-chunks", default="",
                        help="comma-separated ramp-up chunk sizes, e.g. 2,4")
        sp.add_argument("--max-new-tokens", type=int, default=2048)
        sp.add_argument("--temperature", type=float, default=0.9)
        sp.add_argument("--top-k", type=int, default=50)
        sp.add_argument("--repetition-penalty", type=float, default=1.05)
        sp.add_argument("--greedy", action="store_true")
        sp.add_argument("--output", "-o", default="out.wav")

    c = sub.add_parser("clone", help="voice clone from reference audio")
    common(c)
    c.add_argument("--text", required=True)
    c.add_argument("--ref-audio", required=True)
    c.add_argument("--ref-text", default="")
    c.add_argument("--xvec-only", action=argparse.BooleanOptionalAction, default=True)
    c.add_argument("--non-streaming-mode", action=argparse.BooleanOptionalAction,
                   default=True)
    c.add_argument("--instruct", default=None)
    c.set_defaults(fn=cmd_clone)

    cu = sub.add_parser("custom", help="predefined speaker")
    common(cu)
    cu.add_argument("--text")
    cu.add_argument("--speaker")
    cu.add_argument("--instruct", default=None)
    cu.add_argument("--list-speakers", action="store_true")
    cu.set_defaults(fn=cmd_custom)

    d = sub.add_parser("design", help="instruction-based voice design")
    common(d)
    d.add_argument("--text", required=True)
    d.add_argument("--instruct", required=True)
    d.set_defaults(fn=cmd_design)

    s = sub.add_parser("serve", help="stdin REPL, model kept hot")
    common(s)
    s.add_argument("--mode", default="clone", choices=["clone", "custom", "design"])
    s.add_argument("--ref-audio", default=None)
    s.add_argument("--ref-text", default="")
    s.add_argument("--speaker", default=None)
    s.add_argument("--instruct", default=None)
    s.add_argument("--warmup-all", action="store_true",
                   help="capture every trailing-text bucket's chunk graphs before serving")
    s.add_argument("--non-streaming-mode", action=argparse.BooleanOptionalAction,
                   default=True)
    s.add_argument("--output-dir", default=".")
    s.set_defaults(fn=cmd_serve)

    # golden parity fixtures (core/fixtures.py)
    fx = sub.add_parser("export-fixture",
                        help="export a golden parity fixture (.npz) from this model")
    common(fx)
    fx.add_argument("--text", required=True)
    fx.add_argument("--fixture-seed", type=int, default=1337)
    fx.add_argument("--speaker", default=None, help="CustomVoice speaker (else plain)")
    fx.set_defaults(fn=cmd_export_fixture)

    cf = sub.add_parser("check-fixture",
                        help="replay golden fixtures against this model (exact parity)")
    common(cf)
    cf.add_argument("fixtures", nargs="+")
    cf.set_defaults(fn=cmd_check_fixture)

    cc = sub.add_parser(
        "check-checkpoint",
        help="diagnose an upstream torch-layout checkpoint dir: report "
             "unmatched/missing/mis-shaped tensors without loading the model")
    cc.add_argument("checkpoint")
    cc.add_argument("--limit", type=int, default=30,
                    help="max names listed per report section")
    cc.set_defaults(fn=cmd_check_checkpoint)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.cmd == "custom" and not args.list_speakers:
        if not args.text or not args.speaker:
            build_parser().error("custom requires --text and --speaker "
                                 "(or --list-speakers)")
    args.fn(args)


if __name__ == "__main__":
    main()
