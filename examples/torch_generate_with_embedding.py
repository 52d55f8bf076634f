#!/usr/bin/env python3
"""Synthesize from a saved x-vector without reference audio, on the PyTorch
port (the port of examples/generate_with_embedding.py): direct use of the
prompt builder and the decode loop below the FasterQwen3TTS surface.

    python examples/torch_generate_with_embedding.py speaker.npz -o out.wav
    python examples/torch_generate_with_embedding.py speaker.npz --model random:tiny \\
        --device cpu

Reads the .npz of either package's extract example.  The model runs on the
CUDA card (the first generation captures the decode chunks as CUDA graphs);
with no card it refuses to load unless ``--device cpu`` is given."""
import argparse
import sys
import time

import numpy as np
import torch


def main():
    p = argparse.ArgumentParser()
    p.add_argument("embedding", help=".npz from torch_extract_speaker.py or extract_speaker.py")
    p.add_argument("--text", default="Hello from a saved speaker embedding.")
    p.add_argument("--language", default="English")
    p.add_argument("--model", default="random:qwen3-tts-0.6b")
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; without one, pass cpu)")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--max-new-tokens", type=int, default=360)
    args = p.parse_args()

    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.audio.wav import write_wav
    from qwen3tts_tpu_torch.runtime import loops

    model = FasterQwen3TTS.from_pretrained(args.model, device=args.device, dtype=args.dtype)
    xvec = np.load(args.embedding)["ref_spk_embedding"]

    input_ids = model.tokenizer.build_assistant_ids(args.text)
    spk = model.prompt_builder.project_speaker(xvec)
    embeds, trailing, tpe = loops._to_device(model.engine, *model.prompt_builder.build(
        input_ids=input_ids, spk_embedding=spk, language=args.language,
        non_streaming_mode=True,
    ))

    pol, ppol = model._policies(0.9, 50, 1.0, True, 1.05, 2)
    model._warmup(embeds.shape[1], trailing.shape[1], pol, ppol)
    t0 = time.time()
    ids, timing = loops.fast_generate(
        model.engine, embeds, trailing, tpe,
        generator=torch.Generator(model.device).manual_seed(0),
        max_new_tokens=args.max_new_tokens, policy=pol, pred_policy=ppol)
    if ids is None:
        sys.exit(f"no codec frames were generated (max_new_tokens={args.max_new_tokens}); "
                 f"nothing written to {args.output}")
    wav = model.vocoder.decode(ids)
    wall = time.time() - t0
    write_wav(args.output, wav, model.sample_rate)
    print(f"wrote {args.output}: {len(wav)/model.sample_rate:.2f}s in {wall:.2f}s "
          f"({timing['ms_per_step']:.1f} ms/step)")


if __name__ == "__main__":
    main()
