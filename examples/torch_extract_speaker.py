#!/usr/bin/env python3
"""One-time x-vector extraction → .npz, on the PyTorch port (the port of
examples/extract_speaker.py: same arguments, same file, same printed line).

    python examples/torch_extract_speaker.py ref.wav -o speaker.npz
    python examples/torch_extract_speaker.py ref.wav --model random:tiny --device cpu

The model runs on the CUDA card; with no card it refuses to load unless
``--device cpu`` is given.  The .npz holds one float32 vector under
``ref_spk_embedding``, as the JAX example's does: either package's
generate example reads it."""
import argparse

import numpy as np


def main():
    p = argparse.ArgumentParser(description="Extract a speaker x-vector")
    p.add_argument("ref_audio", help="reference WAV")
    p.add_argument("-o", "--output", default="speaker.npz")
    p.add_argument("--model", default="random:qwen3-tts-0.6b")
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; without one, pass cpu)")
    args = p.parse_args()

    from qwen3tts_tpu_torch import FasterQwen3TTS

    model = FasterQwen3TTS.from_pretrained(args.model, device=args.device, dtype=args.dtype)
    emb = model.extract_speaker_embedding(args.ref_audio)
    np.savez(args.output, ref_spk_embedding=emb)
    print(f"saved {emb.shape} x-vector ({emb.nbytes} bytes) -> {args.output}")


if __name__ == "__main__":
    main()
