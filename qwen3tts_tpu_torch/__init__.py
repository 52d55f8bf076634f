"""qwen3tts_tpu_torch — the PyTorch / CUDA port of qwen3tts_tpu.

Does what the JAX package does, on one NVIDIA H100 or several (or, with
the kernels' plain versions, on the CPU): x-vector and in-context voice
clone, custom voices and voice design, streaming, long form and batched
generation, int8 and w8a8 weights and an int8 KV cache, checkpoints in both
layouts, the command line (``apps/cli.py``), the OpenAI-compatible server
(``apps/openai_server.py``), the web demo with its CTC recognizer
(``apps/demo_server.py``), tensor-parallel serving and training
(``parallel/``) and the ASR self-training tool (``tools/train_asr.py``).
The decode chunks replay as CUDA graphs.  The kernels are hand-written CUDA
C++ in ``csrc/`` (flash-decode, the fused talker blocks, the predictor's
micro-step, the matvecs, the w8a8 GEMV and the graphs' condition), built
with nvcc at first use (``ops/cuda_build.py``).  The JAX package
``qwen3tts_tpu`` stays the reference; this package imports neither it nor
JAX.
"""

from .api.model import FasterQwen3TTS

__version__ = "0.1.0"
__all__ = ["FasterQwen3TTS", "__version__"]
