"""qwen3tts_tpu_torch — the PyTorch / CUDA port of qwen3tts_tpu.

Runs the 0.6B x-vector voice-clone path on one NVIDIA H100 (or, with the
kernels' plain versions, on the CPU).  The talker's decode attention is the
hand-written CUDA kernel in ``csrc/flash_decode.cu``.  The JAX package
``qwen3tts_tpu`` stays the reference; this package imports neither it nor
JAX.
"""

from .api.model import FasterQwen3TTS

__version__ = "0.1.0"
__all__ = ["FasterQwen3TTS", "__version__"]
