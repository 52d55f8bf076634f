"""Int8 x int8 products for the w8a8 modes: the CUDA kernels and their plain
PyTorch versions.

Port of ``qwen3tts_tpu/ops/quant.py:quantize_act`` and ``w8a8_matmul``
(an int8 x int8 -> int32 dot in XLA, no Pallas kernel).  A w8a8 weight is
``{"q8": int8 [in, out], "scale": f32 [1, out]}`` (``ops/quant.py``):

  quantize_act(x)     x [..., K] -> (xq int8 [..., K], xs f32 [..., 1]):
                      xs = max(max |f32(x)|, 1e-8) / 127 per row,
                      xq = clamp(round(f32(x) / xs), -127, 127)
  w8a8_matmul(x, qw)  x's dtype((f32(xq @ q8) * xs) * scale), the int8
                      products summed exactly

Every step is exact or rounds once, in the JAX order, so the plain
versions give the JAX package's bits and the kernels the plain versions'
(tolerance 0 both ways): the division is IEEE (a Python-number divisor
would be a reciprocal multiply on the card, so the plain version divides by
a tensor), rounding is half to even, and |sum| <= 127^2 K < 2^31 is an
integer that float64 (the plain version) and int32 (the kernels) both hold
exactly.

Routing (``w8a8_matmul``):
  - CPU tensors take the plain versions;
  - CUDA tensors with M <= 16 rows (every decode-time product: the talker
    step, the predictor's micro-steps, its 2-token prefill at B <= 8)
    launch ``quantize_act``'s kernel, then ``w8a8_gemv``'s
    (``csrc/w8a8.cu``);
  - CUDA tensors with M > 16 rows (the talker's prefill, a batched 2-token
    predictor prefill) launch ``quantize_act``'s kernel, then
    ``torch._int_mm`` (cuBLASLt: M > 16, K % 8 == 0, N % 8 == 0, and, on
    the row-major weight, K >= 128: on the H100 with torch 2.11 it refused
    K 32, 64 and 96, ``tools/kernel_probe.py intmm``), then the same
    epilogue: the JAX package leaves this product to XLA;
  - any other shape raises ValueError.  No CUDA tensor takes a plain
    version.

The wrappers read nothing from the host and allocate only their outputs,
so they capture into CUDA graphs.  ``quantize_act.launches`` and
``w8a8_gemv.launches`` count kernel launches (none during capture:
``cuda_build.count_launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from . import cuda_build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
MAX_ROWS = 16  # rows of the GEMV kernel; above, torch._int_mm
MAX_SPLITS = 16  # K splits: CTAs of one cluster (the H100's non-portable cluster size)
MIN_SPLIT_ROWS = 64  # a K split gives each of a CTA's 8 warps 8 rows at least
MIN_INT_MM_K = 128  # the least K torch._int_mm takes with a row-major int8 weight


def quantize_act_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: the card turns a Python-number divisor into a
    # reciprocal multiply, which is not the IEEE division JAX and the kernel do
    xs = amax.clamp_min(1e-8) / amax.new_full((), 127.0)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def w8a8_matmul_plain(xq: torch.Tensor, xs: torch.Tensor, q8: torch.Tensor,
                      scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``dtype((f32(xq @ q8) * xs) * scale)``, the products summed in
    float64: exact, on the CPU and on the card."""
    acc = torch.matmul(xq.double(), q8.double())
    return ((acc.float() * xs) * scale.float()).to(dtype)


def gemv_geometry(M: int, K: int, N: int, sms: int) -> Tuple[int, int, int]:
    """(mt, vec, splits) of ``csrc/w8a8.cu``'s GEMV: ``mt`` is M rounded up
    to a power of 2; a lane reads ``vec`` bytes of a row (16, 8 or 4, with
    mt x vec int32 sums of its own), the widest that divides N and still
    gives at least ``sms`` CTAs at 16 splits; ``splits`` is the most K splits,
    a power of 2, that keep the grid within two CTAs per SM, each split at
    least MIN_SPLIT_ROWS rows.  B 1 on 132 SMs: N 4096 -> vec 8 x 16
    splits, N 1024 -> vec 4 x 16; M 16, N 4096 -> vec 4 x 8."""
    mt = 1
    while mt < M:
        mt *= 2
    vec = min(16, 64 // mt)
    while vec > 4 and (N % vec or -(-N // (32 * vec)) * MAX_SPLITS < sms):
        vec //= 2
    tiles = -(-N // (32 * vec))
    cap = min(MAX_SPLITS, max(1, K // MIN_SPLIT_ROWS))
    splits = 1
    while 2 * splits <= cap and tiles * 2 * splits <= 2 * sms:
        splits *= 2
    return mt, vec, splits


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = cuda_build.library("w8a8")
    qa, mv = lib.qwen3tts_quantize_act, lib.qwen3tts_w8a8_gemv
    qa.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    mv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    for fn in (qa, mv):
        fn.restype = ctypes.c_int
    return qa, mv


def _on_card(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} runs on cpu or cuda, with every tensor on one device; got "
                         f"{[str(t.device) for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: every tensor must be contiguous and 16-byte aligned; "
                             f"got {tuple(t.shape)} {t.dtype} strides {t.stride()}")


def _launch(fn, what: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] bf16 or f32 -> (xq int8 [..., K], xs f32 [..., 1]).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (one CTA
    a row) or raise."""
    if x.device.type == "cpu":
        return quantize_act_plain(x)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"quantize_act: the kernel takes bfloat16 or float32; got {x.dtype}")
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    _on_card("quantize_act", x2)
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    _launch(_kernel_fns()[0], "quantize_act", x.device, _DTYPE_CODE[x.dtype], x2.data_ptr(),
            xq.data_ptr(), xs.data_ptr(), M, K)
    cuda_build.count_launches(quantize_act)
    return xq.reshape(x.shape), xs.reshape(*x.shape[:-1], 1)


def w8a8_gemv(xq: torch.Tensor, xs: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """xq int8 [M, K] (M <= 16), xs f32 [M, 1], q8 int8 [K, N], scale f32
    [1, N] -> ``dtype((f32(xq @ q8) * xs) * scale)`` [M, N].  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    M, K = xq.shape
    N = q8.shape[-1]
    if q8.shape != (K, N) or xs.shape != (M, 1) or scale.numel() != N:
        raise ValueError(f"w8a8_gemv: xq [M, K], xs [M, 1], q8 [K, N], scale [1, N] wanted; got "
                         f"{tuple(xq.shape)}, {tuple(xs.shape)}, {tuple(q8.shape)}, "
                         f"{tuple(scale.shape)}")
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, xs, q8, scale, dtype)
    _on_card("w8a8_gemv", xq, xs, q8, scale)
    if (xq.dtype, q8.dtype, xs.dtype, scale.dtype) != (torch.int8, torch.int8, torch.float32,
                                                       torch.float32):
        raise ValueError(f"w8a8_gemv: int8 xq and q8, float32 xs and scale wanted; got "
                         f"{xq.dtype}, {q8.dtype}, {xs.dtype}, {scale.dtype}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"w8a8_gemv: the kernel writes bfloat16 or float32; got {dtype}")
    if not 1 <= M <= MAX_ROWS or N % 4:
        raise ValueError(f"w8a8_gemv: no kernel instance for M {M}, N {N} "
                         f"(needs 1 <= M <= {MAX_ROWS}, N % 4 == 0)")
    mt, vec, splits = gemv_geometry(M, K, N, cuda_build.sm_count(xq.device))
    out = torch.empty((M, N), dtype=dtype, device=xq.device)
    _launch(_kernel_fns()[1], "w8a8_gemv", xq.device, _DTYPE_CODE[dtype], xq.data_ptr(),
            xs.data_ptr(), q8.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, mt, vec,
            splits)
    cuda_build.count_launches(w8a8_gemv)
    return out


def w8a8_matmul(x: torch.Tensor, qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [..., K] @ a w8a8 weight {"q8" [K, N], "scale" [1, N]} -> [..., N]
    in x's dtype: x quantized per row, the int8 products summed exactly,
    rescaled per row and column.  Routed as the module docstring says."""
    q8, scale = qw["q8"], qw["scale"]
    K, N = q8.shape
    if x.shape[-1] != K:
        raise ValueError(f"w8a8_matmul: x [..., {K}] wanted; got {tuple(x.shape)}")
    if x.device.type == "cpu":
        xq, xs = quantize_act_plain(x)
        return w8a8_matmul_plain(xq, xs, q8, scale, x.dtype)
    xq, xs = quantize_act(x.reshape(-1, K).contiguous())
    M = xq.shape[0]
    if M <= MAX_ROWS:
        y = w8a8_gemv(xq, xs, q8, scale, x.dtype)
    elif K >= MIN_INT_MM_K and K % 8 == 0 and N % 8 == 0:
        acc = torch._int_mm(xq, q8)  # int32 [M, N], the same exact sums
        y = ((acc.float() * xs) * scale.reshape(1, N)).to(x.dtype)
    else:
        raise ValueError(f"w8a8_matmul: no route on the card for M {M}, K {K}, N {N}: "
                         f"M <= {MAX_ROWS} takes the GEMV kernel, M > {MAX_ROWS} "
                         f"torch._int_mm, which needs K >= {MIN_INT_MM_K}, K % 8 == 0 and "
                         "N % 8 == 0")
    return y.reshape(*x.shape[:-1], N)


quantize_act.launches = 0
w8a8_gemv.launches = 0
