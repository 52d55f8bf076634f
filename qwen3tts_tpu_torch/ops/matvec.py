"""Weight-streaming matrix-vector products at batch 1: the CUDA kernels and
their plain PyTorch versions.

Port of the two Pallas kernels of ``benchmarks/matvec_probe.py``, which
measure how fast one chip streams weights at batch 1:

  matvec     (``pallas_mv``)     x [1, K] @ w [K, N] -> [1, N] in x's dtype,
                                 products summed in float32
  matvec_kt  (``pallas_mv_kt``)  the rows of wt [N, K] times x [1, K] ->
                                 [N, 1] float32: each product in the inputs'
                                 dtype, the row sum in float32 rounded to
                                 the inputs' dtype, as the Pallas body does

x and the weights share one dtype (bfloat16 or float32).  The TPU kernels'
``bn`` / ``bm`` tile arguments do not carry over: the CUDA kernels in
``qwen3tts_tpu_torch/csrc/matvec.cu`` choose their own tiling for the
card's 132 SMs.  ``matvec`` splits K across CTAs where its 256-column
tiles alone are too few to fill the card (``matvec_splits``); a column
tile's splits run as one thread block cluster and sum through distributed
shared memory.  On CUDA tensors the wrappers launch the kernels (built at first
use, ``ops/cuda_build.py``) or raise; on CPU tensors they run the plain
versions.  ``matvec.launches`` and ``matvec_kt.launches`` count launches
(none during CUDA-graph capture: ``cuda_build.count_launches``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
MAX_K = 8192  # longest x the matvec kernel takes
MIN_SPLIT_ROWS = 64  # a K split gives each of a CTA's 8 warps 8 rows at least
MAX_SPLITS = 16  # CTAs of one cluster (the H100's non-portable cluster size)


def matvec_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)


def matvec_kt_plain(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    return (wt * x).float().sum(dim=1, keepdim=True).to(x.dtype).float()


def matvec_tile(dtype: torch.dtype) -> int:
    """Output columns per CTA (``csrc/matvec.cu`` kTile): one 512-byte row
    segment, 16 bytes a lane."""
    return 32 * 16 // torch.empty((), dtype=dtype).element_size()


def matvec_splits(K: int, N: int, dtype: torch.dtype, sms: int) -> int:
    """CTAs along K per column tile, a power of 2: the most that keep the
    grid within two CTAs per SM (one wave at the kernel's three a SM), each
    with at least MIN_SPLIT_ROWS rows, at most MAX_SPLITS: 16 at K 1024 x N
    4096 in bf16, 1 at N 65536."""
    tiles = -(-N // matvec_tile(dtype))
    cap = min(MAX_SPLITS, K // MIN_SPLIT_ROWS)
    splits = 1
    while 2 * splits <= cap and tiles * 2 * splits <= 2 * sms:
        splits *= 2
    return splits


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = cuda_build.library("matvec")
    mv, kt = lib.qwen3tts_matvec, lib.qwen3tts_matvec_kt
    mv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    kt.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    for fn in (mv, kt):
        fn.restype = ctypes.c_int
    return mv, kt


def _check(x: torch.Tensor, w: torch.Tensor, k_axis: int, what: str):
    if x.dim() != 2 or x.shape[0] != 1 or w.dim() != 2 or w.shape[k_axis] != x.shape[1]:
        raise ValueError(f"{what}: x [1, K] and a weight with K = {x.shape[-1]} on axis "
                         f"{k_axis} wanted; got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{what} runs on cpu or cuda, with x and the weight on one device; "
                         f"got {x.device}, {w.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{what}: the kernel takes bfloat16 or float32 x and weight of one "
                         f"dtype; got {x.dtype}, {w.dtype}")
    for name, t in (("x", x), ("weight", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


def _launch(fn, what: str, x: torch.Tensor, *args):
    with torch.cuda.device(x.device):
        rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), *args,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [1, K] @ w [K, N] -> [1, N] in x's dtype (float32 sums).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    _check(x, w, 0, "matvec")
    if x.device.type == "cpu":
        return matvec_plain(x, w)
    K, N = w.shape
    if not (K <= MAX_K and N % 8 == 0):
        raise ValueError(f"matvec: no kernel instance for K {K}, N {N} "
                         f"(needs K <= {MAX_K}, N % 8 == 0)")
    splits = matvec_splits(K, N, x.dtype, cuda_build.sm_count(x.device))
    out = torch.empty((1, N), dtype=x.dtype, device=x.device)
    _launch(_kernel_fns()[0], "matvec", x, w.data_ptr(), out.data_ptr(), K, N, splits)
    cuda_build.count_launches(matvec)
    return out


def matvec_kt(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """sum(wt [N, K] * x [1, K], axis 1) -> [N, 1] float32, each product in
    the inputs' dtype and the sum rounded to it.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    _check(x, wt, 1, "matvec_kt")
    if x.device.type == "cpu":
        return matvec_kt_plain(x, wt)
    N, K = wt.shape
    if K % (16 // x.element_size()):
        raise ValueError(f"matvec_kt: no kernel instance for K {K} (needs whole 16-byte "
                         f"rows)")
    out = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    _launch(_kernel_fns()[1], "matvec_kt", x, wt.data_ptr(), out.data_ptr(), K, N)
    cuda_build.count_launches(matvec_kt)
    return out


matvec.launches = 0
matvec_kt.launches = 0
