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
    launch one kernel, ``w8a8_gemv``'s (``csrc/w8a8.cu``), which quantizes
    the rows and multiplies them in one launch;
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
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import cuda_build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
MAX_ROWS = 16  # rows of the GEMV kernel; above, torch._int_mm
MAX_SPLITS = 16  # K splits: CTAs of one cluster (the H100's non-portable cluster size)
MIN_SPLIT_ROWS = 64  # a K split has 64 rows at least
TILE = 128  # columns of a CTA (csrc/w8a8.cu kTile: 4 column blocks of 32)
STEP = 32  # K rows of one dot step (the mma's k): a split's rows are a multiple
STAGE_ROWS = 256  # K rows of a ring stage at most: one TMA box (32 KB of a 128-column tile)
MAX_STAGE_ROWS = 256  # a TMA box has at most 256 rows
RING_BYTES = 64 * 1024  # the ring of stages in shared memory, at most
SLICE_BYTES = 64 * 1024  # a split's slice of x and its packed words, at most
CTA_SMEM_BYTES = 110 * 1024  # shared memory a CTA, at most, so that two fit an SM
MMA_FROM_ROWS = 3  # mma.sync from this many rows on; __dp4a below
WHOLE_ROW_BYTES = 16 * 1024  # x this small: each CTA takes the rows' |max| over all of K itself
MIN_INT_MM_K = 128  # the least K torch._int_mm takes with a row-major int8 weight


class GemvGeometry(NamedTuple):
    """A launch of ``csrc/w8a8.cu``'s fused GEMV: ``mt`` rows of the dot,
    ``mma`` (mma.sync, or __dp4a), ``splits`` CTAs a column tile of
    ``kc`` K rows each, a ring of ``ring`` stages of ``stage_rows`` rows;
    ``whole``: each CTA takes the rows' |max| over all of K (no exchange
    over the cluster)."""
    mt: int
    mma: bool
    splits: int
    kc: int
    stage_rows: int
    ring: int
    whole: bool


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


def w8a8_gemv_plain(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The fused kernel's function: ``quantize_act_plain``, then
    ``w8a8_matmul_plain``."""
    xq, xs = quantize_act_plain(x)
    return w8a8_matmul_plain(xq, xs, q8, scale, dtype)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def gemv_smem_bytes(mt: int, M: int, elt: int, kc: int, stage_rows: int, ring: int,
                    splits: int) -> int:
    """Dynamic shared memory of a CTA of the fused GEMV (csrc/w8a8.cu
    make_layout): the ring, x's slice, the scales, the packed words, the
    two halves' sums, the cluster fold's inbox, the row maxima and the
    barriers."""
    a16 = lambda b: -(-b // 16) * 16  # noqa: E731
    kwp = -(-(kc // 4) // 32) * 32 + 4
    upo = -(-(TILE // 8) // splits)
    return (ring * stage_rows * TILE + a16(M * kc * elt) + TILE * 4 + a16(mt * kwp * 4)
            + 2 * mt * TILE * 4 + a16(splits * mt * upo * 8 * 4) + MAX_SPLITS * MAX_ROWS * 4
            + 2 * MAX_ROWS * 4 + 8 * MAX_ROWS * 4 + ring * 8)


def gemv_geometry(M: int, K: int, N: int, sms: int, elt: int = 2, mma: Optional[bool] = None,
                  ctas: Optional[int] = None, stage_rows: int = STAGE_ROWS,
                  ring_bytes: int = RING_BYTES,
                  whole: Optional[bool] = None) -> Optional[GemvGeometry]:
    """The fused GEMV's launch for x [M, K] of ``elt``-byte elements and an
    int8 [K, N] weight on ``sms`` SMs, or None where no launch fits (a K
    too long for 16 splits' shared memory).  Column tiles of TILE columns;
    K split so that the grid has at most ``ctas`` CTAs (default: one an SM),
    each split at least MIN_SPLIT_ROWS rows (or all of K), and so that a
    split's slice of x and its packed int8 words fit SLICE_BYTES; split
    rows a multiple of STEP.  A stage is one TMA box of up to
    ``stage_rows`` (at most the split's) rows; the ring holds the split's
    whole share where ``ring_bytes`` allow (every decode shape of the
    0.6B), so all of it is in flight from the kernel's entry, unless a grid
    of more than 3/4 of a CTA an SM would then need more than
    CTA_SMEM_BYTES a CTA.  ``mma`` (mma.sync at 8 or 16
    rows, else __dp4a at M rounded up to a power of 2) from MMA_FROM_ROWS
    rows on unless given; ``whole`` where K is split and x is at most
    WHOLE_ROW_BYTES, unless given.  On 132 SMs: N 4096 -> 32 tiles x 4 splits of
    256 rows (K 1024); N 1024 -> 8 x 16; N 6144 -> 48 x 2."""
    if mma is None:
        mma = M >= MMA_FROM_ROWS
    mt = max(8, _pow2(M)) if mma else _pow2(M)
    tiles = -(-N // TILE)
    splits = max(1, min(MAX_SPLITS, (ctas or sms) // tiles, K // MIN_SPLIT_ROWS))
    splits = max(splits, -(-K * (M * elt + mt) // SLICE_BYTES))
    if splits > MAX_SPLITS:
        return None
    kc = -(-(-(-K // splits)) // STEP) * STEP
    splits = -(-K // kc)  # no split left empty
    stage_rows = min(stage_rows, kc, MAX_STAGE_ROWS)
    stages = -(-min(kc, K) // stage_rows)
    ring = max(1, min(stages, ring_bytes // (stage_rows * TILE)))
    # a grid near one CTA an SM needs room for two, or its clusters do not
    # all fit the SMs at once (a second wave: twice the time)
    while (ring > 1 and 4 * tiles * splits > 3 * sms
           and gemv_smem_bytes(mt, M, elt, kc, stage_rows, ring, splits) > CTA_SMEM_BYTES):
        ring -= 1
    if whole is None:
        whole = splits > 1 and M * K * elt <= WHOLE_ROW_BYTES
    return GemvGeometry(mt, mma, splits, kc, stage_rows, ring, whole)


@functools.lru_cache(maxsize=None)
def bind(lib: ctypes.CDLL):
    """(quantize_act, w8a8_gemv) of a built library."""
    qa, mv = lib.qwen3tts_quantize_act, lib.qwen3tts_w8a8_gemv
    qa.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    mv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    for fn in (qa, mv):
        fn.restype = ctypes.c_int
    return qa, mv


def _kernel_fns():
    return bind(cuda_build.library("w8a8"))


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


def w8a8_gemv(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
              geometry: Optional[GemvGeometry] = None) -> torch.Tensor:
    """x [M, K] bf16 or f32 (M <= 16), q8 int8 [K, N], scale f32 [1, N] ->
    ``dtype((f32(xq @ q8) * xs) * scale)`` [M, N], x quantized per row as
    ``quantize_act`` does.  CPU tensors take the plain version; CUDA tensors
    launch the fused kernel (quantize and product in one launch; out in x's
    dtype, K % 8 == 0, N % 16 == 0) or raise.  ``geometry`` overrides
    ``gemv_geometry``'s launch (``tools/kernel_probe.py`` compares them)."""
    if x.dim() != 2 or q8.dim() != 2:
        raise ValueError(f"w8a8_gemv: x [M, K], q8 [K, N] wanted; got {tuple(x.shape)}, "
                         f"{tuple(q8.shape)}")
    M, K = x.shape
    N = q8.shape[-1]
    if q8.shape != (K, N) or scale.numel() != N:
        raise ValueError(f"w8a8_gemv: x [M, K], q8 [K, N], scale [1, N] wanted; got "
                         f"{tuple(x.shape)}, {tuple(q8.shape)}, {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return w8a8_gemv_plain(x, q8, scale, dtype)
    _on_card("w8a8_gemv", x, q8, scale)
    if x.dtype not in _DTYPE_CODE or dtype != x.dtype:
        raise ValueError(f"w8a8_gemv: the kernel takes bfloat16 or float32 x and writes x's "
                         f"dtype; got x {x.dtype}, out {dtype}")
    if (q8.dtype, scale.dtype) != (torch.int8, torch.float32):
        raise ValueError(f"w8a8_gemv: int8 q8 and float32 scale wanted; got {q8.dtype}, "
                         f"{scale.dtype}")
    geo = geometry or (gemv_geometry(M, K, N, cuda_build.sm_count(x.device), x.element_size())
                       if 1 <= M <= MAX_ROWS and K % 8 == 0 and N % 16 == 0 else None)
    if geo is None:
        raise ValueError(f"w8a8_gemv: no kernel instance for M {M}, K {K}, N {N} (needs "
                         f"1 <= M <= {MAX_ROWS}, K % 8 == 0, N % 16 == 0, and a K that "
                         f"{MAX_SPLITS} splits' shared memory holds)")
    out = torch.empty((M, N), dtype=dtype, device=x.device)
    _launch(_kernel_fns()[1], "w8a8_gemv", x.device, _DTYPE_CODE[dtype], x.data_ptr(),
            q8.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, geo.mt, int(geo.mma),
            geo.splits, geo.kc, geo.stage_rows, geo.ring, int(geo.whole))
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
        return w8a8_gemv_plain(x, q8, scale, x.dtype)
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if M <= MAX_ROWS:
        y = w8a8_gemv(x2, q8, scale, x.dtype)
    elif K >= MIN_INT_MM_K and K % 8 == 0 and N % 8 == 0:
        xq, xs = quantize_act(x2)
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
