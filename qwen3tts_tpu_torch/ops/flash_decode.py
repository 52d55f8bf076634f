"""Flash-decode attention for the talker: the CUDA kernel and its plain
PyTorch version.

Port of ``qwen3tts_tpu/ops/flash_decode.py:flash_decode_stacked``: one query
token per row attends to one layer of the layer-stacked static cache
``[L, B, S, KVH, D]``, over the live slots ``[pad[b], pos]`` (and, with a
sliding window, only the last ``window`` of them).  A row with no live slot
returns exact zeros.  The cache is float (q's dtype) or int8 with f32
per-(slot, kv head) scales ``k_scale``/``v_scale`` ``[L, B, KVH, S]``
(``models/layers.py:init_kv_cache(kv_quant=True)``), dequantized as
``f32(int8) * scale``.

The kernel has two instances: head_dim 128 with two query heads per kv
head (the Qwen3 talkers) and head_dim 64 with four (the hybrid LFM2
talker's attention layers, float cache only, ``flash_decode_kernel_d64g4``).

``flash_decode`` is the one entry point.  On CUDA tensors it launches the
hand-written kernel in ``qwen3tts_tpu_torch/csrc/flash_decode.cu`` or raises;
on CPU tensors it runs ``flash_decode_plain``.  The kernel is built at first
use (``ops/cuda_build.py``).  ``flash_decode.launches`` counts launches of
the float-cache kernel, ``flash_decode.launches_int8kv`` those of the
int8-cache kernel (a call during CUDA-graph capture launches nothing and is
not counted: ``cuda_build.count_launches``).

The kernel splits each row's live range across ``num_splits`` CTAs per kv
head (split-K); ``live_range`` and ``split_range`` are the range formula it
evaluates on the device, written here once so that the CPU tests can check
the split arithmetic against the plain version and the JAX kernel.  The
splits' float32 partial states go to a workspace that the wrapper
allocates once per shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build

NEG_INF = -1e30

# the head layouts the kernel is built for, (head_dim, query heads per kv
# head): the Qwen3 talkers' (any cache) and the hybrid LFM2 talker's (float
# cache only: flash_decode_kernel_d64g4)
KERNEL_LAYOUTS = ((128, 2), (64, 4))
FLOAT_CACHE_ONLY = ((64, 4),)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
MIN_CHUNK = 32  # a split takes at least this many live slots (the kernel's kMinChunk)
MAX_SPLITS = 16  # the kernel's limit (its merge holds every split in registers)
_workspace: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def live_range(pos: int, pad: int, window: Optional[int], S: int) -> Tuple[int, int]:
    """The live slots [lo, hi] (inclusive; empty when lo > hi) of a row, as
    the kernel computes them (``csrc/flash_decode.cu:split_bounds``)."""
    lo = max(pad, pos - window + 1 if window else pad, 0)
    return lo, min(pos, S - 1)


def split_range(lo: int, hi: int, split: int, splits: int) -> Tuple[int, int]:
    """The slots [a, e] (inclusive; empty when a > e) of [lo, hi] that split
    ``split`` of ``splits`` takes, as the kernel computes them: ceil(n /
    splits) slots each but at least MIN_CHUNK, in order, the last splits
    short or empty."""
    n = hi - lo + 1
    if n <= 0:
        return 0, -1
    chunk = max(-(-n // splits), MIN_CHUNK)
    a = lo + split * chunk
    return a, min(hi, a + chunk - 1)


def num_splits(S: int, B: int, KVH: int, sm_count: int) -> int:
    """CTAs per (kv head, row): about one CTA per SM over the grid (16 at
    batch 1 on the 0.6B talker, 132 SMs), from what the host knows without
    reading ``pos``."""
    return max(1, min(sm_count // (B * KVH), -(-S // MIN_CHUNK), MAX_SPLITS))


def _workspaces(device, B: int, KVH: int, G: int, D: int, splits: int):
    """(acc [B, KVH, splits, G, D], (m, l) [B, KVH, splits, G, 2], ticket
    [B, KVH] zeros): float32 partial states and the last-CTA tickets,
    allocated once per shape.  Calls are ordered on the stream, so one set
    serves them all; every launch leaves the tickets at zero."""
    key = (device, B, KVH, G, D, splits)
    ws = _workspace.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_decode: call once at this shape before CUDA-graph "
                               "capture (its workspace's tickets must be zeroed eagerly)")
        ws = _workspace[key] = (
            torch.empty((B, KVH, splits, G, D), dtype=torch.float32, device=device),
            torch.empty((B, KVH, splits, G, 2), dtype=torch.float32, device=device),
            torch.zeros((B, KVH), dtype=torch.int32, device=device))
    return ws


def flash_decode_plain(
    q: torch.Tensor,  # [B, NH, D]
    k_stack: torch.Tensor,  # [L, B, S, KVH, D]
    v_stack: torch.Tensor,
    layer: int,
    pos: torch.Tensor,  # int32, one element
    pad: torch.Tensor,  # [B] int32
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, B, KVH, S] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked full-length softmax in float32 over every slot of ``layer``.
    Masked probabilities are zeroed and the denominator clamped, exactly as
    the kernel does, so a row with ``pad > pos`` gives zeros, not NaN.  An
    int8 cache is dequantized in float32 first."""
    _, B, S, KVH, D = k_stack.shape
    NH = q.shape[1]
    G = NH // KVH
    qg = q.reshape(B, KVH, G, D).float()
    k = k_stack[layer].permute(0, 2, 1, 3).float()  # [B, KVH, S, D]
    v = v_stack[layer].permute(0, 2, 1, 3).float()
    if k_scale is not None:
        k = k * k_scale[layer][..., None]
        v = v * v_scale[layer][..., None]
    scores = torch.matmul(qg, k.transpose(-1, -2)) * (D ** -0.5)  # [B, KVH, G, S]
    idx = torch.arange(S, device=q.device)
    p0 = pos.reshape(()).long()
    valid = (idx[None, :] <= p0) & (idx[None, :] >= pad.reshape(B, 1).long())
    if window is not None:
        valid = valid & (idx[None, :] > p0 - window)
    valid = valid[:, None, None, :]  # [B, 1, 1, S]
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~valid, 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v) / den  # [B, KVH, G, D]
    return out.reshape(B, NH, D).to(q.dtype)


def kernel_supports(head_dim: int, num_heads: int, num_kv_heads: int,
                    kv_int8: bool = False) -> bool:
    """Whether the CUDA kernel is instantiated for this head layout (and an
    int8 cache, with ``kv_int8``)."""
    if num_heads % num_kv_heads:
        return False
    layout = (head_dim, num_heads // num_kv_heads)
    return layout in KERNEL_LAYOUTS and not (kv_int8 and layout in FLOAT_CACHE_ONLY)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = cuda_build.library("flash_decode").qwen3tts_flash_decode
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_stack, v_stack, layer, pos, pad, k_scale, v_scale):
    if q.dim() != 3 or k_stack.dim() != 5 or v_stack.shape != k_stack.shape:
        raise ValueError(
            f"flash_decode wants q [B,NH,D] and k/v [L,B,S,KVH,D]; got "
            f"{tuple(q.shape)}, {tuple(k_stack.shape)}, {tuple(v_stack.shape)}")
    L, B, S, KVH, D = k_stack.shape
    if q.shape[0] != B or q.shape[2] != D or q.shape[1] % KVH:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(k_stack.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    if pos.numel() != 1 or pad.shape != (B,):
        raise ValueError(f"pos must have one element and pad shape ({B},); got "
                         f"{tuple(pos.shape)}, {tuple(pad.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is not None:
        if k_stack.dtype != torch.int8 or v_stack.dtype != torch.int8:
            raise ValueError(f"scales go with an int8 cache; got {k_stack.dtype}")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.shape != (L, B, KVH, S) or s.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 [L,B,KVH,S] = "
                                 f"{(L, B, KVH, S)}; got {s.dtype} {tuple(s.shape)}")
    elif k_stack.dtype == torch.int8:
        raise ValueError("an int8 cache needs k_scale and v_scale")


def flash_decode(
    q: torch.Tensor,  # [B, NH, D]
    k_stack: torch.Tensor,  # [L, B, S, KVH, D]
    v_stack: torch.Tensor,
    layer: int,
    pos: torch.Tensor,  # int32 device tensor, one element
    pad: torch.Tensor,  # [B] int32 device tensor
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, B, KVH, S] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention output [B, NH, D] in q's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    _check(q, k_stack, v_stack, layer, pos, pad, k_scale, v_scale)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_stack, v_stack, layer, pos, pad, window,
                                  k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu or cuda, not {q.device}")
    quant = k_scale is not None
    tensors = {"q": q, "k": k_stack, "v": v_stack, "pos": pos, "pad": pad}
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("k", "v") and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel's row loads)")
    if q.dtype not in _DTYPE_CODE or (not quant and (k_stack.dtype != q.dtype
                                                     or v_stack.dtype != q.dtype)):
        raise ValueError(f"kernel takes bfloat16 or float32 q with a cache of q's dtype "
                         f"or int8; got {q.dtype}, {k_stack.dtype}, {v_stack.dtype}")
    if pos.dtype != torch.int32 or pad.dtype != torch.int32:
        raise ValueError("pos and pad must be int32")
    L, B, S, KVH, D = k_stack.shape
    NH = q.shape[1]
    if not kernel_supports(D, NH, KVH, quant):
        raise ValueError(f"kernel has no instance for head_dim {D}, "
                         f"{NH} heads over {KVH} kv heads"
                         + (" with an int8 cache" if quant else ""))
    fn = _kernel_fn()
    splits = num_splits(S, B, KVH, cuda_build.sm_count(q.device))
    ws_acc, ws_ml, ticket = _workspaces(q.device, B, KVH, NH // KVH, D, splits)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        rc = fn(_DTYPE_CODE[q.dtype], int(quant), q.data_ptr(), k_stack.data_ptr(),
                v_stack.data_ptr(), k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None, out.data_ptr(), pos.data_ptr(),
                pad.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(), ticket.data_ptr(),
                int(layer), B, S, NH, KVH, D, int(window) if window else 0,
                float(D ** -0.5), splits, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    cuda_build.count_launches(flash_decode,
                              counter="launches_int8kv" if quant else "launches")
    return out


flash_decode.launches = 0
flash_decode.launches_int8kv = 0
