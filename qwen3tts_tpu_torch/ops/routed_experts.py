"""The hybrid talker's routed experts: the CUDA decode kernel and its plain
PyTorch version.

One layer's routed FFN on the normalised hidden ``h`` [N, H], added to the
residual ``x`` [N, H] (``models/lfm2.py``; LFM2's equations):

    s   = sigmoid(h @ router)                     router [H, E], in float32
    idx = top_k(s + expert_bias)                  the bias only chooses
    g   = s[idx] / (sum s[idx] + 1e-6) * scale    (norm_topk_prob; else s[idx] * scale)
    out = x + sum_k g_k down_k(silu(gate_k h) * up_k h)

with ``w13`` [E, H, 2I] (gate columns, then up) and ``w2`` [E, I, H].

``routed_experts`` is the one entry point.  On CPU tensors, and for the
prefill on any device (``decode=False``), it runs ``routed_experts_plain``:
an expert at a time over the rows routed to it (one host read of the
counts).  On CUDA tensors a decode call (1 to 16 rows, bfloat16) launches
the kernel of ``csrc/routed_experts.cu``, three launches on fixed grids
that route on the device and read no untouched expert's weights, so that a
captured step replays it; other shapes raise there.  Both compute alike:
the router in float32, each expert's gate and up in float32, the activation
``g * silu(gate) * up`` rounded to x's dtype, the down products in float32,
x plus the row's experts in expert order rounded once.

``stats`` (``RouteStats.layer(i)``, int64 [E + 2]) takes each decode call's
rows per expert, experts touched and one call; the kernel adds them on the
device (graph-safe), the plain version with tensor ops.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

MAX_ROWS = 16
MAX_EXPERTS = 32
MAX_TOP_K = 8
_workspace: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def route(h: torch.Tensor, router: torch.Tensor, bias: Optional[torch.Tensor], top_k: int,
          norm: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts [N, k] in expert order, weights g [N, k] float32): the
    sigmoid scores in float32, the top k of scores plus bias, g from the
    scores alone."""
    s = torch.sigmoid(h.float() @ router.float())
    choice = s if bias is None else s + bias.float()
    idx = torch.topk(choice, top_k, dim=-1).indices.sort(dim=-1).values
    g = s.gather(-1, idx)
    if norm:
        g = g / (g.sum(-1, keepdim=True) + 1e-6)
    return idx, g * scale


def routed_experts_plain(x: torch.Tensor, h: torch.Tensor, router: torch.Tensor,
                         bias: Optional[torch.Tensor], w13: torch.Tensor, w2: torch.Tensor,
                         top_k: int, norm: bool = True, scale: float = 1.0,
                         stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + the routed FFN of h, an expert at a time (x, h [N, H])."""
    N, H = h.shape
    E, I = w13.shape[0], w2.shape[1]
    idx, g = route(h, router, bias, top_k, norm, scale)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    if stats is not None:
        stats[:E] += counts
        stats[E] += (counts > 0).sum()
        stats[E + 1] += 1
    rows_of = order // top_k
    g_of = g.reshape(-1)[order]
    ys = torch.zeros((N, top_k, H), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts.tolist()):
        if n == 0:
            continue
        sl = slice(start, start + n)
        start += n
        rows = rows_of[sl]
        gu = h[rows].float() @ w13[e].float()
        act = (g_of[sl, None] * F.silu(gu[:, :I]) * gu[:, I:]).to(x.dtype)
        ys[rows, order[sl] % top_k] = act.float() @ w2[e].float()
    out = x.float()
    for k in range(top_k):  # the row's experts in expert order
        out = out + ys[:, k]
    return out.to(x.dtype)


class RouteStats:
    """Device counters of one engine's routed layers: for each, the rows
    routed to each expert, the experts touched and the calls, summed over
    decode calls (int64 [layers, E + 2])."""

    def __init__(self, layers: int, experts: int, batch: int, device):
        self.experts, self.batch = experts, batch
        self.counts = torch.zeros((layers, experts + 2), dtype=torch.int64, device=device)

    def layer(self, i: int) -> torch.Tensor:
        return self.counts[i]

    def read(self) -> Dict[str, float]:
        """``experts_touched``: the mean over calls of the experts a layer's
        call touched; ``load_max_over_mean``: per layer the busiest expert's
        rows over the mean expert's, averaged over the layers; ``calls``."""
        c = self.counts.cpu().double()
        calls = float(c[:, -1].sum())
        if not calls:
            return {"experts_touched": 0.0, "load_max_over_mean": 0.0, "calls": 0.0}
        load = c[:, : self.experts]
        mean = load.mean(1).clamp_min(1e-12)
        used = c[:, -1] > 0
        return {"experts_touched": float(c[:, self.experts].sum()) / calls,
                "load_max_over_mean": float((load.max(1).values / mean)[used].mean()),
                "calls": calls}


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = cuda_build.library("routed_experts").qwen3tts_routed_experts
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _workspaces(device, H: int, E: int, I: int, K: int):
    """(lists int32, g float32 [E, 16], activations [E, 16, I] bf16,
    partials float32 [E, 16, H], tickets [H / 64] zeros), once per shape."""
    key = (device, H, E, I, K)
    ws = _workspace.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("routed_experts: call once at this shape before CUDA-graph "
                               "capture (its tickets must be zeroed eagerly)")
        z = dict(device=device)
        ws = _workspace[key] = (
            torch.zeros((E + E * MAX_ROWS + 2 * MAX_ROWS * K,), dtype=torch.int32, **z),
            torch.zeros((E, MAX_ROWS), dtype=torch.float32, **z),
            torch.zeros((E, MAX_ROWS, I), dtype=torch.bfloat16, **z),
            torch.zeros((E, MAX_ROWS, H), dtype=torch.float32, **z),
            torch.zeros((H // 64,), dtype=torch.int32, **z))
    return ws


def kernel_misfit(x: torch.Tensor, w13: torch.Tensor, top_k: int) -> Optional[str]:
    """Why the decode kernel cannot take this call (None: it can)."""
    N, H = x.shape
    E, I = w13.shape[0], w13.shape[2] // 2
    if not 1 <= N <= MAX_ROWS:
        return f"{N} rows (the kernel takes 1 to {MAX_ROWS})"
    if x.dtype != torch.bfloat16 or w13.dtype != torch.bfloat16:
        return f"{x.dtype} activations / {w13.dtype} experts (the kernel takes bfloat16)"
    if E > MAX_EXPERTS or E % 8 or top_k > min(MAX_TOP_K, E):
        return (f"{E} experts, top {top_k} (a multiple of 8 up to {MAX_EXPERTS}, top "
                f"{MAX_TOP_K})")
    if H % 256 or I % 128:
        return f"hidden {H}, expert width {I} (multiples of 256 and 128)"
    return None


def routed_experts(x: torch.Tensor, h: torch.Tensor, router: torch.Tensor,
                   bias: Optional[torch.Tensor], w13: torch.Tensor, w2: torch.Tensor,
                   top_k: int, norm: bool = True, scale: float = 1.0,
                   stats: Optional[torch.Tensor] = None, decode: bool = True) -> torch.Tensor:
    """x + the routed FFN of h ([N, H] each), in x's dtype.  CPU tensors and
    prefills take the plain version; a decode call on CUDA tensors launches
    the kernel (or raises)."""
    if x.device.type == "cpu" or not decode:
        return routed_experts_plain(x, h, router, bias, w13, w2, top_k, norm, scale, stats)
    misfit = kernel_misfit(x, w13, top_k)
    if misfit:
        raise ValueError(f"routed_experts kernel: {misfit}")
    N, H = x.shape
    E, I = w13.shape[0], w2.shape[1]
    tensors = [x, h, router, w13, w2] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != x.device or not t.is_contiguous() or t.dtype != torch.bfloat16:
            raise ValueError("routed_experts kernel: contiguous bfloat16 tensors on one card")
    if stats is not None and (stats.dtype != torch.int64 or stats.shape != (E + 2,)
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int64 [{E + 2}]")
    lists, gw, act, part, ticket = _workspaces(x.device, H, E, I, top_k)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _kernel_fn()(
            x.data_ptr(), h.data_ptr(), router.data_ptr(),
            bias.data_ptr() if bias is not None else None, w13.data_ptr(), w2.data_ptr(),
            out.data_ptr(), lists.data_ptr(), gw.data_ptr(), act.data_ptr(), part.data_ptr(),
            ticket.data_ptr(), stats.data_ptr() if stats is not None else None, N, H, E, I,
            top_k, int(norm), float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"routed_experts kernel launch failed: cudaError {rc}")
    cuda_build.count_launches(routed_experts, 3)
    return out


routed_experts.launches = 0
