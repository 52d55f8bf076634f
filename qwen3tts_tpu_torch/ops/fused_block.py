"""Fused weight-streaming halves of a decoder block: the CUDA kernels and
their plain PyTorch versions.

Port of ``qwen3tts_tpu/ops/fused_block.py`` for decode-shaped activations
(B <= 32 rows):

  fused_norm_matmul   y = rms_norm(x, w_norm) @ W                 (qkv half)
  fused_o_mlp         x2 = x + attn @ Wo, kept in float32
                      y  = x2 + (silu(g) * u) @ Wd,  [g u] = rms_norm(x2) @ Wgu

A weight is a ``[in, out]`` tensor of x's dtype or an int8 weight-only dict
``{"q": int8 [in, out], "scale": f32 [1, out]}`` (``ops/quant.py``); the
three o/MLP weights are all plain or all int8.  The arithmetic is the Pallas
kernels': the norm in float32 times the float32 norm weight, cast to x's
dtype; an int8 weight dequantized per element to x's dtype; products
accumulated in float32; ``x2`` never rounded to x's dtype.

On CUDA tensors the wrappers launch the kernels of
``qwen3tts_tpu_torch/csrc/fused_block.cu`` (built at first use,
``ops/cuda_build.py``) or raise; on CPU tensors they run the plain versions.
``fused_norm_matmul.launches`` and ``fused_o_mlp.launches`` count kernel
launches (``o_mlp_launches(B)`` a ``fused_o_mlp`` call; a call during
CUDA-graph capture launches nothing and is not counted).  Both stream
their weights through a ring in shared memory (``csrc/wstream.cuh``), one
CTA per item of a geometry computed
here: ``fused_norm_matmul`` is one launch of column tiles as narrow as
fills the card (``norm_matmul_geometry``), rows taken 4 at a time inside it
above batch 1; ``fused_o_mlp`` is one cooperative launch of one CTA per SM
(one per 4 rows above 4), its work cut by ``o_mlp_geometry``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from . import cuda_build, wstream
from .quant import dequant

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
MAX_K = 2048  # longest activation row the kernels keep in shared memory
MAX_GU_COLS = 256  # widest gate/up tile of fused_o_mlp
MAX_NM_COLS = 256  # widest column tile of fused_norm_matmul
ROWS = 4  # rows of one fused_o_mlp launch above batch 1
STAGE_BYTES = 32768  # one stage of fused_o_mlp's ring
NM_STAGE_WEIGHTS = 8192  # weights in one stage of fused_norm_matmul's ring
_workspace: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def o_mlp_launches(B: int) -> int:
    """Kernel launches of one fused_o_mlp call over B rows."""
    return 1 if B == 1 else -(-B // ROWS)


def _rms_norm_f32(x_f32: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x_f32.pow(2).mean(dim=-1, keepdim=True)
    return x_f32 * torch.rsqrt(var + eps) * w.float()


def _weight(w: Any, dtype) -> torch.Tensor:
    """The weight in the compute dtype: as is, or dequantized per element."""
    return dequant(w, dtype) if isinstance(w, dict) else w


def fused_norm_matmul_plain(x: torch.Tensor, norm_w: torch.Tensor, w: Any,
                            eps: float = 1e-6) -> torch.Tensor:
    """[B, H] -> [B, N] in x's dtype."""
    h = _rms_norm_f32(x.float(), norm_w, eps).to(x.dtype)
    return (h.float() @ _weight(w, x.dtype).float()).to(x.dtype)


def tile_sum(parts: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis in the kernel's order: lane l of a warp adds
    parts l, l + 32, ... in increasing order, then the 32 lanes meet in a
    butterfly (offsets 16, 8, 4, 2, 1)."""
    lanes = torch.zeros((32,) + parts.shape[1:], dtype=parts.dtype)
    for t in range(parts.shape[0]):
        lanes[t % 32] = lanes[t % 32] + parts[t]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ off]
    return lanes[0]


def fused_o_mlp_plain(x: torch.Tensor, attn: torch.Tensor, o_w: Any, norm_w: torch.Tensor,
                      gateup_w: Any, down_w: Any, eps: float = 1e-6,
                      geo: Optional[Tuple[wstream.Geo, wstream.Geo]] = None) -> torch.Tensor:
    """[B, H] residual, [B, Dq] attention -> [B, H] in x's dtype.  With
    ``geo`` (``o_mlp_geometry``) the sums across CTAs are taken in the
    kernel's order: the o-projection's row splits in split order, the down
    projection's per-tile partial sums by ``tile_sum`` (CPU tensors)."""
    dt = x.dtype
    wo, wd = _weight(o_w, dt).float(), _weight(down_w, dt).float()
    if geo is None:
        x2 = x.float() + attn.float() @ wo
    else:
        s = torch.zeros(x.shape, dtype=torch.float32)
        for k_lo in range(0, attn.shape[1], geo[0].chunk):
            s = s + attn.float()[:, k_lo:k_lo + geo[0].chunk] @ wo[k_lo:k_lo + geo[0].chunk]
        x2 = x.float() + s
    h = _rms_norm_f32(x2, norm_w, eps).to(dt)
    gu = h.float() @ _weight(gateup_w, dt).float()
    g, u = gu.chunk(2, dim=-1)
    act = (g * torch.sigmoid(g) * u).to(dt)
    if geo is None:
        return (x2 + act.float() @ wd).to(dt)
    cols = geo[1].cols
    parts = torch.stack([act.float()[:, i0:i0 + cols] @ wd[i0:i0 + cols]
                         for i0 in range(0, wd.shape[0], cols)])
    return (x2 + tile_sum(parts)).to(dt)


# ---------------------------------------------------------------------------
# wrappers


def bind(lib: ctypes.CDLL):
    """(fused_norm_matmul, fused_o_mlp, o_mlp_grid) of a built library."""
    nm = lib.qwen3tts_fused_norm_matmul
    nm.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    nm.restype = ctypes.c_int
    om = lib.qwen3tts_fused_o_mlp
    om.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    om.restype = ctypes.c_int
    grid = lib.qwen3tts_o_mlp_grid
    grid.argtypes = [ctypes.c_int] * 3
    grid.restype = ctypes.c_int
    return nm, om, grid


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    return bind(cuda_build.library("fused_block"))


def _split(name: str, w: Any, rows: Optional[int], cols: Optional[int]):
    """(payload [rows, cols], scale or None) of a weight; ``None`` takes any
    extent."""
    if isinstance(w, dict):
        if set(w) != {"q", "scale"}:
            raise ValueError(f"{name}: the kernels take plain or int8 {{q, scale}} "
                             f"weights, not keys {sorted(w)}")
        q, scale = w["q"], w["scale"]
        if q.dtype != torch.int8 or scale.dtype != torch.float32 or (
                q.dim() == 2 and scale.numel() != q.shape[1]):
            raise ValueError(f"{name}: int8 q [in, out] with float32 scale [1, out] "
                             f"wanted; got {q.dtype} {tuple(q.shape)}, "
                             f"{scale.dtype} {tuple(scale.shape)}")
    else:
        q, scale = w, None
    if q.dim() != 2 or (rows is not None and q.shape[0] != rows) or (
            cols is not None and q.shape[1] != cols):
        raise ValueError(f"{name}: shape {tuple(q.shape)} does not fit ({rows}, {cols})")
    return q, scale


def _check_cuda(x: torch.Tensor, acts: Dict[str, torch.Tensor],
                weights: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]):
    """Device, dtype, contiguity and alignment of what the kernel reads:
    activations and norm weights in x's dtype; weights in x's dtype, or
    int8 with float32 scales."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernels run on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernels take bfloat16 or float32 activations, not {x.dtype}")
    want = {name: (t, x.dtype) for name, t in acts.items()}
    for name, (w, scale) in weights.items():
        want[name] = (w, x.dtype if scale is None else torch.int8)
        if scale is not None:
            want[f"{name} scale"] = (scale, torch.float32)
    for name, (t, dtype) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def _check_rows(B: int, K: int, N: int, what: str):
    if not (1 <= B and 1 <= K <= MAX_K and N >= 8 and N % 8 == 0):
        raise ValueError(f"{what}: no kernel instance for B {B}, K {K}, N {N} "
                         f"(needs K <= {MAX_K}, N % 8 == 0)")


def norm_matmul_geometry(H: int, N: int, grid: int) -> wstream.Geo:
    """Items of one fused_norm_matmul launch on ``grid`` SMs: column tiles
    only, as narrow as keeps the tiles within the grid (32 columns and 128
    tiles at N 4096, 16 and 128 at N 2048 on 132 SMs).  Nothing crosses the
    grid."""
    return wstream.phase_geo(H, N, grid, split_rows=False, min_cols=wstream.VEC)


@functools.lru_cache(maxsize=None)
def _norm_matmul_cols(H: int, N: int, device: torch.device) -> int:
    """Column-tile width of fused_norm_matmul on ``device`` (or raise)."""
    cols = norm_matmul_geometry(H, N, cuda_build.sm_count(device)).cols
    if cols > MAX_NM_COLS:
        raise ValueError(f"fused_norm_matmul: no kernel instance for N {N} (a tile of "
                         f"{cols} > {MAX_NM_COLS} columns)")
    return cols


def fused_norm_matmul(x: torch.Tensor, norm_w: torch.Tensor, w: Any,
                      eps: float = 1e-6) -> torch.Tensor:
    """rms_norm(x, norm_w) @ w: [B, H] -> [B, N] in x's dtype.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [B, H], got {tuple(x.shape)}")
    B, H = x.shape
    wq, ws = _split("w", w, H, None)
    N = wq.shape[1]
    if norm_w.shape != (H,):
        raise ValueError(f"norm_w shape {tuple(norm_w.shape)} != ({H},)")
    if x.device.type == "cpu":
        return fused_norm_matmul_plain(x, norm_w, w, eps)
    quant = ws is not None
    _check_cuda(x, {"x": x, "norm_w": norm_w}, {"w": (wq, ws)})
    _check_rows(B, H, N, "fused_norm_matmul")
    cols = _norm_matmul_cols(H, N, x.device)
    nm = _kernel_fns()[0]
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = nm(_DTYPE_CODE[x.dtype], int(quant), x.data_ptr(), norm_w.data_ptr(),
                wq.data_ptr(), ws.data_ptr() if quant else None, out.data_ptr(), B, H, N, cols,
                float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_norm_matmul kernel launch failed: cudaError {rc}")
    cuda_build.count_launches(fused_norm_matmul)
    return out


fused_norm_matmul.launches = 0


def o_mlp_geometry(H: int, Dq: int, I: int, grid: int) -> Tuple[wstream.Geo, wstream.Geo]:
    """(o-projection, MLP) geometry of one fused_o_mlp launch on ``grid``
    CTAs.  The o-projection is 32-column tiles of Wo x row splits of Dq; the
    MLP is one tile of the intermediate size per CTA (its gate and up
    columns over all of H, then its rows of Wd), as narrow as the grid
    allows: 24 columns and 128 tiles for I 3072 on 132 CTAs."""
    return (wstream.phase_geo(Dq, H, grid),
            wstream.phase_geo(H, I, grid, split_rows=False, min_cols=wstream.VEC))


@functools.lru_cache(maxsize=None)
def kernel_grid(dtype: torch.dtype, quant: bool, rows: int) -> int:
    """CTAs of one fused_o_mlp launch on the current card (one per SM)."""
    n = _kernel_fns()[2](_DTYPE_CODE[dtype], int(quant), rows)
    if n <= 0:
        raise RuntimeError(f"no co-resident grid for the fused_o_mlp kernel: cudaError {-n}")
    return n


def _workspaces(device, rows: int, H: int, KS: int, NT: int):
    """The partial sums part1 [KS, rows, H] and part2 [NT, rows, H] as 8-byte
    tagged words, zeroed once, and the sync words of the launches' tags,
    allocated once per shape (never during
    CUDA-graph capture: call each shape once before capturing).  Launches
    are ordered on the stream, so one set serves them all."""
    key = (device, rows, H, KS, NT)
    ws = _workspace.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused_o_mlp: call this shape once before capturing a CUDA "
                               "graph (its workspace is allocated at first use)")
        ws = _workspace[key] = (
            torch.zeros((KS, rows, H), dtype=torch.int64, device=device),
            torch.zeros((NT, rows, H), dtype=torch.int64, device=device),
            torch.tensor([0, 1, 0], dtype=torch.int32, device=device))
    return ws


def fused_o_mlp(x: torch.Tensor, attn: torch.Tensor, o_w: Any, norm_w: torch.Tensor,
                gateup_w: Any, down_w: Any, eps: float = 1e-6) -> torch.Tensor:
    """x + attn @ o_w, then + the SwiGLU MLP of its post-norm: [B, H] in x's
    dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernels (or raise)."""
    if x.dim() != 2 or attn.dim() != 2 or attn.shape[0] != x.shape[0]:
        raise ValueError(f"x [B, H] and attn [B, Dq] wanted; got {tuple(x.shape)}, "
                         f"{tuple(attn.shape)}")
    B, H = x.shape
    Dq = attn.shape[1]
    wd, sd = _split("w_down", down_w, None, H)
    I = wd.shape[0]
    wo, so = _split("w_o", o_w, Dq, H)
    wgu, sgu = _split("w_gateup", gateup_w, H, 2 * I)
    quant = so is not None
    if (sgu is not None) != quant or (sd is not None) != quant:
        raise ValueError("o/gateup/down weights must be all plain or all int8")
    if norm_w.shape != (H,):
        raise ValueError(f"norm_w shape {tuple(norm_w.shape)} != ({H},)")
    if x.device.type == "cpu":
        return fused_o_mlp_plain(x, attn, o_w, norm_w, gateup_w, down_w, eps)
    _check_cuda(x, {"x": x, "attn": attn, "norm_w": norm_w},
                {"w_o": (wo, so), "w_gateup": (wgu, sgu), "w_down": (wd, sd)})
    _check_rows(B, Dq, H, "fused_o_mlp (o-projection)")
    _check_rows(B, H, 2 * I, "fused_o_mlp (gate/up)")
    if I % wstream.VEC:
        raise ValueError(f"fused_o_mlp: no kernel instance for intermediate size {I} "
                         f"(needs a multiple of {wstream.VEC})")
    rows = 1 if B == 1 else ROWS
    grid = kernel_grid(x.dtype, quant, rows)
    geo_o, geo_mlp = o_mlp_geometry(H, Dq, I, grid)
    if geo_mlp.cols > MAX_GU_COLS:
        raise ValueError(f"fused_o_mlp: no kernel instance for intermediate size {I} on "
                         f"{grid} CTAs (a tile of {geo_mlp.cols} > {MAX_GU_COLS} columns)")
    NT = wstream.num_items(H, I, geo_mlp)
    part1, part2, sync = _workspaces(x.device, rows, H, geo_o.splits, NT)
    om = _kernel_fns()[1]
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 13)(*(None if t is None else t.data_ptr() for t in (
        x, attn, wo, so, norm_w, wgu, sgu, wd, sd, out, part1, part2, sync)))
    dims = (ctypes.c_int * 8)(B, H, Dq, I, geo_o.splits, geo_o.chunk, geo_o.cols,
                              geo_mlp.cols)
    with torch.cuda.device(x.device):
        rc = om(_DTYPE_CODE[x.dtype], int(quant), ptrs, dims, float(eps),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_o_mlp kernel launch failed: cudaError {rc}")
    cuda_build.count_launches(fused_o_mlp, o_mlp_launches(B))
    return out


fused_o_mlp.launches = 0
