"""One code-predictor micro-step (proj + every block + final norm) as one
kernel launch: the CUDA kernel and its plain PyTorch version.

Port of ``qwen3tts_tpu/ops/predictor_step.py:fused_micro_step``.  The
predictor's frame is 15 codebooks; after a 2-token prefill, codebooks
1..14 each run one single-token micro-step through the whole 5-layer
stack.  ``fused_micro_step`` runs that micro-step as one launch of the
persistent cooperative kernel in
``qwen3tts_tpu_torch/csrc/predictor_step.cu`` (built at first use,
``ops/cuda_build.py``); on CPU tensors it runs ``fused_micro_step_plain``.
``fused_micro_step.launches`` counts kernel launches (none during CUDA-graph
capture: ``cuda_build.count_launches``).  The kernel is one
CTA per SM that walks 1 + 4 L matrix phases (proj; per layer qkv, o with
the attention, gate|up, down) with a grid barrier after each and streams
its weights through a ring in shared memory that runs ahead across the
barriers (``csrc/wstream.cuh``); ``phase_geometry`` cuts every phase into
at most one item per CTA.

The arithmetic is the Pallas kernel's, not ``models/layers.py``'s: the
residual stream stays float32 through every layer (proj output plus the
float32 bias, o and down products added in float32); each activation is
cast to the weight dtype right before its product and the products are
accumulated in float32; q/k head-norm and rope are float32 with the
float32 norm weights; v is stored raw; scores are scaled by D^-0.5 and
masked to slots ``<= pos``; the probabilities are not rounded; the final
norm is cast to the dtype.  In bf16 this rounds at other places than the
default path.

Rows: 1 to ``MAX_ROWS`` rows at one ``pos`` (a frame's rows are all at the
same codebook), each streamed weight tile used by every row.  One row runs
the kernel ``micro_step_kernel`` as it was designed for batch 1; 2 to 16
rows run ``micro_step_kernel_rows`` (the source note says what changes with the
rows).  Plain (unquantized) weights of the activations' dtype, full
attention (no sliding window): ``models/predictor.py:micro_kernel_misfit``
is the one gate.  The cache ``[L, R, S, KVH, D]`` (the engine's layout) is
written in place at slot ``pos`` and returned, as the Pallas call's aliased
outputs are.  ``pos`` is an int32 device tensor and ``cos``/``sin`` are
device tensors, so a frame never waits for the host.

The Pallas kernel's head-major relayout, rotate-half matrix and scalar
prefetch schedule exist because Mosaic cannot reshape lanes; the CUDA
kernel reads the layer-stacked weights as they are, and
``micro_step_weights`` only converts the norm weights and the proj bias to
float32 once, outside the frame loop.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build, wstream
from .quant import is_quantized

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
MAX_ITEM_COLS = 2048  # most outputs of one item (gate and up columns together)
KV_BYTES = 24576  # shared memory for the cache rows an o-phase item's attention reads
MAX_ROWS = 16  # most rows of one launch (the mma's rows)
PHASES = ("proj", "qkv", "o", "gu", "down")  # the kernel's phase kinds, in its order
_MATRICES = ("proj_w", "qkv", "o", "gu", "dn")
_workspace: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

Weights = Dict[str, torch.Tensor]


def micro_step_weights(params: Dict) -> Weights:
    """The predictor's parameters as the micro-step reads them, prepared
    once outside the frame loop: the layer-stacked matrices as they are
    (``[L, in, out]``), the norm weights and the proj bias in float32."""
    blocks = params["blocks"]
    if any(is_quantized(blocks[k]) for k in ("qkv_proj", "o_proj", "gateup_proj",
                                             "down_proj")):
        raise ValueError("fused_micro_step takes plain (unquantized) weights")

    def f32(t):
        return t.float().contiguous()

    return {
        "proj_w": params["small_to_mtp"]["w"].contiguous(),
        "proj_b": f32(params["small_to_mtp"]["b"]),
        "in_norm": f32(blocks["input_norm"]),
        "post_norm": f32(blocks["post_norm"]),
        "q_norm": f32(blocks["q_norm"]),
        "k_norm": f32(blocks["k_norm"]),
        "final_norm": f32(params["final_norm"]),
        "qkv": blocks["qkv_proj"].contiguous(),
        "o": blocks["o_proj"].contiguous(),
        "gu": blocks["gateup_proj"].contiguous(),
        "dn": blocks["down_proj"].contiguous(),
    }


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A cache as [L, R, S, KVH, D]; one row's [L, S, KVH, D] gains its row
    axis (a view: writes reach the caller's tensor)."""
    if t.dim() not in (4, 5):
        raise ValueError(f"the cache must be [L, R, S, KVH, D] or one row's [L, S, KVH, D], "
                         f"got {tuple(t.shape)}")
    return t.unsqueeze(1) if t.dim() == 4 else t


def _geometry(w: Weights, kv_k: torch.Tensor) -> Tuple[int, ...]:
    """(Ht, Hp, NH, KVH, D, I, L, S) of a cache [L, R, S, KVH, D] or [L, S,
    KVH, D], checked against every weight."""
    L, _, S, KVH, D = _rows(kv_k).shape
    Ht, Hp = w["proj_w"].shape
    QT = w["qkv"].shape[-1]
    NH = QT // D - 2 * KVH
    I = w["dn"].shape[1]
    want = {"proj_b": (Hp,), "in_norm": (L, Hp), "post_norm": (L, Hp), "q_norm": (L, D),
            "k_norm": (L, D), "final_norm": (Hp,), "qkv": (L, Hp, (NH + 2 * KVH) * D),
            "o": (L, NH * D, Hp), "gu": (L, Hp, 2 * I), "dn": (L, I, Hp)}
    for name, shape in want.items():
        if tuple(w[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(w[name].shape)}, want {shape} for "
                             f"a [{L}, R, {S}, {KVH}, {D}] cache")
    if NH < 1 or NH % KVH:
        raise ValueError(f"{NH} query heads do not group over {KVH} kv heads")
    return Ht, Hp, NH, KVH, D, I, L, S


def _rms_f32(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.pow(2).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def fused_micro_step_plain(w: Weights, x_emb: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor, kv_k: torch.Tensor, kv_v: torch.Tensor,
                           pos: torch.Tensor, eps: float = 1e-6,
                           geo: Optional[Dict[str, wstream.Geo]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The micro-step in PyTorch ops, with the kernel's arithmetic, row by
    row (the rows meet only in ``pos``).  Writes slot ``pos`` of the cache
    [L, R, S, KVH, D] (or one row's [L, S, KVH, D]) in place; returns (h
    [R, Hp], kv_k, kv_v).  With ``geo`` (``phase_geometry``) every product
    is summed over its row splits in split order, as the kernel's readers
    sum them."""
    k5, v5 = _rows(kv_k), _rows(kv_v)
    _geometry(w, kv_k)
    h = [_plain_row(w, x_emb[r:r + 1], cos, sin, k5[:, r], v5[:, r], pos, eps, geo)
         for r in range(x_emb.shape[0])]
    return torch.cat(h), kv_k, kv_v


def _plain_row(w: Weights, x_emb, cos, sin, kv_k, kv_v, pos, eps, geo):
    """One row: x_emb [1, Ht], the row's cache [L, S, KVH, D] -> h [1, Hp]."""
    L, S, KVH, D = kv_k.shape
    NH = w["qkv"].shape[-1] // D - 2 * KVH
    I = w["dn"].shape[1]
    dt = x_emb.dtype
    G = NH // KVH

    def mv(a, m, kind):  # a float32 [1, K], cast to the dtype; products summed in float32
        a = a.to(dt).float()
        if geo is None:
            return a @ m.float()
        chunk = geo[kind].chunk
        s = torch.zeros((1, m.shape[1]), dtype=torch.float32, device=a.device)
        for k_lo in range(0, m.shape[0], chunk):
            s = s + a[:, k_lo:k_lo + chunk] @ m[k_lo:k_lo + chunk].float()
        return s

    rows = pos.reshape(1).long()
    live = torch.arange(S, device=x_emb.device) <= rows  # [S]
    cs, sn = cos.float(), sin.float()
    xp = w["proj_b"] + mv(x_emb.float(), w["proj_w"], "proj")  # [1, Hp] float32
    for l in range(L):
        qkv = mv(_rms_f32(xp, w["in_norm"][l], eps), w["qkv"][l], "qkv")[0]
        q = qkv[: NH * D].reshape(NH, D)
        k = qkv[NH * D: (NH + KVH) * D].reshape(KVH, D)
        v = qkv[(NH + KVH) * D:].reshape(KVH, D)
        q = _rms_f32(q, w["q_norm"][l], eps)
        k = _rms_f32(k, w["k_norm"][l], eps)
        q = q * cs + _rotate_half(q) * sn
        k = k * cs + _rotate_half(k) * sn
        kv_k[l].index_copy_(0, rows, k.to(kv_k.dtype)[None])
        kv_v[l].index_copy_(0, rows, v.to(kv_v.dtype)[None])
        kc = kv_k[l].float().permute(1, 0, 2)  # [KVH, S, D]
        vc = kv_v[l].float().permute(1, 0, 2)
        sc = torch.matmul(q.reshape(KVH, G, D), kc.transpose(-1, -2)) * (D ** -0.5)
        p = torch.softmax(sc.masked_fill(~live, -1e30), dim=-1)  # [KVH, G, S]
        attn = torch.matmul(p, vc).reshape(1, NH * D)
        xp = xp + mv(attn, w["o"][l], "o")
        gu = mv(_rms_f32(xp, w["post_norm"][l], eps), w["gu"][l], "gu")
        g, u = gu[:, :I], gu[:, I:]
        xp = xp + mv(g * torch.sigmoid(g) * u, w["dn"][l], "down")
    return _rms_f32(xp, w["final_norm"], eps).to(dt)


# ---------------------------------------------------------------------------
# wrapper


def phase_dims(dims) -> Dict[str, Tuple[int, int]]:
    """(K, N) of each phase kind: depth and output width."""
    Ht, Hp, NH, KVH, D, I, L, S = dims
    Dq = NH * D
    return {"proj": (Ht, Hp), "qkv": (Hp, Dq + 2 * KVH * D), "o": (Dq, Hp), "gu": (Hp, I),
            "down": (I, Hp)}


def phase_geometry(dims, grid: int) -> Dict[str, wstream.Geo]:
    """How each phase kind is cut into at most one item per CTA of a grid
    of ``grid``: 32-column tiles x row splits (the reader of a phase's
    output sums the splits in order); the gate|up phase one tile of the
    intermediate size per CTA over all rows, as narrow as the grid allows,
    since the activation needs whole sums."""
    return {kind: wstream.phase_geo(K, N, grid, split_rows=kind != "gu",
                                    min_cols=wstream.VEC if kind == "gu" else
                                    wstream.MIN_COLS)
            for kind, (K, N) in phase_dims(dims).items()}


def attention_kv_heads(dims, geo_o: wstream.Geo) -> int:
    """The most kv heads whose cache rows one o-phase item reads: the heads
    whose columns lie in its row split of Wo, mapped to their kv heads."""
    Ht, Hp, NH, KVH, D, I, L, S = dims
    G, Dq = NH // KVH, NH * D
    return max((min(Dq, k_lo + geo_o.chunk) - 1) // D // G - k_lo // D // G + 1
               for k_lo in range(0, Dq, geo_o.chunk))


def cta_jobs(dims, geo: Dict[str, wstream.Geo], cta: int, elt_size: int):
    """CTA ``cta``'s jobs over the 1 + 4 L phases of a micro-step, in the
    order the kernel's ring streams them: ``(rows, row_bytes)`` each, with
    0 rows where the CTA has no item in the phase."""
    L = dims[6]
    pd = phase_dims(dims)
    jobs = []
    for kind in ("proj",) + ("qkv", "o", "gu", "down") * L:
        item = wstream.item_of(cta, *pd[kind], geo[kind])
        if item is None:
            jobs.append((0, wstream.VEC * elt_size))
        else:
            jobs.append((item.k_hi - item.k_lo,
                         (2 if kind == "gu" else 1) * item.cols * elt_size))
    return jobs


def instance(dims, R: int, dtype: torch.dtype) -> Tuple[Dict[str, wstream.Geo], int]:
    """(geometry, owners) of a launch of R rows of these dims: the
    ``phase_geometry`` of the grid the kernel launches on
    (``kernel_grid``), and at R > 1 the CTAs that keep the residual's
    columns (0 at one row).  The kernel's own check
    (``csrc/predictor_step.cu``: ``fits``, through
    ``qwen3tts_micro_step_instance``) decides; raises ValueError where it
    has no instance."""
    Ht, Hp, NH, KVH, D, I, L, S = dims
    why = (f"{R} rows of Ht {Ht}, Hp {Hp}, {NH}/{KVH} heads of {D}, I {I}, {L} layers, "
           f"{S} slots in {dtype}")
    if dtype not in _DTYPE_CODE or not 1 <= R <= MAX_ROWS:
        raise ValueError(f"fused_micro_step has no kernel instance for {why} (bfloat16 or "
                         f"float32, 1 to {MAX_ROWS} rows)")
    grid = kernel_grid(dtype, D, R > 1)
    geo = phase_geometry(dims, grid)
    _, _, _, check = _kernel_fns()
    owners = check(_DTYPE_CODE[dtype], (ctypes.c_int * 8)(*dims), _geo_words(dims, geo), R)
    if owners < 0:
        raise ValueError(f"fused_micro_step has no kernel instance for {why} on {grid} CTAs")
    return geo, owners


def _geo_words(dims, geo: Dict[str, wstream.Geo]):
    """The C interface's geo: (C, KS, chunk) of each phase kind, then the
    barrier flag."""
    return (ctypes.c_int * 16)(*(v for kind in PHASES for v in geo[kind]),
                               int(needs_barriers(dims, geo)))


def bind(lib: ctypes.CDLL):
    """(micro_step, micro_step_grid, grid_barriers, micro_step_instance) of a
    built library."""
    step = lib.qwen3tts_micro_step
    step.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float,
                                                              ctypes.c_float, ctypes.c_void_p]
    step.restype = ctypes.c_int
    grid = lib.qwen3tts_micro_step_grid
    grid.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    grid.restype = ctypes.c_int
    barriers = lib.qwen3tts_grid_barriers
    barriers.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    barriers.restype = ctypes.c_int
    check = lib.qwen3tts_micro_step_instance
    check.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    check.restype = ctypes.c_int
    return step, grid, barriers, check


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    return bind(cuda_build.library("predictor_step"))


def needs_barriers(dims, geo: Dict[str, wstream.Geo]) -> bool:
    """Whether the phases meet at grid barriers.  Where every phase kind has
    the same number of items, every CTA with items hands something on in
    every phase, and the tags on what crosses the grid order the phases by
    themselves; a CTA that skipped a phase could fall behind the
    workspace's reuse, so other shapes keep a barrier after every phase."""
    return len({wstream.num_items(*kn, geo[kind])
                for kind, kn in phase_dims(dims).items()}) > 1


def _workspace_for(device, dims, geo: Dict[str, wstream.Geo], R: int, owners: int):
    """What crosses the grid between phases, as 8-byte tagged words (proj /
    down, qkv and o partial sums: one row per row split and row; the
    activation; at R > 1 also the owners' residual, their sums of squares
    and the attention's output), zeroed once, and the sync words
    {grid barrier, next launch's tags, CTAs done}, allocated once per shape
    (never during CUDA-graph capture).  ``owners`` is ``instance``'s.
    Launches are ordered on the stream, so one set serves them all."""
    Ht, Hp, NH, KVH, D, I, L, S = dims
    QT = (NH + 2 * KVH) * D
    n = R * (max(geo["proj"].splits, geo["down"].splits) * Hp + geo["qkv"].splits * QT
             + geo["o"].splits * Hp + I + (Hp + owners + NH * D if R > 1 else 0))
    key = (device, n)
    ws = _workspace.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused_micro_step: call this shape once before capturing a "
                               "CUDA graph (its workspace is allocated at first use)")
        ws = _workspace[key] = (torch.zeros(n, dtype=torch.int64, device=device),
                                torch.tensor([0, 1, 0], dtype=torch.int32, device=device))
    return ws


def _check(w: Weights, x_emb, cos, sin, kv_k, kv_v, pos, dims):
    """Shapes and dtypes, on every device: the matrices, x_emb and the cache
    in one dtype, everything else float32 except the int32 pos."""
    Ht, Hp, NH, KVH, D, I, L, S = dims
    R = kv_k.shape[1]
    if x_emb.shape != (R, Ht) or kv_v.shape != kv_k.shape:
        raise ValueError(f"x_emb [{R}, {Ht}] and kv_v {tuple(kv_k.shape)} wanted; got "
                         f"{tuple(x_emb.shape)}, {tuple(kv_v.shape)}")
    if cos.shape != (D,) or sin.shape != (D,) or pos.numel() != 1:
        raise ValueError(f"cos/sin [{D}] and a one-element pos wanted; got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}, {tuple(pos.shape)}")
    dt = x_emb.dtype
    tensors = {"x_emb": (x_emb, dt), "kv_k": (kv_k, dt), "kv_v": (kv_v, dt),
               "cos": (cos, torch.float32), "sin": (sin, torch.float32),
               "pos": (pos, torch.int32)}
    tensors.update({name: (w[name], dt) for name in _MATRICES})
    tensors.update({name: (t, torch.float32) for name, t in w.items()
                    if name not in _MATRICES})
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    return tensors


def _check_cuda(tensors: Dict, x_emb: torch.Tensor):
    if x_emb.device.type != "cuda":
        raise ValueError(f"fused_micro_step runs on cpu or cuda, not {x_emb.device}")
    if x_emb.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes bfloat16 or float32, not {x_emb.dtype}")
    for name, (t, _) in tensors.items():
        if t.device != x_emb.device:
            raise ValueError(f"{name} is on {t.device}, x_emb on {x_emb.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in _MATRICES + ("kv_k", "kv_v") and t.data_ptr() % 16:  # 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")


def fused_micro_step(w: Weights, x_emb: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     kv_k: torch.Tensor, kv_v: torch.Tensor, pos: torch.Tensor,
                     eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One predictor micro-step of R rows: x_emb [R, Ht] (codec embeddings
    in talker space) -> (h [R, Hp], kv_k, kv_v), the cache [L, R, S, KVH, D]
    (or one row's [L, S, KVH, D]) written in place at slot ``pos`` (int32,
    one element, every row's).
    ``w`` comes from ``micro_step_weights``; ``cos``/``sin`` are the float32
    rope rows [D] for ``pos``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    k5, v5 = _rows(kv_k), _rows(kv_v)
    dims = _geometry(w, k5)
    Ht, Hp, NH, KVH, D, I, L, S = dims
    R = k5.shape[1]
    tensors = _check(w, x_emb, cos, sin, k5, v5, pos, dims)
    if x_emb.device.type == "cpu":
        return fused_micro_step_plain(w, x_emb, cos, sin, kv_k, kv_v, pos, eps)
    _check_cuda(tensors, x_emb)
    geo, owners = instance(dims, R, x_emb.dtype)
    out = torch.empty((R, Hp), dtype=x_emb.dtype, device=x_emb.device)
    ws, sync = _workspace_for(x_emb.device, dims, geo, R, owners)
    ptrs = (ctypes.c_void_p * 20)(*(t.data_ptr() for t in (
        x_emb, w["proj_w"], w["proj_b"], w["in_norm"], w["post_norm"], w["q_norm"],
        w["k_norm"], w["final_norm"], w["qkv"], w["o"], w["gu"], w["dn"], cos, sin,
        kv_k, kv_v, pos, out, ws, sync)))
    step = _kernel_fns()[0]
    with torch.cuda.device(x_emb.device):
        rc = step(_DTYPE_CODE[x_emb.dtype], ptrs, (ctypes.c_int * 8)(*dims),
                  _geo_words(dims, geo), R, float(eps), float(D ** -0.5),
                  torch.cuda.current_stream(x_emb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_micro_step kernel launch failed: cudaError {rc}")
    cuda_build.count_launches(fused_micro_step)
    return out, kv_k, kv_v


fused_micro_step.launches = 0


@functools.lru_cache(maxsize=None)
def kernel_grid(dtype: torch.dtype, head_dim: int, rows: bool = False) -> int:
    """CTAs of one micro-step launch on the current card (one per SM), of
    one row or (``rows``) of 2 to 16."""
    grid = _kernel_fns()[1]
    n = grid(_DTYPE_CODE[dtype], head_dim, 2 if rows else 1)
    if n <= 0:
        raise RuntimeError(f"no co-resident grid for the micro-step kernel: cudaError {-n}")
    return n


def grid_barriers(grid: int, n: int, stream: torch.cuda.Stream) -> None:
    """Launch ``n`` grid-wide barriers on ``grid`` CTAs and nothing else:
    the barriers' share of a micro-step, timed apart."""
    barriers = _kernel_fns()[2]
    rc = barriers(grid, n, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grid barrier launch failed: cudaError {rc}")
