"""Flash-decode attention for the talker: the CUDA kernel and its plain
PyTorch version.

Port of ``qwen3tts_tpu/ops/flash_decode.py:flash_decode_stacked``: one query
token per row attends to one layer of the layer-stacked static cache
``[L, B, S, KVH, D]``, over the live slots ``[pad[b], pos]`` (and, with a
sliding window, only the last ``window`` of them).  A row with no live slot
returns exact zeros.

``flash_decode`` is the one entry point.  On CUDA tensors it launches the
hand-written kernel in ``qwen3tts_tpu_torch/csrc/flash_decode.cu`` or raises;
on CPU tensors it runs ``flash_decode_plain``.  The kernel is compiled with
nvcc for ``sm_90a`` at first use into ``qwen3tts_tpu_torch/_build/`` (keyed
by a hash of the source and the nvcc command) and bound with ctypes.
``flash_decode.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

NEG_INF = -1e30

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "flash_decode.cu"
BUILD_DIR = _PKG / "_build"
GENCODE = "arch=compute_90a,code=sm_90a"
KERNEL_HEAD_DIM = 128  # the talker's head layout, the one the kernel is built for
KERNEL_GROUP = 2  # query heads per kv head
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

_lib = None
_lib_lock = threading.Lock()
build_log = ""  # ptxas resource report of the last build (registers, smem, spills)


def flash_decode_plain(
    q: torch.Tensor,  # [B, NH, D]
    k_stack: torch.Tensor,  # [L, B, S, KVH, D]
    v_stack: torch.Tensor,
    layer: int,
    pos: torch.Tensor,  # int32, one element
    pad: torch.Tensor,  # [B] int32
    window: Optional[int] = None,
) -> torch.Tensor:
    """Masked full-length softmax in float32 over every slot of ``layer``.
    Masked probabilities are zeroed and the denominator clamped, exactly as
    the kernel does, so a row with ``pad > pos`` gives zeros, not NaN."""
    _, B, S, KVH, D = k_stack.shape
    NH = q.shape[1]
    G = NH // KVH
    qg = q.reshape(B, KVH, G, D).float()
    k = k_stack[layer].permute(0, 2, 1, 3).float()  # [B, KVH, S, D]
    v = v_stack[layer].permute(0, 2, 1, 3).float()
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


def kernel_supports(head_dim: int, num_heads: int, num_kv_heads: int) -> bool:
    """Whether the CUDA kernel is instantiated for this head layout."""
    return head_dim == KERNEL_HEAD_DIM and num_heads == KERNEL_GROUP * num_kv_heads


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME/bin): "
                       "the flash-decode kernel cannot be built")


def nvcc_command(nvcc: str, out: Path) -> list:
    return [nvcc, "-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
            "-o", str(out), str(SOURCE)]


def build_key(cmd_flags: list) -> str:
    """Hash of the kernel source and the compile flags: a changed source or
    flag builds into a new directory."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(cmd_flags).encode())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        nvcc = _nvcc()
        flags = nvcc_command("nvcc", Path("lib.so"))
        out_dir = BUILD_DIR / build_key(flags)
        so = out_dir / "libflash_decode.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libflash_decode.{os.getpid()}.tmp.so"
            proc = subprocess.run(nvcc_command(nvcc, tmp), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {SOURCE} (exit {proc.returncode}):\n"
                    f"{proc.stderr}")
            build_log = proc.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.qwen3tts_flash_decode
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(q, k_stack, v_stack, layer, pos, pad):
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


def flash_decode(
    q: torch.Tensor,  # [B, NH, D]
    k_stack: torch.Tensor,  # [L, B, S, KVH, D]
    v_stack: torch.Tensor,
    layer: int,
    pos: torch.Tensor,  # int32 device tensor, one element
    pad: torch.Tensor,  # [B] int32 device tensor
    window: Optional[int] = None,
) -> torch.Tensor:
    """Attention output [B, NH, D] in q's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    _check(q, k_stack, v_stack, layer, pos, pad)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_stack, v_stack, layer, pos, pad, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu or cuda, not {q.device}")
    tensors = {"q": q, "k": k_stack, "v": v_stack, "pos": pos, "pad": pad}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE or k_stack.dtype != q.dtype or v_stack.dtype != q.dtype:
        raise ValueError(f"kernel takes bfloat16 or float32 q/k/v of one dtype; got "
                         f"{q.dtype}, {k_stack.dtype}, {v_stack.dtype}")
    if pos.dtype != torch.int32 or pad.dtype != torch.int32:
        raise ValueError("pos and pad must be int32")
    L, B, S, KVH, D = k_stack.shape
    NH = q.shape[1]
    if not kernel_supports(D, NH, KVH):
        raise ValueError(f"kernel has no instance for head_dim {D}, "
                         f"{NH} heads over {KVH} kv heads")
    lib = load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        rc = lib.qwen3tts_flash_decode(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr(),
            out.data_ptr(), pos.data_ptr(), pad.data_ptr(), int(layer), B, S, NH,
            KVH, D, int(window) if window else 0, float(D ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
