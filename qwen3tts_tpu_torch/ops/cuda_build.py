"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by nvcc for ``sm_90a`` into a shared
library with a plain C interface, bound with ctypes.  The build happens at
first use, into ``qwen3tts_tpu_torch/_build/<key>/``, where ``key`` hashes
every source under ``csrc/`` and the nvcc flags: a changed source or flag
builds into a new directory.  All sources build together, one nvcc process
each, started at once, so the first kernel call pays for the slowest source
only.  ``build_log[name]`` keeps nvcc's ptxas report (registers, shared
memory, spills) of the last build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENCODE = "arch=compute_90a,code=sm_90a"
SOURCES = {"flash_decode": CSRC / "flash_decode.cu",
           "fused_block": CSRC / "fused_block.cu",
           "predictor_step": CSRC / "predictor_step.cu",
           "matvec": CSRC / "matvec.cu",
           "w8a8": CSRC / "w8a8.cu",
           "routed_experts": CSRC / "routed_experts.cu",
           "graph_cond": CSRC / "graph_cond.cu"}

# each launch wrapper's kernel, as its name appears (mangled) in a CUDA
# graph's kernel nodes; flash_decode_kernel is the float and the int8 cache's
# and names flash_decode_kernel_d64g4 too, micro_step_kernel names
# micro_step_kernel_rows too, routed_experts_ the three launches of
# ops/routed_experts.py (a graph walk matches substrings)
KERNEL_SYMBOLS = {"flash_decode": "flash_decode_kernel", "fused_norm_matmul": "norm_matmul_kernel",
                  "fused_o_mlp": "o_mlp_kernel", "fused_micro_step": "micro_step_kernel",
                  "quantize_act": "quantize_act_kernel", "w8a8_gemv": "fused_w8a8_gemv_kernel",
                  "routed_experts": "routed_experts_"}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def nvcc_command(nvcc_path: str, out: Path, source: Path,
                 defines: Sequence[str] = ()) -> List[str]:
    """``defines`` (``NAME`` or ``NAME=value``) build a variant of a source
    for ``tools/kernel_probe.py``; the shipped libraries take none."""
    return [nvcc_path, "-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
            *(f"-D{d}" for d in defines), f"-I{CSRC}", "-o", str(out), str(source)]


def build_key() -> str:
    """Hash of every file under csrc/ and of the compile flags."""
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(nvcc_command("nvcc", Path("lib.so"), Path("src.cu"))).encode())
    return h.hexdigest()[:16]


def _build_all() -> Dict[str, Path]:
    """Compile every missing library, all nvcc processes at once."""
    out_dir = BUILD_DIR / build_key()
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    missing = [name for name, so in libs.items() if not so.exists()]
    if not missing:
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in missing:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(exe, tmp, SOURCES[name]), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed to build {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        build_log[name] = err
        os.replace(tmp, libs[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building all on first use)."""
    with _lock:
        if name not in _libs:
            for lib_name, so in _build_all().items():
                _libs[lib_name] = ctypes.CDLL(str(so))
        return _libs[name]


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on the H100 SXM)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def count_launches(fn, n: int = 1, counter: str = "launches") -> None:
    """Add the ``n`` kernel launches of a wrapper's call to ``fn.<counter>``.
    A call while the current stream captures a CUDA graph launches nothing
    (the graph's replays do, and a walk of the graph counts those), so it is
    not counted."""
    import torch

    if not torch.cuda.is_current_stream_capturing():
        setattr(fn, counter, getattr(fn, counter) + n)


def load_all() -> None:
    """Build and load every kernel library."""
    library(next(iter(SOURCES)))
