"""A safetensors reader and writer in torch and ``json`` only.

The port reads and writes checkpoints without the ``safetensors`` package
(and without ``ml_dtypes``: numpy has no bfloat16, torch has).  A file is an
8-byte little-endian header length, a JSON header mapping each tensor's
name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into
the data that follows the header; an optional ``"__metadata__"`` entry is
skipped), then the tensors' raw little-endian bytes.

``load_file`` maps the file and returns CPU tensors that view the mapping
(copy-on-write: nothing is written back), so a checkpoint's bytes are read
from the page cache as they are used rather than copied up front.
``save_file`` writes a contiguous CPU copy of each tensor, one at a time:
a view's own elements, never its base buffer.
"""
from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Dict

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64, "U8": torch.uint8,
          "BOOL": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}
# the ``safetensors`` writer's order: by dtype, widest first (its enum's
# order, descending), then by name; readers return tensors in file order
_RANK = {"BOOL": 0, "U8": 1, "I8": 2, "F16": 3, "BF16": 4, "I32": 5, "F32": 6, "I64": 7}
_ALIGN = 8  # the header is padded with spaces to a multiple of 8 bytes


def _read_header(path) -> tuple:
    """(header dict without ``__metadata__``, the data's start)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, in the order of their bytes
    in the file (as the ``safetensors`` package returns them)."""
    header, start = _read_header(path)
    out: Dict[str, torch.Tensor] = {}
    if not header:
        return out
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name in sorted(header, key=lambda k: int(header[k]["data_offsets"][0])):
        info = header[name]
        dtype = DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(x) for x in info["data_offsets"])
        count = end - begin
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= s
        if count != numel * itemsize:
            raise ValueError(f"{path}: tensor {name!r} has {count} bytes for shape "
                             f"{shape} of {info['dtype']}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = start + begin
        if offset % itemsize:  # an unaligned tensor: read its bytes into their own buffer
            t = torch.frombuffer(bytearray(buf[offset:offset + count]), dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=numel, offset=offset)
        out[name] = t.reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path) -> None:
    """Write ``tensors`` (CPU or not: each is copied to a contiguous CPU
    tensor first) as one safetensors file, in the ``safetensors`` writer's
    order."""
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name!r}: a torch.Tensor is required, got {type(t).__name__}")
        if t.dtype not in NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors name")
    names = sorted(tensors, key=lambda k: (-_RANK[NAMES[tensors[k].dtype]], k))
    header: Dict[str, object] = {}
    offset = 0
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-(8 + len(raw)) % _ALIGN)
    with open(Path(path), "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:  # one host copy at a time
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
