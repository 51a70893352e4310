"""The safetensors format, read and written without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, N bytes of JSON mapping
each tensor's name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the byte buffer after the header; an optional
``"__metadata__"`` of strings), then that buffer. Tensors are written in
order of falling element size, then name, so every tensor's offset is a
multiple of its element size, and the header is padded with spaces to a
multiple of 8 bytes, as the ``safetensors`` package does. Reading goes
through ``torch.frombuffer``, so BF16 needs no numpy dtype.

Dtypes: BF16, F16, F32, I8, I32.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Mapping

import numpy as np
import torch

_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I8": torch.int8,
    "I32": torch.int32,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _as_tensor(name: str, x) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    if t.dtype not in _NAMES:
        raise ValueError(f"{name}: dtype {t.dtype} is not one of {sorted(_DTYPES)}")
    return t.detach().contiguous()


def save_file(tensors: Mapping[str, "torch.Tensor | np.ndarray"], path: str,
              metadata: Mapping[str, str] | None = None) -> None:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) to
    ``path`` in the safetensors format."""
    items = {name: _as_tensor(name, x) for name, x in tensors.items()}
    order = sorted(items, key=lambda n: (-items[n].element_size(), n))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = items[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            t = items[name]
            if t.numel():
                f.write(t.cpu().reshape(-1).view(torch.uint8).numpy().data)


def read_header(path: str) -> tuple[dict, int]:
    """(header without ``__metadata__``, byte offset of the data buffer)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors viewing one
    copy-on-write mapping of the file: processes that load one checkpoint
    share its pages in the page cache, and a write to a tensor stays
    private to it."""
    header, start = read_header(path)
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, spec in header.items():
        if spec["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {spec['dtype']}, not one of "
                             f"{sorted(_DTYPES)}")
        dtype = _DTYPES[spec["dtype"]]
        begin, end = spec["data_offsets"]
        shape = tuple(spec["shape"])
        numel = int(np.prod(shape, dtype=np.int64))
        if end - begin != numel * dtype.itemsize or start + end > len(buf):
            raise ValueError(f"{path}: {name}'s data_offsets {spec['data_offsets']} do not "
                             f"hold {shape} {spec['dtype']}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=numel,
                                         offset=start + begin).reshape(shape)
    return out
