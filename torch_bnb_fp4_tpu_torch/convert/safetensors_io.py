"""The safetensors file format, read and written with torch and the standard
library alone (the card's machine has no ``safetensors`` package).

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}``, padded with spaces), then the data: each tensor's row-major
bytes at ``data_offsets`` counted from the end of the header.  bf16 tensors
are read with ``torch.frombuffer(..., dtype=torch.bfloat16)``.

The reader keeps the order the JAX package's converter reads in
(``safe_open(...).keys()``): shards sorted by file name, each shard's tensors
sorted by name.  Tensors come back as CPU torch tensors that own their bytes.
"""

from __future__ import annotations

import json
import os
import struct
from collections.abc import Iterator

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_NP_DTYPES = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
              np.dtype(np.int64): "I64", np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
              np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8", np.dtype(np.bool_): "BOOL"}


def shard_files(model_dir: str) -> list[str]:
    """The ``.safetensors`` files of a model directory, sorted by name."""
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors") and not f.startswith("."))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    return [os.path.join(model_dir, f) for f in files]


def read_header(path: str) -> tuple[dict, int]:
    """(tensor entries by name, without ``__metadata__``; offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def shard_keys(path: str) -> list[str]:
    """Tensor names of one file, sorted (``safe_open(...).keys()``'s order)."""
    return sorted(read_header(path)[0])


def iter_tensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of every tensor in one file, in sorted name order."""
    header, start = read_header(path)
    with open(path, "rb") as f:
        for name in sorted(header):
            e = header[name]
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {e['dtype']!r}")
            b0, b1 = e["data_offsets"]
            buf = bytearray(b1 - b0)
            f.seek(start + b0)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name!r} is truncated")
            dtype = DTYPES[e["dtype"]]
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty((0,), dtype=dtype)
            yield name, t.reshape(e["shape"])


def load_file(path: str) -> dict[str, torch.Tensor]:
    return dict(iter_tensors(path))


def _as_bytes(t) -> tuple[str, list[int], np.ndarray]:
    """(dtype name, shape, flat uint8 view) of a torch tensor or numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"cannot store dtype {t.dtype} in safetensors")
        return _NAMES[t.dtype], list(t.shape), t.reshape(-1).view(torch.uint8).numpy()
    a = np.ascontiguousarray(t)
    if a.dtype not in _NP_DTYPES:
        raise ValueError(f"cannot store dtype {a.dtype} in safetensors")
    return _NP_DTYPES[a.dtype], list(a.shape), a.reshape(-1).view(np.uint8)


def save_file(tensors: dict, path: str, metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (name -> torch tensor or numpy array) as one
    safetensors file, data in the dict's order."""
    parts, header, offset = [], {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, t in tensors.items():
        dtype, shape, raw = _as_bytes(t)
        header[name] = {"dtype": dtype, "shape": shape, "data_offsets": [offset, offset + raw.size]}
        parts.append(raw)
        offset += raw.size
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in parts:
            f.write(memoryview(raw))
