"""A safetensors reader and writer in plain Python and numpy.

The machine with the card has no ``safetensors`` package, so the port
carries the format itself.  A file is an 8-byte little-endian header
length ``N``, ``N`` bytes of JSON (per tensor ``dtype``, ``shape`` and
``data_offsets`` into the data section, plus an optional ``__metadata__``
of strings; padded with spaces to a multiple of 8), then the raw
little-endian tensor bytes, laid end to end.  The files are the
``safetensors`` package's: each reads the other's.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np

__all__ = ["load_file", "save_file"]

PathLike = Union[str, Path]

_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1",
    "BOOL": "?",
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_file(tensors: Mapping[str, np.ndarray], path: PathLike,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (numpy arrays of a dtype in ``_DTYPES``) and the
    string ``metadata`` to ``path``."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        code = _CODES.get(arr.dtype.newbyteorder("="))
        if code is None:
            raise TypeError(f"tensor {name!r}: dtype {arr.dtype} has no safetensors code")
        data = np.ascontiguousarray(arr, dtype=_DTYPES[code]).tobytes()
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def load_file(path: PathLike) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """``(tensors, metadata)`` of the file at ``path``; arrays in native
    byte order."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} runs past the file")
    header = json.loads(raw[8:8 + n].decode())
    metadata = dict(header.pop("__metadata__", None) or {})
    data = memoryview(raw)[8 + n:]
    tensors = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise TypeError(f"tensor {name!r}: unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        dt = np.dtype(_DTYPES[info["dtype"]])
        shape = tuple(info["shape"])
        if end - start != dt.itemsize * int(np.prod(shape, dtype=np.int64)) or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} has bad data_offsets {start, end}")
        arr = np.frombuffer(data[start:end], dtype=dt).reshape(shape)
        tensors[name] = arr.astype(dt.newbyteorder("="))
    return tensors, metadata
