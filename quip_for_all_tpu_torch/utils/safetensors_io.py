"""A small reader and writer for the safetensors file format, so the port
needs no ``safetensors`` package: an 8-byte little-endian header length N,
an N-byte
JSON header {name: {"dtype", "shape", "data_offsets": [begin, end]}, ...,
"__metadata__"?}, then the raw little-endian tensor bytes (offsets are
relative to the end of the header).

Tensors come back as numpy arrays; BF16 (which numpy lacks) is widened
exactly to float32. ``save_file`` writes the layout the ``safetensors``
package writes (header padded with spaces to 8 bytes, tensors back to back
in the header's order), so either side reads the other's files.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_header(path: str) -> tuple:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str, names: Optional[Iterable[str]] = None
              ) -> Dict[str, np.ndarray]:
    """{name: array} for every tensor in the file (or only ``names``)."""
    header, base = read_header(path)
    want = header.keys() if names is None else names
    out = {}
    with open(path, "rb") as f:
        for name in want:
            meta = header[name]
            begin, end = meta["data_offsets"]
            f.seek(base + begin)
            raw = f.read(end - begin)
            shape = tuple(meta["shape"])
            if meta["dtype"] == "BF16":
                bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32)
                arr = (bits << 16).view(np.float32)
            elif meta["dtype"] in _DTYPES:
                dt = np.dtype(_DTYPES[meta["dtype"]]).newbyteorder("<")
                arr = np.frombuffer(raw, dtype=dt).astype(dt.newbyteorder(
                    "="))
            else:
                raise ValueError(f"{name}: unsupported dtype {meta['dtype']}")
            out[name] = arr.reshape(shape)
    return out


def save_file(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write {name: array} (numpy dtypes of ``_DTYPES``) as one file."""
    names = {np.dtype(v): k for k, v in _DTYPES.items()}
    header: Dict[str, object] = {}
    blobs, off = [], 0
    for name in sorted(tensors):
        # np.ascontiguousarray would make a 0-d array (a scalar Wscale,
        # the HF weight shim) 1-d
        arr = np.asarray(tensors[name])
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        if arr.dtype not in names:
            raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": names[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)))
        f.write(h)
        for raw in blobs:
            f.write(raw)
