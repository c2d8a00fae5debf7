"""A reader of the safetensors format, without the `safetensors` package:
an 8-byte little-endian header length, a JSON header mapping each name to
its `dtype`, `shape` and `data_offsets` (into the bytes after the header;
`__metadata__` is skipped), then the raw little-endian tensor bytes."""

from __future__ import annotations

import json
import struct

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}


def load_file(path: str) -> dict[str, torch.Tensor]:
    """name -> CPU tensor, for the dtypes F32, F16, BF16 and I64."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, not one of {sorted(DTYPES)}")
        begin, end = meta["data_offsets"]
        t = torch.frombuffer(bytearray(data[begin:end]), dtype=DTYPES[meta["dtype"]]) if end > begin else (
            torch.empty(0, dtype=DTYPES[meta["dtype"]]))
        out[name] = t.reshape(meta["shape"])
    return out
