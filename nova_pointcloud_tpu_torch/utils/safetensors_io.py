"""Read and write ``*.safetensors`` files without the safetensors package.

The format: an 8-byte little-endian header length, a JSON header naming
each tensor's dtype, shape and byte range (``data_offsets``, relative to
the end of the header; an optional ``__metadata__`` entry), then the raw
little-endian bytes. The card's installation has no safetensors package,
so ``pipelines/pretrained.py`` reads checkpoints with :func:`load_file`.
"""

import json
import struct
from typing import Dict

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_CODES = {v: k for k, v in DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU, as stored."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        start, end = info["data_offsets"]
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(data, dtype=torch.uint8, count=end - start, offset=start)
        if flat.data_ptr() % flat.new_empty((), dtype=dtype).element_size():
            flat = flat.clone()  # a range off its dtype's alignment
        out[name] = flat.view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device; stored contiguous, as they are) to
    ``path``; the header is padded with spaces to a multiple of 8 bytes."""
    header, parts, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8)
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + raw.numel()]}
        parts.append(raw)
        offset += raw.numel()
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in parts:
            f.write(raw.numpy().data)
