"""Reading and writing the safetensors format without the safetensors
package.

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``, with
an optional ``"__metadata__"`` of strings), then the tensors' raw
little-endian bytes, each at its offsets from the start of that buffer.
"""

import json
import struct
import sys

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32,
          "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
NAMES = {dtype: name for name, dtype in DTYPES.items()}


def _check_byte_order():
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors buffers are little-endian; "
                                  "this host is not")


def load_file(path):
    """{name: CPU tensor} of a safetensors file."""
    _check_byte_order()
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dtype = DTYPES[info["dtype"]]
        if end == begin:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        buf = bytearray(data[base + begin:base + end])
        out[name] = torch.frombuffer(buf, dtype=dtype).reshape(info["shape"])
    return out


def save_file(tensors, path):
    """Write {name: tensor} as one safetensors file, the buffers back to
    back in name order, the header padded with spaces to 8 bytes."""
    _check_byte_order()
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)
