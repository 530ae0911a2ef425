"""A reader for ``.safetensors`` files, without the ``safetensors`` package.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor's name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(plus an optional ``"__metadata__"`` entry of strings), then the raw
little-endian bytes, the offsets counted from the end of the header.

It reads the dtypes that ``safetensors.numpy.load_file`` reads in the JAX
package's loader (``pcdms_tpu/compat/load.py``), where JAX's ``ml_dtypes``
gives numpy its bfloat16: the float, integer, bool and complex64 ones and
bf16. Any other (the fp8 formats, ...) raises ``ValueError`` naming it.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "I64": torch.int64, "U64": torch.uint64, "I32": torch.int32,
    "U32": torch.uint32, "I16": torch.int16, "U16": torch.uint16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "C64": torch.complex64, "BF16": torch.bfloat16,
}


def read_header(path) -> tuple:
    """(header dict without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} in each tensor's own dtype, as
    ``safetensors.torch.load_file`` returns it."""
    header, start = read_header(path)
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which this reader does not "
                             f"read (it reads {sorted(DTYPES)})")
    with open(path, "rb") as f:
        f.seek(start)
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} spans bytes "
                             f"[{begin}, {end}), which does not hold "
                             f"{shape} of {info['dtype']}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        if begin % dtype.itemsize == 0:      # a view of the file's bytes
            t = torch.frombuffer(data, dtype=dtype, count=numel,
                                 offset=begin)
        else:                                # copied to aligned memory
            t = torch.frombuffer(data, dtype=torch.uint8, count=end - begin,
                                 offset=begin).clone().view(dtype)
        out[name] = t.reshape(shape)
    return out
