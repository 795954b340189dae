"""`.yalm` checkpoint codec for the PyTorch port (pure Python, numpy + mmap).

The `.yalm` container is a safetensors file: a u64 little-endian header size,
a JSON header mapping tensor names to {dtype, shape, data_offsets} plus a
"__metadata__" dict of normalized config strings, followed by raw
little-endian tensor bytes. This is the port's copy of
`yalm_tpu/codec/format.py` without ml_dtypes: BF16 and the fp8 types are
read as raw uint16 / uint8 numpy views, and `YalmFile.torch` turns any
tensor into a torch tensor of its real type by reinterpreting those bits.
"""

from __future__ import annotations

import json
import mmap
import os
from dataclasses import dataclass, field

import numpy as np
import torch

# safetensors dtype tag -> (numpy storage dtype, torch dtype). BF16 and the
# fp8 types have no numpy type without ml_dtypes: numpy holds their raw bits.
_TAGS = {
    "F64": (np.dtype(np.float64), torch.float64),
    "F32": (np.dtype(np.float32), torch.float32),
    "F16": (np.dtype(np.float16), torch.float16),
    "BF16": (np.dtype(np.uint16), torch.bfloat16),
    "F8_E5M2": (np.dtype(np.uint8), torch.float8_e5m2),
    "F8_E4M3": (np.dtype(np.uint8), torch.float8_e4m3fn),
    "I64": (np.dtype(np.int64), torch.int64),
    "I32": (np.dtype(np.int32), torch.int32),
    "I16": (np.dtype(np.int16), torch.int16),
    "I8": (np.dtype(np.int8), torch.int8),
    "U8": (np.dtype(np.uint8), torch.uint8),
    "BOOL": (np.dtype(np.bool_), torch.bool),
}
_TORCH_TO_TAG = {tdt: tag for tag, (_, tdt) in _TAGS.items()}
# numpy dtypes that map to one tag unambiguously (uint16/uint8 raw bits are
# only written through torch tensors, which carry their real type)
_NP_TO_TAG = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
              np.dtype(np.float16): "F16", np.dtype(np.int64): "I64",
              np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
              np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8",
              np.dtype(np.bool_): "BOOL"}
# same-width integer types that the bits of each float type are viewed as
_BITS = {1: (np.uint8, torch.uint8), 2: (np.int16, torch.int16)}

# Short dtype names used in checkpoint metadata ("dtype" key).
DTYPE_STR_TO_TAG = {"fp32": "F32", "fp16": "F16", "bf16": "BF16", "fp8": "F8_E5M2",
                    "int8": "I8"}


def torch_dtype_for(tag: str) -> torch.dtype:
    return _TAGS[tag][1]


# numpy dtype names of ml_dtypes' types, recognised without importing it
_ML_DTYPE_TAGS = {"bfloat16": "BF16", "float8_e5m2": "F8_E5M2",
                  "float8_e4m3fn": "F8_E4M3"}


def tag_for_numpy(arr: np.ndarray) -> str:
    """The safetensors tag of a numpy array's type, including arrays of
    ml_dtypes' bf16/fp8 types (recognised by dtype name)."""
    if arr.dtype.name in _ML_DTYPE_TAGS:
        return _ML_DTYPE_TAGS[arr.dtype.name]
    if arr.dtype not in _NP_TO_TAG:
        raise ValueError(f"unsupported tensor dtype {arr.dtype}")
    return _NP_TO_TAG[arr.dtype]


def numpy_to_torch(arr: np.ndarray, tag: str) -> torch.Tensor:
    """A torch tensor of tag's type holding a COPY of arr's bits (arr may be
    a view into a checkpoint mmap, which torch.from_numpy would alias)."""
    np_dt, t_dt = _TAGS[tag]
    arr = np.ascontiguousarray(arr).view(np_dt)
    if t_dt in (torch.bfloat16, torch.float8_e5m2, torch.float8_e4m3fn):
        bits_np, bits_t = _BITS[arr.dtype.itemsize]
        return torch.from_numpy(arr.view(bits_np).copy()).view(bits_t).view(t_dt)
    return torch.from_numpy(arr.copy())


@dataclass
class YalmFile:
    """A parsed `.yalm` checkpoint: metadata plus zero-copy numpy views.

    `tensors` holds numpy views into the mapping (raw bits for BF16/fp8);
    `dtypes` the safetensors tag of each; `torch(name)` a copied torch
    tensor of the real type."""

    path: str
    metadata: dict[str, str]
    tensors: dict[str, np.ndarray]
    dtypes: dict[str, str]
    # Held to keep the mapping alive as long as tensor views exist.
    _mmap: mmap.mmap | None = field(default=None, repr=False)

    def torch(self, name: str) -> torch.Tensor:
        return numpy_to_torch(self.tensors[name], self.dtypes[name])

    def close(self) -> None:
        # Views into the map become invalid after close; callers copy what
        # they need first (`torch` copies). If live views still exist the
        # close is deferred to GC: mmap refuses to unmap exported buffers.
        self.tensors = {}
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                pass
            self._mmap = None


def read_yalm(path: str) -> YalmFile:
    """mmap a `.yalm`/safetensors file and return zero-copy numpy views."""
    size = os.path.getsize(path)
    if size < 8:
        raise ValueError(f"{path}: too small to be a .yalm file")
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    mapped.madvise(mmap.MADV_SEQUENTIAL)

    header_size = int.from_bytes(mapped[:8], "little")
    if header_size > size - 8:
        mapped.close()
        raise ValueError(f"{path}: bad header size {header_size}")
    header = json.loads(mapped[8 : 8 + header_size].decode("utf-8"))

    data_start = 8 + header_size
    buf = memoryview(mapped)[data_start:]

    metadata: dict[str, str] = {}
    tensors: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    for name, val in header.items():
        if name == "__metadata__":
            metadata = dict(val)
            continue
        tag = val["dtype"]
        if tag not in _TAGS:
            raise ValueError(f"{path}: tensor {name}: unsupported dtype {tag}")
        dtype = _TAGS[tag][0]
        shape = tuple(int(d) for d in val["shape"])
        start, end = val["data_offsets"]
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape else dtype.itemsize
        if end - start != nbytes:
            raise ValueError(f"{path}: tensor {name}: offsets {start}:{end} != {nbytes} bytes")
        tensors[name] = np.frombuffer(buf[start:end], dtype=dtype).reshape(shape)
        dtypes[name] = tag
    return YalmFile(path=path, metadata=metadata, tensors=tensors,
                    dtypes=dtypes, _mmap=mapped)


def _tag_and_bytes(arr) -> tuple[str, list[int], bytes]:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype not in _TORCH_TO_TAG:
            raise ValueError(f"unsupported tensor dtype {t.dtype}")
        tag = _TORCH_TO_TAG[t.dtype]
        if t.dtype in (torch.bfloat16, torch.float8_e5m2, torch.float8_e4m3fn):
            t = t.view(_BITS[t.element_size()][1])
        return tag, list(arr.shape), t.numpy().tobytes()
    a = np.ascontiguousarray(arr)
    if a.dtype not in _NP_TO_TAG:
        raise ValueError(f"unsupported tensor dtype {a.dtype}")
    return _NP_TO_TAG[a.dtype], list(a.shape), a.tobytes()


def write_yalm(path: str, tensors: dict, metadata: dict[str, str]) -> None:
    """Write a safetensors-format `.yalm` file.

    `tensors` values are numpy arrays of a plain numpy type, or torch
    tensors of any supported type (bf16 and fp8 go through torch). The
    header is padded with spaces so tensor data starts 8-byte aligned.
    """
    entries: dict[str, dict] = {"__metadata__": {k: str(v) for k, v in metadata.items()}}
    offset = 0
    blobs: list[bytes] = []
    for name, arr in tensors.items():
        tag, shape, data = _tag_and_bytes(arr)
        entries[name] = {"dtype": tag, "shape": shape,
                         "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)

    header = json.dumps(entries, separators=(",", ":")).encode("utf-8")
    pad = (-(8 + len(header))) % 8
    header += b" " * pad

    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for data in blobs:
            f.write(data)
