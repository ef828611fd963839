"""``.safetensors`` reader and writer, and torch checkpoint loading (port of ``mrisr_tpu/data/safetensors_io.py``).

The format is public and simple:

    [8-byte little-endian header length N][N bytes JSON header][raw data]

where the JSON maps tensor names to ``{"dtype", "shape", "data_offsets"}``
(offsets from the start of the data section) plus an optional
``__metadata__`` entry.  The reader maps the file and gives numpy arrays;
BF16 tensors are widened exactly to float32 (their bits shifted into the high
half).  The writer gives the reference writer's bytes: the same compact JSON
header, tensors in sorted name order, any dtype it does not name written as
float32.
"""
from __future__ import annotations

import json
import mmap
from pathlib import Path

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}
_INV_DTYPES = {np.dtype(t): name for name, t in _DTYPES.items()}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32 (shifted into the high half)."""
    return (raw.astype(np.uint32) << 16).view(np.float32)


def load_safetensors(path: str | Path, upcast_bf16: bool = True) -> dict:
    """Every tensor of the file as ``{name: np.ndarray}`` (BF16 as float32, or its raw uint16 bits)."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len).decode("utf-8"))
        data_start = 8 + header_len
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    out: dict = {}
    try:
        for name, spec in header.items():
            if name == "__metadata__":
                continue
            begin, end = spec["data_offsets"]
            buf = mm[data_start + begin : data_start + end]
            shape = tuple(spec["shape"])
            st_dtype = spec["dtype"]
            if st_dtype == "BF16":
                raw = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
                out[name] = _bf16_to_f32(raw) if upcast_bf16 else raw
                continue
            np_dtype = _DTYPES.get(st_dtype)
            if np_dtype is None:
                raise ValueError(f"unsupported safetensors dtype {st_dtype!r} for {name}")
            out[name] = np.frombuffer(buf, dtype=np_dtype).reshape(shape).copy()
    finally:
        mm.close()
    return out


def save_safetensors(path: str | Path, tensors: dict, metadata: dict | None = None) -> None:
    """Write ``{name: np.ndarray}``; a dtype the format table lacks is written as float32."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    offset = 0
    arrays = []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in _INV_DTYPES:
            arr = arr.astype(np.float32)
        header[name] = {"dtype": _INV_DTYPES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for arr in arrays:
            f.write(memoryview(arr.reshape(-1)).cast("B"))


def load_torch_state_dict(path: str | Path) -> dict:
    """A torch ``.bin`` / ``.pt`` checkpoint (``weights_only``) as float32 numpy arrays."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.float().numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}


def load_state_dict_any(path: str | Path) -> dict:
    """``.safetensors`` by the reader above, anything else as a torch checkpoint."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return load_safetensors(path)
    return load_torch_state_dict(path)
