"""ctypes binding of the native slice cache ``native/slicecache.cpp`` (port of ``mrisr_tpu/data/slicecache.py``).

Paired slices stored uncompressed in one mmap'd file, with a multithreaded
batch gather: the training loop's data path without per-slice ``.npz``
decompression.  The file format is the C library's, so a cache written by
either package is read by the other.  The port builds the C++ source with
``g++`` at first use into ``mrisr_torch/.build/slicecache-<hash>/`` (keyed
on the source and flags) and loads nothing built elsewhere.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "slicecache.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / ".build"
_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_ROOT / f"slicecache-{digest}" / "libslicecache.so"


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)], check=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.sc_create.restype = ctypes.c_void_p
    lib.sc_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32]
    lib.sc_open.restype = ctypes.c_void_p
    lib.sc_open.argtypes = [ctypes.c_char_p]
    lib.sc_num_slices.restype = ctypes.c_uint64
    lib.sc_num_slices.argtypes = [ctypes.c_void_p]
    lib.sc_height.restype = ctypes.c_uint32
    lib.sc_height.argtypes = [ctypes.c_void_p]
    lib.sc_width.restype = ctypes.c_uint32
    lib.sc_width.argtypes = [ctypes.c_void_p]
    lib.sc_write.restype = ctypes.c_int
    lib.sc_write.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                             ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.sc_get_batch.restype = ctypes.c_int
    lib.sc_get_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
                                 ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_uint32]
    lib.sc_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class SliceCache:
    """Writer and reader of the mmap'd paired-slice cache."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        self.n = int(lib.sc_num_slices(handle))
        self.height = int(lib.sc_height(handle))
        self.width = int(lib.sc_width(handle))

    @classmethod
    def create(cls, path: str | Path, n: int, h: int, w: int) -> "SliceCache":
        lib = _load_lib()
        handle = lib.sc_create(str(path).encode(), n, h, w)
        if not handle:
            raise OSError(f"sc_create failed for {path}")
        return cls(handle, lib)

    @classmethod
    def open(cls, path: str | Path) -> "SliceCache":
        lib = _load_lib()
        handle = lib.sc_open(str(path).encode())
        if not handle:
            raise OSError(f"sc_open failed for {path} (missing or corrupt)")
        return cls(handle, lib)

    def write(self, idx: int, lr: np.ndarray, hr: np.ndarray):
        lr = np.ascontiguousarray(lr, np.float32)
        hr = np.ascontiguousarray(hr, np.float32)
        if not lr.shape == hr.shape == (self.height, self.width):
            raise ValueError(f"slices must be {(self.height, self.width)}, got {lr.shape} and {hr.shape}")
        rc = self._lib.sc_write(self._h, idx, _fptr(lr), _fptr(hr))
        if rc != 0:
            raise IndexError(f"sc_write({idx}) -> {rc}")

    def get_batch(self, indices, threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """``(lr, hr)``, each ``[len(indices), H, W]`` float32; ``threads=0`` uses every core."""
        idx = np.ascontiguousarray(indices, np.uint64)
        b = len(idx)
        out_lr = np.empty((b, self.height, self.width), np.float32)
        out_hr = np.empty((b, self.height, self.width), np.float32)
        rc = self._lib.sc_get_batch(self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), b,
                                    _fptr(out_lr), _fptr(out_hr), threads)
        if rc != 0:
            raise IndexError(f"sc_get_batch -> {rc}")
        return out_lr, out_hr

    def close(self):
        if self._h:
            self._lib.sc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SliceCacheDataset:
    """A dataset over a :class:`SliceCache`: NHWC ``{lr, hr}`` items and a vectorised ``get_batch``."""

    def __init__(self, path: str | Path):
        self.cache = SliceCache.open(path)

    def __len__(self):
        return self.cache.n

    def __getitem__(self, idx: int) -> dict:
        lr, hr = self.cache.get_batch([idx], threads=1)
        return {"lr": lr[0][..., None], "hr": hr[0][..., None]}

    def get_batch(self, indices) -> dict:
        lr, hr = self.cache.get_batch(indices)
        return {"lr": lr[..., None], "hr": hr[..., None]}


def build_cache_from_dataset(dataset, path: str | Path) -> SliceCache:
    """Write every ``{lr, hr}`` item of ``dataset`` into a new cache file at ``path``."""
    first = dataset[0]
    h, w = first["hr"].shape[:2]
    cache = SliceCache.create(path, len(dataset), h, w)
    for i in range(len(dataset)):
        item = dataset[i]
        cache.write(i, item["lr"][..., 0], item["hr"][..., 0])
    return cache
