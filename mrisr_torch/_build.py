"""Build the CUDA sources under ``csrc/`` at first use and load them with ctypes.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The build directory
is ``mrisr_torch/.build/<hash>/``, keyed on a hash of the sources and the
flags, so an edited source is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from mrisr_torch.device import resolve_device
from mrisr_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _source_digest()


def build_libraries(names: tuple[str, ...], device: str = "cuda") -> None:
    """Compile every ``csrc/<name>.cu`` that is not built yet, all at once.

    One ``nvcc`` process per source, started together.  The ptxas report
    (registers, shared memory, spills) is kept beside each library as
    ``<name>.log``.  The host seconds a build takes are counted as
    ``build.nvcc_s`` (``utils/profiling.py``), so a capture that triggers the
    first build of a library can leave them out of its own seconds.
    """
    resolve_device(device)
    out_dir = build_dir()
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append((name, tmp, proc))
    failed = []
    for name, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        (out_dir / f"{name}.log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{stderr[-4000:]}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    profiling.count("build.nvcc_s", time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))


def ptxas_report(name: str) -> list[str]:
    """The kernel names, register and spill lines of ``<name>.log``, and ptxas's performance-loss notes
    (a serialized wgmma pipeline shows there)."""
    log = (build_dir() / f"{name}.log").read_text()
    return [ln.strip() for ln in log.splitlines()
            if "Function properties for" in ln or "registers" in ln or "spill" in ln or "Performance Loss" in ln]


def load_library(name: str, device: str = "cuda") -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    resolve_device(device)
    lib = _LIBS.get(name)
    if lib is None:
        build_libraries((name,), device)
        lib = _LIBS[name] = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
    return lib
