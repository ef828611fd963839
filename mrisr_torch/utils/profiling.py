"""Profiling and timing (port of ``mrisr_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` trace (CPU and, on a card, CUDA
  activity) exported as a Chrome trace under ``log_dir``;
* :func:`timed`: seconds per call after warm-up calls, fenced by CUDA events
  when the result lies on a card (the host clock otherwise);
* :func:`throughput`: items per second per device of a batched call.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _cuda_device(out) -> torch.device | None:
    return next((t.device for t in _tensors(out) if t.is_cuda), None)


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block; writes ``trace.json`` (Chrome / Perfetto format) under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def timed(fn, *args, warmup: int = 1, repeats: int = 3, **kw):
    """``(result, seconds per call)`` over ``repeats`` calls after ``warmup`` calls."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    dev = _cuda_device(out)
    if dev is None:
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn(*args, **kw)
        return out, (time.perf_counter() - t0) / repeats
    with torch.cuda.device(dev):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(repeats):
            out = fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3 / repeats


def throughput(fn, batch_size: int, *args, **kw) -> float:
    """Items per second per device (all visible cards, or the CPU) for a batched call."""
    _, sec = timed(fn, *args, **kw)
    return batch_size / sec / max(torch.cuda.device_count(), 1)
