"""Profiling, timing, spans and counters (port of ``mrisr_tpu/utils/profiling.py``, and the port's tracing).

* :func:`trace`: a ``torch.profiler`` trace (CPU and, on a card, CUDA
  activity) exported as a Chrome trace under ``log_dir``;
* :func:`timed`: seconds per call after warm-up calls, fenced by CUDA events
  when the result lies on a card (the host clock otherwise);
* :func:`span`: a named host range in the profiler's trace, and, inside a
  :func:`stages` recording, a pair of CUDA events around the range's device
  work; :func:`stage_ms` reads a captured graph's pairs after a replay;
* :func:`capture` and :func:`replay`: a CUDA-graph owner's capture and
  replay, counted;
* :func:`count`, :func:`counter`, :func:`counters`: the program's counters,
  one dict for the process, with the kernels' launch counts.

A span opens the profiler's fast record function, which is a host range only:
``torch.profiler.record_function`` also puts a range on the device's timeline
(CUPTI's user annotation), which around a graph replay would fill the
replay's idle gaps in a trace reader's union of device events.  With the
profiler off a span costs that record function's enter and exit.

Stage events.  ``stages(graph_name)`` is opened around a CUDA-graph capture,
and only there: each span entered on that thread meanwhile records a start
and an end event with ``external=True``, which a capture turns into
event-record nodes that every replay records again.  :func:`replay` replays
the graph and makes its recording the one ``stage_ms(graph_name)`` reads:
each span's device milliseconds in the last replay, waiting for that
replay's last event.  The events outlive the graph, so the numbers can be
read after the owner is released.
"""
from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

import torch
from torch._C._profiler import _RecordFunctionFast

_counts: dict[str, float] = {}
_counts_lock = threading.Lock()
_local = threading.local()  # .stages: the recording open on this thread
_replayed: dict[str, "Stages"] = {}  # graph name -> the recording of its last replay


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


# ---- spans and stage events ----

def _event():
    """A timing event that a capture records as an event-record node."""
    return torch.cuda.Event(enable_timing=True, external=True)


class Stages:
    """The event pairs one capture of graph ``graph_name`` recorded: ``(span name, start, end)``, in the order
    the spans closed."""

    def __init__(self, graph_name: str):
        self.graph_name = graph_name
        self.pairs: list[tuple[str, object, object]] = []


@contextlib.contextmanager
def span(name: str):
    """A host range named ``name``; inside :func:`stages`, also a start and an end event on the current
    stream."""
    with _RecordFunctionFast(name):
        rec = getattr(_local, "stages", None)
        if rec is None:
            yield
            return
        start = _event()
        start.record()
        yield
        end = _event()
        end.record()
        rec.pairs.append((name, start, end))


@contextlib.contextmanager
def stages(graph_name: str):
    """Record the spans of this thread as event pairs while the block runs (around a capture only); yields
    the :class:`Stages`."""
    rec = _local.stages = Stages(graph_name)
    try:
        yield rec
    finally:
        _local.stages = None


def stage_ms(graph_name: str) -> dict[str, float]:
    """``{span name: device ms}`` of graph ``graph_name``'s last replay (spans of one name summed), waiting
    for that replay's last event; ``{}`` before a replay or where the capture recorded no span."""
    rec = _replayed.get(graph_name)
    if rec is None or not rec.pairs:
        return {}
    rec.pairs[-1][2].synchronize()
    out: dict[str, float] = {}
    for name, start, end in rec.pairs:
        out[name] = out.get(name, 0.0) + start.elapsed_time(end)
    return out


# ---- graph captures and replays ----

@contextlib.contextmanager
def capture(name: str, device):
    """Count a CUDA-graph capture by the owner ``name`` (its eager warm-up, the capture and the instantiation
    in the block): ``<name>.captures``, and ``<name>.capture_s``, the block's host seconds closed by a
    synchronisation of ``device``, less those of any kernel build it set off (``build.nvcc_s``), which is no
    work of the capture."""
    t0, built = time.perf_counter(), counter("build.nvcc_s")
    yield
    torch.cuda.synchronize(device)
    count(f"{name}.captures")
    count(f"{name}.capture_s", time.perf_counter() - t0 - (counter("build.nvcc_s") - built))


def replay(name: str, graph, stages: Stages) -> None:
    """Replay ``graph``, whose capture recorded ``stages``, make that the recording ``stage_ms`` reads, and
    count ``<name>.replays``."""
    graph.replay()
    _replayed[stages.graph_name] = stages
    count(f"{name}.replays")


# ---- counters ----

def count(name: str, value: float = 1) -> None:
    """Add ``value`` to counter ``name`` (any thread)."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + value


def counter(name: str) -> float:
    """Counter ``name`` (0 before its first count)."""
    with _counts_lock:
        return _counts.get(name, 0)


def counters() -> dict[str, float]:
    """A snapshot of every counter, with the kernels' launch counts (``ops.launch_counts``) as
    ``launches.<wrapper>``."""
    from mrisr_torch.ops import launch_counts

    with _counts_lock:
        snap = dict(_counts)
    snap.update({f"launches.{k}": v for k, v in launch_counts().items()})
    return snap

