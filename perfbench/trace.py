"""A traced stretch of requests: the profiler's own events, reduced to what the per-layer readers need.

The tracer's records are read as ``kineto_results.events()`` (its Python
event tree takes far longer to build).  A first profiler step only starts
the tracer on one small op; the stretch is the second step, the only one
kept.  Device events (kernels, copies) give the busy time (their union), the
time by kernel name and the idle gaps; each gap is named by the innermost
host event running at its middle.  A replay of a captured CUDA graph shows
its kernels one by one.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass

NAME_CHARS = 120


def short(name: str) -> str:
    """A kernel's demangled name without its argument list, at most ``NAME_CHARS`` characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:NAME_CHARS]


@dataclass
class Trace:
    device: list  # (name, start_ns, end_ns) of every device event
    host: list  # (name, start_ns, end_ns) of every host event
    window_s: float  # host wall time of the traced stretch

    @property
    def busy_s(self) -> float:
        return sum(end - start for start, end in self.busy_intervals()) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        spans = sorted((s, e) for _, s, e in self.device)
        merged: list[list[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def kernels(self, pattern: str) -> tuple[int, float]:
        """(count, device seconds) of the device events whose name holds ``pattern``."""
        hits = [(e - s) for name, s, e in self.device if pattern in name]
        return len(hits), sum(hits) / 1e9

    def device_ops(self, top: int = 10) -> list[list]:
        by_name: dict[str, int] = {}
        for name, s, e in self.device:
            key = short(name)
            by_name[key] = by_name.get(key, 0) + (e - s)
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in rows]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The ``top`` longest gaps between device work, each named by what the host was doing at its middle."""
        busy = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]), reverse=True)
        out = []
        for length, s, e in gaps[:top]:
            mid = (s + e) // 2
            inside = [(hs, name) for name, hs, he in self.host if hs <= mid <= he]
            out.append([max(inside)[1][:NAME_CHARS] if inside else "host (no traced op)", length / 1e9])
        return out


def traced(run, torch):
    """Run ``run()`` under the profiler, synchronised: ``(result, Trace)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: kept.update(events=p.profiler.kineto_results.events())) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        prof.step()
    device, host = [], []
    for e in kept["events"]:
        if e.is_hidden_event():
            continue
        name = e.name()
        row = (name, e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("ProfilerStep"):
                device.append(row)
        elif not name.startswith("ProfilerStep"):
            host.append(row)
    return out, Trace(device, host, window_s)
