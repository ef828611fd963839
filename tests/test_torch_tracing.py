"""The port's spans and counters (``mrisr_torch/utils/profiling.py``) and where the program opens them.

On the CPU: spans in a ``torch.profiler`` trace (name, parent), the counters
(with the kernels' launch counts, and a kernel build's seconds), a capture's
counts, the eager chain's and an eager training step's stages, the loader's
counts, and stage events over a stand-in event class and graph (a CUDA
capture runs only on the card).
"""
from __future__ import annotations

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mrisr_torch import _build
from mrisr_torch.data.loader import Loader
from mrisr_torch.diffusion.schedules import resdiff_schedule
from mrisr_torch.models.resdiff_unet import ResDiffUNet
from mrisr_torch.models.simple_cnn import SimpleCNN
from mrisr_torch.ops import flash_attention
from mrisr_torch.pipelines.resdiff import ResDiffPipeline
from mrisr_torch.train.state import create_train_state, make_optimizer
from mrisr_torch.train.steps import make_cnn_train_step
from mrisr_torch.utils import profiling
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

TINY = dict(image_size=32, inner_channel=8, norm_groups=4)


def _spans(prof, prefix: str) -> list:
    """The profiler's function events whose name starts with ``prefix``, by start time."""
    return sorted((e for e in prof.events() if e.name.startswith(prefix)), key=lambda e: e.time_range.start)


def _ancestors(event) -> list[str]:
    names = []
    while event.cpu_parent is not None:
        event = event.cpu_parent
        names.append(event.name)
    return names


def test_a_span_shows_in_a_trace_with_its_parent():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(3).add_(1)
    outer, inner = _spans(prof, "outer")[0], _spans(prof, "inner")[0]
    assert inner.cpu_parent is outer and outer.cpu_parent is None
    assert "aten::add_" in [c.name for c in inner.cpu_children]
    # Without the profiler a span only runs its block.
    with profiling.span("quiet"):
        x = torch.ones(2) * 2
    assert torch.equal(x, torch.full((2,), 2.0))


def test_counters_count_snapshot_and_show_the_launch_counts(monkeypatch):
    assert profiling.counter("a.never") == 0 and "a.never" not in profiling.counters()
    before = profiling.counters()
    profiling.count("a.calls")
    profiling.count("a.calls", 2)
    profiling.count("a.seconds", 0.25)
    snap = profiling.counters()
    assert snap["a.calls"] - before.get("a.calls", 0) == 3
    assert snap["a.seconds"] - before.get("a.seconds", 0) == 0.25
    assert profiling.counter("a.calls") == snap["a.calls"]
    assert {k for k in snap if k.startswith("launches.")} == {
        "launches.flash_attention_fwd", "launches.flash_attention_bwd_dq", "launches.flash_attention_bwd_dkv",
        "launches.group_norm_silu"}
    launched = snap["launches.flash_attention_fwd"]
    monkeypatch.setattr(flash_attention.flash_attention_fwd, "launches", launched + 2)
    assert profiling.counters()["launches.flash_attention_fwd"] == launched + 2
    profiling.count("a.calls")
    assert snap["a.calls"] - before.get("a.calls", 0) == 3  # a snapshot does not follow the counters


def test_counters_lose_no_update_across_threads():
    """More threads than cores adding to one counter, with a short switch interval: every addition counted."""
    threads, adds = 16, 2000
    before = profiling.counters().get("stress.adds", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [profiling.count("stress.adds") for _ in range(adds)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert profiling.counters()["stress.adds"] - before == threads * adds


def test_a_kernel_build_counts_its_seconds_once(tmp_path, monkeypatch):
    """``build_libraries`` counts the host seconds of the builds it runs (``build.nvcc_s``), which a capture
    leaves out of its own; a library already built counts nothing.  A stand-in ``nvcc`` writes the library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\nsleep 0.05\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    before = profiling.counter("build.nvcc_s")
    _build.build_libraries(("flash_attn_fwd", "group_norm_silu"), "cpu")
    built = profiling.counter("build.nvcc_s") - before
    assert (_build.build_dir() / "libflash_attn_fwd.so").exists() and 0.05 <= built < 30
    _build.build_libraries(("flash_attn_fwd",), "cpu")
    assert profiling.counter("build.nvcc_s") - before == built


def test_a_capture_counts_itself_and_leaves_out_a_kernel_build(monkeypatch):
    """``profiling.capture``: one capture counted, its seconds closed by one synchronisation of its device,
    less the seconds a kernel build inside it counted (``build.nvcc_s``)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    before = profiling.counters()
    t0 = time.perf_counter()
    with profiling.capture("test.owner", "cuda:0"):
        time.sleep(0.05)
        profiling.count("build.nvcc_s", 0.03)
    outside = time.perf_counter() - t0
    since = {k: v - before.get(k, 0) for k, v in profiling.counters().items()}
    assert synced == ["cuda:0"] and since["test.owner.captures"] == 1
    assert 0.05 - 0.03 <= since["test.owner.capture_s"] <= outside - 0.03


def test_eager_chain_spans_its_four_stages_with_every_unet_call_inside_steps():
    torch.manual_seed(0)
    pipe = ResDiffPipeline(SimpleCNN(device="cpu"), ResDiffUNet(**TINY, device="cpu"), resdiff_schedule(1000),
                           device="cpu")
    forward = pipe.unet.forward

    def counted(*args, **kw):
        with profiling.span("test.unet"):
            return forward(*args, **kw)

    pipe.unet.forward = counted
    lr = torch.rand(2, 32, 32, 1) * 2 - 1
    num_steps = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pipe.super_resolve(lr, torch.Generator().manual_seed(1), num_steps=num_steps)
    assert out.shape == (2, 32, 32, 1) and not pipe.graphs
    stages = _spans(prof, "resdiff.")
    assert [e.name for e in stages] == ["resdiff.stage1", "resdiff.static", "resdiff.steps", "resdiff.combine"]
    ends = [e.time_range.end for e in stages]
    starts = [e.time_range.start for e in stages]
    assert all(e <= s for e, s in zip(ends, starts[1:]))
    calls = _spans(prof, "test.unet")
    assert len(calls) == num_steps and all("resdiff.steps" in _ancestors(c) for c in calls)


def test_eager_training_step_spans_forward_backward_and_update():
    torch.manual_seed(0)
    cnn = SimpleCNN(device="cpu")
    state = create_train_state(cnn, make_optimizer(1e-4), device="cpu")
    step = make_cnn_train_step(cnn, device="cpu")
    batch = {"lr": torch.rand(2, 16, 16, 1), "hr": torch.rand(2, 16, 16, 1)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        new, metrics = step(state, batch)
    assert new.step == state.step + 1 and torch.isfinite(metrics["loss"])
    assert [e.name for e in _spans(prof, "train.")] == ["train.forward", "train.backward", "train.update"]


class _SlowItems:
    """``n`` items of which each takes ``seconds`` to make."""

    def __init__(self, n: int, seconds: float):
        self.n, self.seconds = n, seconds

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.seconds)
        return {"x": torch.full((2,), float(i)).numpy()}


@pytest.mark.parametrize("consumer_sleep, starved", [(0.0, "all"), (1.0, "first")])
def test_loader_counts_batches_made_waits_and_starved_waits(consumer_sleep, starved):
    """A consumer faster than the thread finds the queue empty at every wait; one far slower only at its
    first, before the thread has made anything."""
    batches, per_batch = 4, 2
    loader = Loader(_SlowItems(batches * per_batch, 0.1), batch_size=per_batch, prefetch=2)
    before = profiling.counters()
    got = []
    for batch in loader:
        got.append(batch["x"][:, 0].tolist())
        time.sleep(consumer_sleep)
    since = {k: v - before.get(k, 0) for k, v in profiling.counters().items()}
    assert got == [[2.0 * i, 2.0 * i + 1] for i in range(batches)]
    assert since["loader.made"] == batches and since["loader.waits"] == batches
    assert since["loader.make_s"] >= batches * per_batch * 0.1 and since["loader.wait_s"] > 0
    assert since["loader.starved"] == (batches if starved == "all" else 1)


class _Event:
    """A stand-in for a timing CUDA event: ``record`` notes the test's clock."""

    clock = 0.0
    synced = 0

    def record(self):
        self.at = _Event.clock

    def synchronize(self):
        _Event.synced += 1

    def elapsed_time(self, end):
        return end.at - self.at


class _Graph:
    """A stand-in for a captured graph: a replay records the capture's events again, each stage taking its
    duration in ``durations``."""

    def __init__(self, rec, durations):
        self.rec, self.durations = rec, durations

    def replay(self):
        for (name, start, end), ms in zip(self.rec.pairs, self.durations):
            start.record()
            _Event.clock += ms
            end.record()


def _replay(rec, durations):
    """``profiling.replay`` of a stand-in graph whose capture recorded ``rec``; checks the replay is counted."""
    before = profiling.counter("test.replays")
    profiling.replay("test", _Graph(rec, durations), rec)
    assert profiling.counter("test.replays") == before + 1


def test_stage_events_record_inside_stages_only_and_read_the_last_replay(monkeypatch):
    monkeypatch.setattr(profiling, "_event", _Event)
    with profiling.span("outside"):
        pass

    class Owner:
        pass

    def elsewhere():
        with profiling.span("elsewhere"):
            other.append(True)

    owner = Owner()
    other = []
    with profiling.stages("test.graph") as owner.stages:
        with profiling.span("a"):
            pass
        with profiling.span("b"):
            pass
        with profiling.span("a"):
            pass
        # A span on another thread (a loader's, say) is no stage of this capture.
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join(timeout=10)
    with profiling.span("after"):
        pass
    assert [name for name, _, _ in owner.stages.pairs] == ["a", "b", "a"] and other == [True]
    assert profiling.stage_ms("test.graph") == {}  # captured, not yet replayed
    _replay(owner.stages, [1.0, 2.0, 3.0])
    _replay(owner.stages, [10.0, 20.0, 30.0])
    synced = _Event.synced
    assert profiling.stage_ms("test.graph") == {"a": 40.0, "b": 20.0}
    assert _Event.synced == synced + 1
    del owner
    assert profiling.stage_ms("test.graph") == {"a": 40.0, "b": 20.0}
    assert profiling.stage_ms("test.no_such_graph") == {}


def test_stage_ms_reads_the_capture_replayed_last(monkeypatch):
    """Two captures under one name (two batch shapes): the one replayed last is read."""
    monkeypatch.setattr(profiling, "_event", _Event)
    recs = []
    for _ in range(2):
        with profiling.stages("test.two") as rec:
            with profiling.span("s"):
                pass
        recs.append(rec)
    _replay(recs[1], [5.0])
    _replay(recs[0], [7.0])
    assert profiling.stage_ms("test.two") == {"s": 7.0}
    _replay(recs[1], [9.0])
    assert profiling.stage_ms("test.two") == {"s": 9.0}
