"""The readers of the metrics the program's own spans and counters give (``mrisr_torch/utils/profiling.py``), on a
synthetic trace and stand-in counters and stage times; and ``None``, never an error, from a program that lacks
them."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from mrisr_torch.utils import profiling
from perfbench import run as bench_run
from perfbench.trace import Trace

PROGRAM_METRICS = ("unet_step_ms.serve", "replay_idle_ms.serve", "capture_s.serve", "capture_s.train",
                   "step_backward_ms.train", "loader_make_ms.train")


def reader(name: str):
    return bench_run.load_module(bench_run.HERE / "metrics" / f"{name}.py")


def a_run(trace=None, num_steps=50):
    cell = SimpleNamespace(config={"num_steps": num_steps})
    return bench_run.Run(cell, 1.0, [], {}, trace, 0 if trace is None else 3)


def test_each_program_metric_is_declared_for_the_cells_that_feed_it():
    import json

    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    serve, train = ["resdiff-exact-serve", "resdiff-fast-serve"], ["resdiff-train"]
    for name in PROGRAM_METRICS:
        assert declared[name]["workloads"] == (serve if name.endswith(".serve") else train)
        assert hasattr(reader(name), "read")


def test_unet_step_ms_is_the_steps_stage_over_the_steps(monkeypatch):
    monkeypatch.setattr(profiling, "stage_ms", lambda graph: {"resdiff.stage1": 1.0, "resdiff.steps": 340.0}
                        if graph == "resdiff.chain" else {})
    assert reader("unet_step_ms.serve").read(a_run(num_steps=50)) == pytest.approx(6.8)
    monkeypatch.setattr(profiling, "stage_ms", lambda graph: {})
    assert reader("unet_step_ms.serve").read(a_run()) is None


def test_step_backward_ms_is_the_backward_stage(monkeypatch):
    monkeypatch.setattr(profiling, "stage_ms", lambda graph: {"train.forward": 15.0, "train.backward": 33.5}
                        if graph == "train_step" else {})
    assert reader("step_backward_ms.train").read(a_run()) == 33.5
    monkeypatch.setattr(profiling, "stage_ms", lambda graph: {})
    assert reader("step_backward_ms.train").read(a_run()) is None


def test_replay_idle_ms_is_each_replay_span_less_the_device_busy_inside_it():
    ms = 1_000_000  # ns
    device = [("k1", 1 * ms, 4 * ms), ("k2", 5 * ms, 9 * ms), ("k3", 9 * ms, 12 * ms),  # replay 1: 10 ms, 2 idle
              ("k4", 20 * ms, 30 * ms)]  # replay 2: 10 ms whole, idle 0; the harness's gap 12-20 lies outside
    host = [("resdiff.replay", 0, 10 * ms), ("aten::select", 12 * ms, 13 * ms), ("resdiff.replay", 20 * ms, 30 * ms)]
    value = reader("replay_idle_ms.serve").read(a_run(Trace(device, host, 0.03)))
    assert value == pytest.approx((2.0 + 0.0) / 2)


def test_replay_idle_ms_is_none_without_replay_spans_or_trace():
    trace = Trace([("k", 0, 10)], [("cudaGraphLaunch", 0, 5)], 1e-8)
    assert reader("replay_idle_ms.serve").read(a_run(trace)) is None
    assert reader("replay_idle_ms.serve").read(a_run()) is None


@pytest.mark.parametrize("name, prefix", [("capture_s.serve", "resdiff"), ("capture_s.train", "train_step")])
def test_capture_s_reads_one_capture_only(monkeypatch, name, prefix):
    counts = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert reader(name).read(a_run()) is None
    counts.update({f"{prefix}.captures": 1, f"{prefix}.capture_s": 3.25})
    assert reader(name).read(a_run()) == 3.25
    counts.update({f"{prefix}.captures": 2, f"{prefix}.capture_s": 6.5})
    assert reader(name).read(a_run()) is None


def test_loader_make_ms_is_the_mean_make_time(monkeypatch):
    counts = {"loader.made": 4, "loader.make_s": 0.01}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert reader("loader_make_ms.train").read(a_run()) == pytest.approx(2.5)
    counts["loader.made"] = 0
    assert reader("loader_make_ms.train").read(a_run()) is None


@pytest.mark.parametrize("name", [m for m in PROGRAM_METRICS if m != "replay_idle_ms.serve"])
def test_a_program_without_the_spans_and_counters_reads_none(monkeypatch, name):
    """The parent commit's ``profiling`` module has neither ``stage_ms`` nor ``counters``."""
    monkeypatch.delattr(profiling, "stage_ms")
    monkeypatch.delattr(profiling, "counters")
    assert reader(name).read(a_run(Trace([], [], 1.0))) is None
