"""One run of one benchmark cell of the PyTorch port, on the cards of the machine it starts on.

    python3 -m perfbench.run --workload resdiff-exact-serve --seed 7 --seconds 40 --trace 0

Run from the root of a checkout.  Everything is found by name: the cell in
``perfbench/workloads/<cell>.json``, its configuration in
``perfbench/configs/<config>.json`` with its program and reference in
``perfbench/configs/<config>.py``, its traffic in
``perfbench/traffic/<mix>.json`` with the loop kind that drives it in
``perfbench/loops/<kind>.py``, and each metric's reader in
``perfbench/metrics/<metric>.py``; ``BENCHMARK.json`` says which metrics a
cell reports.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics, read from a traced stretch of requests after the
window.  Either way the run checks what the window served against the plain
reference and prints each number compared beside its limit, last on standard
error and last in the result line.  The last line of standard output is the
result, one JSON object.

The run exits with 3 and prints no result when PyTorch sees no CUDA card or
fewer than the cell asks for, and with 4 when JAX, Flax, optax or the JAX
package has been loaded into the process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mrisr_tpu")
TRACE_TRIES = 3
TRACE_MISS = 0.01  # a trace may lack this share of a kernel's records and still be read
THREADS = 4  # host threads of PyTorch's CPU ops: one process, few threads, steady load


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    name = "perfbench._loaded." + path.stem.replace("-", "_").replace(".", "_") + "_" + path.parent.name
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    spec: dict
    config: dict
    traffic: dict
    system_cls: type
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, config_overrides=None, traffic_overrides=None) -> Cell:
    spec = load_json(HERE / "workloads" / f"{name}.json")
    config = {**load_json(HERE / "configs" / f"{spec['config']}.json"), **(config_overrides or {})}
    traffic = {**load_json(HERE / "traffic" / f"{spec['traffic']}.json"), **(traffic_overrides or {})}
    module = load_module(HERE / "configs" / f"{spec['config']}.py")
    bench = load_json(ROOT / "BENCHMARK.json")
    return Cell(name, spec, config, traffic, getattr(module, traffic.get("system", "System")),
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


@dataclass
class Run:
    """What a metric's reader may read."""

    cell: Cell
    setup_s: float
    records: list
    work: dict
    trace: object = None
    traced_requests: int = 0


def program_precision(system, options=None) -> dict:
    """The precision flags the program runs under: those the configuration states for the system
    (``system.precision``), with any ``options["precision"]`` (a control's) over them."""
    return {**system.precision, **(options or {}).get("precision", {})}


def set_precision(torch, precision: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(precision.get("matmul_allow_tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(precision.get("cudnn_allow_tf32", False))


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's power limit as nvidia-smi prints it (the peaks assume 700 W)."""
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
    return line.strip()


def traced_stretch(torch, cell: Cell, system, sync, work: dict, metric_modules: list, first: int):
    """A few requests after the window under the profiler, traced again (``TRACE_TRIES`` at most) while some
    kernel a reader counts has fewer records than its launches, less ``TRACE_MISS``."""
    from perfbench import loops
    from perfbench.trace import traced

    count = cell.traffic["trace_requests"]
    want = {}
    for m in metric_modules:
        if hasattr(m, "expected_launches"):
            pattern, per_request = m.expected_launches(work)
            want[pattern] = per_request * count
    shortfall = []
    for _ in range(TRACE_TRIES):
        _, trace = traced(lambda: loops.run(cell.traffic, system, sync, count=count, first=first), torch)
        seen = {p: trace.kernels(p)[0] for p in want}
        shortfall.append({p: n - seen[p] for p, n in want.items()})
        if all(seen[p] >= n * (1 - TRACE_MISS) for p, n in want.items()):
            break
    return trace, count, shortfall


def warm_up(cell: Cell, system, sync) -> int:
    """The traffic's own requests (or steps) for ``warmup_seconds`` after set-up, so that the window starts at the
    card's steady pace (on the H100 a freshly captured chain's replays ran 2 % slower for a stretch of 0 to 30
    seconds, with the same device time a request); the number of them."""
    from perfbench import loops

    sync()
    if not cell.traffic.get("warmup_seconds"):
        return 0
    records, _ = loops.run(cell.traffic, system, sync, seconds=cell.traffic["warmup_seconds"])
    return len(records)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", t_start: float | None = None,
             config_overrides=None, traffic_overrides=None, options=None):
    """One run of cell ``name``: ``(result, check_lines)``.  ``device="cpu"`` (the tests) runs the same code on
    the plain paths; it reads no trace and no device number."""
    import numpy as np
    import torch

    from perfbench import loops

    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(name, config_overrides, traffic_overrides)
    cuda = device.startswith("cuda")
    torch.set_num_threads(THREADS)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    system = cell.system_cls(cell.config, cell.traffic, seed, device, options)
    set_precision(torch, program_precision(system, options))
    system.setup()
    first = warm_up(cell, system, sync)
    setup_s = time.perf_counter() - t_start

    records, outputs = loops.run(cell.traffic, system, sync, seconds=seconds, first=first)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for r, (_, out) in zip(records, outputs):
        r.ok = system.finite(out)
    failed = sum(not r.ok for r in records)
    work = system.work()

    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py") for m in metrics}
    run = Run(cell, setup_s, records, work)
    shortfall = None
    if trace:
        run.trace, run.traced_requests, shortfall = traced_stretch(torch, cell, system, sync, work,
                                                                  list(readers.values()), first + len(records))

    # The check: a sample drawn from the seed of the requests the window finished, against the reference,
    # once the program's state is freed.
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 63), 7]))
    picks = sorted(rng.choice(len(outputs), size=min(cell.traffic["check_requests"], len(outputs)), replace=False))
    samples = [outputs[i] for i in picks]
    del outputs
    system.release()
    set_precision(torch, {})
    numbers = system.check(samples)
    limits = cell.spec["limits"]
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in limits)

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.spec["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    result = {"correct": bool(correct), "attempted": len(records), "failed": int(failed), "metrics": values,
              "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
        result["trace_shortfall"] = shortfall
    if cuda:
        result["power_limit"] = power_limit()
    result["seed"] = seed
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result["checks"]["failed_requests"] = {"value": int(failed), "limit": 0}
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in result["checks"].items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Build and kernel caches at fixed places inside the checkout (the port's nvcc builds go to
    # mrisr_torch/.build/, which its code fixes there).
    cache = ROOT / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    spec = load_json(HERE / "workloads" / f"{args.workload}.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"perfbench: the cell needs {spec['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    gc.collect()
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
