"""Readings of a cell's compared numbers over many seeds in one process: where its limits come from.

    python3 -m perfbench.readings --workload resdiff-exact-serve --seeds 1-12
    python3 -m perfbench.readings --workload resdiff-exact-serve --seeds 1-3 --control
    python3 -m perfbench.readings --workload resdiff-exact-serve --seeds 1-3 --options '{"conv_int8": true}'

The cell's program is set up once; each seed then writes its own weights and
inputs in place, serves the cell's check sample of requests through the same
timed entry, and is compared with the reference as a run compares it.
``--control`` answers the sample with the configuration's ``control`` (the
reference one precision below, in the program's place) instead of the
program; ``--options`` switches a path of the program on (training's
control: the program's own lower-precision path); ``--fault`` plants a fault
of ``faults.py``.  One JSON line a seed, on standard output.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

from perfbench.faults import FAULTS


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi) + 1) if hi else [int(lo)])
    return out


def readings(workload: str, seed_list: list[int], device: str = "cuda", options=None, config_overrides=None,
             traffic_overrides=None, control: bool = False):
    """Yield ``{"seed", "numbers", "limits"}`` for each seed of ``seed_list``."""
    import torch

    from perfbench import run

    cell = run.find_cell(workload, config_overrides, traffic_overrides)
    system = None
    for seed in seed_list:
        if system is not None and hasattr(system, "reseed"):
            system.reseed(seed)  # a serving program: weights and inputs rewritten in place
        else:  # a training program runs its checked steps in set-up
            if system is not None:
                system.release()
            system = cell.system_cls(cell.config, cell.traffic, seed, device, options)
            run.set_precision(torch, run.program_precision(system, options))
            system.setup()
        run.set_precision(torch, run.program_precision(system, options))
        reqs = [system.request(i) for i in range(cell.traffic["check_requests"])]
        if control:
            run.set_precision(torch, {})
            samples = system.control(reqs)
        else:
            samples = [(r, system.serve(r)) for r in reqs]
        run.set_precision(torch, {})
        yield {"seed": seed, "numbers": system.check(samples), "limits": cell.spec["limits"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 5,9,200")
    ap.add_argument("--options", default="{}", help="JSON of program options, e.g. the control's")
    ap.add_argument("--control", action="store_true", help="the configuration's control in the program's place")
    ap.add_argument("--fault", choices=sorted(FAULTS), help="a fault planted in the program (faults.py)")
    args = ap.parse_args(argv)
    with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
        for row in readings(args.workload, seeds(args.seeds), options=json.loads(args.options), control=args.control):
            row.update(options=json.loads(args.options), fault=args.fault, control=args.control)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
