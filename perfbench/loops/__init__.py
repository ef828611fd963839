"""The request generators, one module a loop kind, found by the name a traffic file gives under ``kind``.

``perfbench/loops/<kind>.py`` holds ``run(system, sync, seconds=None, count=None, first=0)``, which drives the
system until ``seconds`` have passed or ``count`` requests (or steps) are done and returns ``(records,
outputs)``: one ``stats.Request`` a request, and ``(request, output)`` pairs for the check.  A new kind is a
new file here; a traffic mix that uses a kind is a data file under ``traffic/``.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def kind(name: str):
    """The module of loop kind ``name``: ``perfbench/loops/<name>.py``."""
    module_name = f"perfbench.loops.{name.replace('-', '_')}"
    if module_name not in sys.modules:
        path = HERE / f"{name}.py"
        if not path.is_file():
            raise ValueError(f"no loop kind {name!r}: {path} does not exist")
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
    return sys.modules[module_name]


def run(traffic: dict, system, sync, **kw):
    """The loop ``traffic["kind"]`` names, with its ``clients`` (one client for now)."""
    if traffic.get("clients", 1) != 1:
        raise ValueError(f"the {traffic['kind']} loop runs one client, the traffic asks for {traffic['clients']}")
    return kind(traffic["kind"]).run(system, sync, **kw)
