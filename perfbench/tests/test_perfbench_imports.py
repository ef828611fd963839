"""Nothing the benchmark runs loads JAX or the JAX package, and the references take nothing from the port."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mrisr_tpu"}


def imported_top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        assert "mrisr_torch" not in imported_top_names(path), path


def test_names_are_compared_whole():
    """The port's name begins with the JAX package's; a top-level name is compared whole, not by prefix."""
    sys.path.insert(0, str(ROOT))
    try:
        from perfbench import run
    finally:
        sys.path.remove(str(ROOT))
    assert "mrisr_torch" not in run.FORBIDDEN and "mrisr_tpu" in run.FORBIDDEN


def test_a_loaded_cell_holds_no_jax_module():
    """In a fresh process: every cell, its configuration's program and reference (its work counted on the meta
    device), every metric reader, and the port's modules the cells run, loaded; then ``sys.modules`` holds none
    of the forbidden top-level names."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench import run, loops, trace, readings
bench = json.load(open({str(ROOT / "BENCHMARK.json")!r}))
for w in bench["workloads"]:
    cell = run.find_cell(w["name"])
    cell.system_cls(cell.config, cell.traffic, 1, "cpu").work()
for m in bench["end_to_end"] + bench["per_layer"]:
    run.load_module(run.HERE / "metrics" / (m["name"] + ".py"))
import mrisr_torch.pipelines.resdiff, mrisr_torch.train.steps, mrisr_torch.data.loader
import mrisr_torch.data.slicecache
print(json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT,
                         timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
