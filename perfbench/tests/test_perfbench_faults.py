"""A whole run, the chip's look skipped, with the timed path broken underneath: ``correct`` comes out false.

On the CPU at tiny widths in float32 (so a sound run reads rounding only), through ``run.run_cell``: the
window, the sample drawn from the seed, the reference and the limits of the cell as committed, with each fault
of ``perfbench/faults.py`` that the cell can have.  The cells run on one card, so there is no exchange between
cards to leave out.
"""
from __future__ import annotations

import pytest

from perfbench import faults, run

SERVE = ["resdiff-exact-serve", "resdiff-fast-serve"]
FP32 = {"weights": "fp32", "activations": "fp32", "matmul_allow_tf32": False, "cudnn_allow_tf32": False}


def run_tiny(cell, tiny, seed=2**31 + 77):
    config, traffic = tiny
    if cell == "resdiff-train":
        traffic = {**traffic, "pairs": 8}
    result, lines = run.run_cell(cell, seed, 0.5, False, "cpu", config_overrides={**config, "precision": FP32},
                                 traffic_overrides=traffic)
    assert lines[-1].startswith("check failed_requests")
    return result


@pytest.mark.parametrize("cell", SERVE + ["resdiff-train"])
def test_a_sound_run_is_correct(cell, tiny):
    result = run_tiny(cell, tiny)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell, fault", [(c, f) for c in SERVE for f in ("step_unchanged", "half_batch_serve",
                                                                           "answer_altered")]
                         + [("resdiff-train", f) for f in ("state_unchanged", "half_batch_train", "ema_unchanged")])
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny):
    with faults.FAULTS[fault]():
        result = run_tiny(cell, tiny)
    assert not result["correct"], result["checks"]
