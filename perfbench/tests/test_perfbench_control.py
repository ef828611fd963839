"""The control of each cell, one precision below the configuration's, which the check must call not correct.

Serving (bf16): the plain reference put in the program's place with every product's operands in float8 e4m3
(``reference/lowp.py``).  Training (TF32 convolutions, fp32
products): the program's own bf16 policy.

On the card (``-m card``): at each cell's own size, three seeds, every control reading fails the cell's limits.
On the CPU: at tiny widths the control reads well above the sound program on the same seeds.
"""
from __future__ import annotations

import pytest

from perfbench import readings

SERVE = ["resdiff-exact-serve", "resdiff-fast-serve"]
# readings.readings' keyword arguments that put a cell's control in the program's place.
CONTROLS = {"resdiff-exact-serve": {"control": True}, "resdiff-fast-serve": {"control": True},
            "resdiff-train": {"options": {"policy": "bf16"}}}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_the_control_fails_the_check_at_the_cells_size(cell, cuda_card):
    for row in readings.readings(cell, [2**31 + 101, 102, 103], **CONTROLS[cell]):
        assert any(row["numbers"][k] > row["limits"][k] for k in row["limits"]), row


@pytest.mark.parametrize("cell", SERVE)
def test_the_fp8_control_reads_above_the_sound_program(cell, tiny):
    config, traffic = tiny
    seeds = [5, 6, 7]
    sound = [r["numbers"]["rel_err"] for r in readings.readings(cell, seeds, "cpu", None, config, traffic)]
    control = [r["numbers"]["rel_err"]
               for r in readings.readings(cell, seeds, "cpu", None, config, traffic, **CONTROLS[cell])]
    assert min(control) > 3 * max(sound), (sound, control)
