"""Operations of a plain reference, counted on the ``meta`` device by ``torch.utils.flop_counter``."""
from __future__ import annotations

from perfbench.peaks import PEAK_FLOPS


def count(fn) -> dict[str, float]:
    """``{aten op: FLOPs}`` of ``fn()`` (convolutions and matrix products; FFTs and elementwise ops count 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return {str(op): float(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}


def seconds_at_peak(parts: list[dict]) -> float:
    """The least time of a request's operations on the card.  ``parts`` are ``{"ops": {aten op: FLOPs},
    "precision": {aten op: precision, "default": precision}}``, one a stage that the configuration states a
    precision for; each op's FLOPs count at the peak of its stage's precision for it."""
    total = 0.0
    for part in parts:
        precision = part["precision"]
        total += sum(n / PEAK_FLOPS[precision.get(op, precision["default"])] for op, n in part["ops"].items())
    return total
