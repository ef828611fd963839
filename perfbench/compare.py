"""The numbers that compare served slices with the reference's, and a training step's state with the reference's."""
from __future__ import annotations

import torch

FAR = 0.05  # a pixel "off" when its gap exceeds this, on the [-1, 1] intensity scale


def slice_gaps(out: torch.Tensor, ref: torch.Tensor, base: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """``out`` and ``ref`` ``[B, ...]`` (float32), one slice a row: a slice's ``rel`` gap ||out - ref|| /
    ||ref - base|| (``base`` 0 by default: the gap against the slice itself), its widest gap at a pixel ``abs``,
    and ``off``, the share of its pixels off by more than ``FAR``."""
    diff = (out - ref).flatten(1)
    scale = (ref if base is None else ref - base).flatten(1).norm(dim=1)
    off = (diff.abs() > FAR).float().mean(dim=1)
    return {"rel": diff.norm(dim=1) / scale, "abs": diff.abs().amax(dim=1), "off": off}


def numbers(gaps: list[dict[str, torch.Tensor]]) -> dict[str, float]:
    """The worst sampled slice's: ``rel_err`` and ``off_share_0.05`` (compared), ``max_abs_err`` (for the record)."""
    worst = {k: float(torch.cat([g[k] for g in gaps]).max()) for k in gaps[0]}
    return {f"off_share_{FAR}": worst["off"], "rel_err": worst["rel"], "max_abs_err": worst["abs"]}


def moving_leaves(grads: dict[str, torch.Tensor], share: float = 1e-3) -> list[str]:
    """The leaves whose reference gradient is more than ``share`` of the median leaf's (by norm): the others
    move under Adam by round-off alone."""
    norms = {k: float(g.norm()) for k, g in grads.items()}
    median = float(torch.tensor(list(norms.values())).median())
    return [k for k, n in norms.items() if n > share * median]


def leaf_gaps(program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor]) -> list[float]:
    """Each leaf's gap between the program's norm and the reference's, against the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    norms = {k: float(reference[k].norm()) for k in reference}
    median = float(torch.tensor(list(norms.values())).median())
    return [abs(float(program[k].float().norm()) - n) / max(n, median) for k, n in norms.items()]


def leaf_gap(program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor]) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(program, reference))


def median_leaf_gap(program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor]) -> float:
    """The median leaf's gap (``leaf_gaps``): steady where a few leaves' numbers are rounding, as an EMA's three
    steps are in the leaves at magnitude 1, under one float32 ulp."""
    return float(torch.tensor(leaf_gaps(program, reference)).median())
