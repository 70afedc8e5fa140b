"""The numbers that decide `correct`: gaps between what the port made and
what the reference works out, each taken where it is widest."""
from __future__ import annotations

import statistics


def loss_gap(program: list, reference: list) -> float:
    """The widest relative gap between the two sides' losses, step by
    step."""
    return max(abs(a - b) / abs(b) for a, b in zip(program, reference))


def norm_gap(program: dict, reference: dict,
             skip: set | frozenset = frozenset()) -> tuple[float, str]:
    """(gap, leaf) of the worst leaf: |program's norm - reference's| over
    the larger of the reference's norm of that leaf and of the median
    leaf.  `skip` names leaves left out."""
    ref_median = statistics.median(reference.values())
    worst, where = 0.0, ""
    for name, ref in reference.items():
        if name in skip:
            continue
        gap = abs(program[name] - ref) / max(ref, ref_median)
        if gap >= worst:
            worst, where = gap, name
    return worst, where


def unmoved(grad_norms: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is nought to rounding: under
    `share` of the median leaf's (Adam moves them by round-off alone)."""
    median = statistics.median(grad_norms.values())
    return {n for n, g in grad_norms.items() if g < share * median}
