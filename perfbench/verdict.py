"""The comparison that decides ``correct``: the numbers compared, each
against its limit from ``limits/<workload>.json``.

Serving: ``logit_err_share``, the share of a sample of the served tokens
whose error is over a margin that the cell's limits give: a token's error
is the larger of the widest gap between the program's top logits and the
reference's logits of the same tokens, and the gap by which the
reference's logit of the served token lies below the reference's best
(``serve_driver.reference_errors``).  Every sampled token counts in it, so
a fault in any sizeable group of slots or positions moves it.

Training, over the checked steps: ``loss_gap``, the largest gap of a step's
loss over the reference's; ``grad_gap``, the first gradient's worst leaf;
``change_gap``, the change's worst leaf.  A leaf's gap is the gap between
the program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger.  Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off alone
and are left out of the change.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[List[str]] = None) -> Tuple[float, str]:
    """(worst gap, its leaf) over the leaves of ``keep`` (default all)."""
    names = keep if keep is not None else sorted(ref)
    med = statistics.median(ref[k] for k in names)
    worst, at = 0.0, ""
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g > worst:
            worst, at = g, k
    return worst, at


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items() if v >= 1e-3 * med)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                      ref["losses"]))
    grad_gap, grad_at = leaf_gap(prog["grad_norms"], ref["grad_norms"])
    moving = moving_leaves(ref["grad_norms"])
    change_gap, change_at = leaf_gap(prog["change_norms"], ref["change_norms"],
                                     moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "_grad_leaf": grad_at,
            "_change_leaf": change_at,
            "_left_out": len(ref["grad_norms"]) - len(moving)}


def judge(numbers: Dict[str, float], limits: Optional[Dict]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {value, limit}}) over the numbers the cell's limits
    name: each at or under its limit.  A named number that is missing or
    not finite fails, and so does a cell with no limits."""
    shown, ok = {}, bool(limits)
    for name, lim in (limits or {}).items():
        v = numbers.get(name, float("nan"))
        shown[name] = {"value": v, "limit": lim["limit"]}
        ok = ok and v == v and v <= lim["limit"]
    return ok, shown
