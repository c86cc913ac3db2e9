"""The comparisons that decide ``correct``: each turns the program's readings
and the reference's into one number that a cell's limit holds.

* ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the steps
  the reference follows.
* ``grad_gap`` / ``change_gap``: by the worst leaf of the state (each MLP
  tensor, and the embedding table), the gap between the
  program's norm and the reference's (not the norm of their difference),
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger.  A leaf whose first gradient in the reference is under a
  thousandth of the median leaf's moves by round-off alone and is left out
  of both (``keep_leaves``).
* ``row_gap``: row by row over every row of the table that the checked
  steps touched, the largest norm of the difference between the program's
  change of a row and the reference's, over the reference's largest change
  of a row: a fault in the rows of one small field, which the table's norm
  hides, shows here.
* ``score_gap``: for a served batch, the largest ``|s_prog - s_ref|`` over
  the reference's largest ``|s_ref|``.
* ``stray_rows``: rows of the host table that differ from their first
  value where no step may have changed them; exact, so its limit is 0.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import torch

__all__ = ["keep_leaves", "leaf_gap", "loss_gap", "row_gap", "score_gap", "train_gaps"]

ROUNDOFF_SHARE = 1e-3  # of the median leaf's first gradient


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} program losses against {len(ref)} reference losses")
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def keep_leaves(ref_grad: Mapping[str, float]) -> Tuple[str, ...]:
    """The leaves whose reference gradient is more than round-off."""
    floor = ROUNDOFF_SHARE * statistics.median(ref_grad.values())
    return tuple(k for k, v in ref_grad.items() if v >= floor)


def leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float], keep: Iterable[str]
             ) -> Tuple[float, str]:
    """(the worst kept leaf's gap, its name)."""
    med = statistics.median(ref.values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_gaps(prog_losses: Sequence[float], prog: Mapping[str, Mapping[str, float]],
               ref: Mapping[str, object]) -> Dict[str, object]:
    """The training checks' numbers, with the worst leaves and the leaves
    left out named beside them."""
    keep = keep_leaves(ref["grad_norms"])
    g, g_leaf = leaf_gap(prog["grad_norms"], ref["grad_norms"], keep)
    c, c_leaf = leaf_gap(prog["change_norms"], ref["change_norms"], keep)
    return {"loss_gap": loss_gap(prog_losses, ref["losses"]), "grad_gap": g,
            "change_gap": c, "row_gap": row_gap(prog["change_rows"], ref["change_rows"]),
            "worst_leaves": {"grad_gap": g_leaf, "change_gap": c_leaf},
            "left_out": sorted(set(ref["grad_norms"]) - set(keep))}


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """``prog`` and ``ref``: the same rows' changes, [rows, dim]."""
    if prog.shape != ref.shape:
        return float("inf")
    ref = ref.double()
    diff = (prog.to(ref.device).double() - ref).norm(dim=1)
    return float(diff.max() / ref.norm(dim=1).max())


def score_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float((prog - ref).abs().max() / ref.abs().max())
