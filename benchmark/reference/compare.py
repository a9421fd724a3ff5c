"""The numbers that decide `correct`: gaps between what the program
produced and what the reference computes from the same inputs.

Frames: `bad8_share`, the share of u8 channel values more than 8 apart,
and `mean_abs_u8`, the mean absolute difference. Training: `loss_gap`,
the worst relative gap of a step's loss; `grad_gap`, the worst leaf's gap
between the norms of the first gradient; `step_gap`, the worst leaf's gap
between the norms of the parameters' change over the compared steps.
A leaf's norm gap is taken against the larger of the reference's norm of
that leaf and the median leaf's, since some gradients are all but zero;
leaves whose reference gradient is under a thousandth of the median
nonzero leaf's move under Adam by round-off alone and are left out of
`step_gap`.
"""

from __future__ import annotations

import numpy as np


def frame_gaps(prog: np.ndarray, ref: np.ndarray) -> dict:
    """Gaps of two (H, W, 3) u8 frames."""
    if prog.shape != ref.shape:
        return {"bad8_share": 1.0, "mean_abs_u8": 255.0}
    d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return {"bad8_share": float((d > 8).mean()),
            "mean_abs_u8": float(d.mean())}


def worst(gaps: list) -> dict:
    """Key-wise maximum of several gap dicts."""
    return {k: max(g[k] for g in gaps) for k in gaps[0]}


def _leaf_gap(prog: float, ref: float, floor: float) -> float:
    den = max(ref, floor)
    if den == 0.0:
        return 0.0 if prog == 0.0 else float("inf")
    return abs(prog - ref) / den


def train_gaps(prog: dict, ref: dict) -> dict:
    """prog and ref: {"losses": [...], "grad_norms": {leaf: norm},
    "delta_norms": {leaf: norm}}, the losses of the same steps."""
    n = min(len(prog["losses"]), len(ref["losses"]))
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"][:n], ref["losses"][:n]))
    if not all(np.isfinite(prog["losses"][:n])):
        loss_gap = float("inf")
    g_ref = ref["grad_norms"]
    nonzero = [v for v in g_ref.values() if v > 0]
    g_med = float(np.median(nonzero)) if nonzero else 0.0
    grad_gap = max(_leaf_gap(prog["grad_norms"][k], g_ref[k], g_med)
                   for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med and g_med > 0]
    d_ref = ref["delta_norms"]
    d_med = float(np.median([d_ref[k] for k in moved])) if moved else 0.0
    step_gap = max((_leaf_gap(prog["delta_norms"][k], d_ref[k], d_med)
                    for k in moved), default=0.0)
    return {"loss_gap": float(loss_gap), "grad_gap": float(grad_gap),
            "step_gap": float(step_gap)}
