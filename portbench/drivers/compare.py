"""Comparisons shared by the training drivers."""
from __future__ import annotations

import numpy as np
import torch


def rel_diff(prog: dict, ref: dict) -> float:
    """The norm of the difference of the two trees, all leaves as one
    vector, over the reference's norm: where the program's direction
    departs, which the norms of single leaves do not show."""
    flat = lambda t: torch.cat([t[n].flatten() for n in sorted(ref)])
    p, r = flat(prog), flat(ref)
    return float((p - r).norm() / r.norm().clamp_min(1e-30))


def leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf
    and of the median leaf (not the norm of their difference: that of an
    all but unmoved leaf would be noise)."""
    rn = {n: float(ref[n].norm()) for n in keep}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[n].norm()) - rn[n]) / max(rn[n], med, 1e-30)
               for n in keep)
