"""Totals and tails: every rate is a total over a total, every tail is
taken over all samples of the window."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def p95(samples: Sequence[float]) -> Optional[float]:
    if not len(samples):
        return None
    return float(np.percentile(np.asarray(samples, np.float64), 95))


def ratio(num: float, den: float) -> Optional[float]:
    return None if den <= 0 else float(num) / float(den)
