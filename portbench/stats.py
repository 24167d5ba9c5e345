"""Order statistics of the metric readers."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile, linearly interpolated (numpy's default); None
    for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def window_requests(rec):
    """The requests due inside the window."""
    return [r for r in rec["requests"]
            if rec["w0_us"] <= r["due_us"] < rec["w1_us"]]
