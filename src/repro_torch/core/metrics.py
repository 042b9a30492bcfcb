"""Traffic-distribution metrics (paper §5.2).

The headline metric is the CONGA-style load factor (Eq. 12):

    LoadFactor = (U_max - U_min) / U_avg

computed over *active* links only — a link counts as used when its byte
counter exceeds ``threshold``, preventing idle links from flattering the
ratio (the paper is explicit about this guard).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

Link = Tuple[str, str]


@dataclass
class LoadFactorResult:
    load_factor: float
    u_max: float
    u_min: float
    u_avg: float
    active_links: int
    total_links: int


def load_factor(
    link_bytes: Mapping[Link, int] | Sequence[int],
    threshold: int = 1,
) -> LoadFactorResult:
    """Eq. 12 over active links (bytes > threshold)."""
    if isinstance(link_bytes, Mapping):
        values = np.array(list(link_bytes.values()), dtype=np.float64)
    else:
        values = np.asarray(link_bytes, dtype=np.float64)
    total = len(values)
    active = values[values > threshold]
    if active.size == 0:
        return LoadFactorResult(0.0, 0.0, 0.0, 0.0, 0, total)
    u_max, u_min, u_avg = float(active.max()), float(active.min()), float(active.mean())
    lf = (u_max - u_min) / u_avg if u_avg > 0 else 0.0
    return LoadFactorResult(lf, u_max, u_min, u_avg, int(active.size), total)


def flow_entropy(path_counts: Sequence[int]) -> float:
    """Shannon entropy (bits) of the flow->path assignment distribution."""
    counts = np.asarray(path_counts, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts[counts > 0] / total
    return float(-(p * np.log2(p)).sum())


def utilization_per_link(
    link_bytes: Mapping[Link, int],
    window_s: float,
    bw_gbps: Mapping[Link, float] | float,
) -> Dict[Link, float]:
    """Fraction of capacity used by each link over a window."""
    out: Dict[Link, float] = {}
    for link, nbytes in link_bytes.items():
        bw = bw_gbps if isinstance(bw_gbps, (int, float)) else bw_gbps[link]
        cap = bw * 1e9 / 8.0 * window_s
        out[link] = nbytes / cap if cap > 0 else 0.0
    return out
