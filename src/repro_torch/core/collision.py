"""Analytical ECMP collision model (paper §3.3.2, Eqs. 3–11).

For ``N`` concurrent flows over ``K`` equal-cost paths with path-selection
distribution ``p``:

    E[C] = C(N,2) * sum_l p_l**2                      (Eq. 5)

The queue-pair-aware allocator helps exactly when it lowers the collision
index ``sum_l p_l**2`` (Eq. 11), i.e. when it makes the induced path
distribution closer to uniform.  This module provides the closed forms and
a Monte-Carlo estimator that drives real allocators through the real fabric
hash so the two can be cross-checked (tests assert they agree).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Sequence

import numpy as np

from .fabric import FiveTuple, ecmp_hash
from .ports import NUM_PORT_OFFSETS, ROCE_V2_BASE_PORT, allocate_ports, make_queue_pairs


@lru_cache(maxsize=32)
def _port_path_table(
    src_ip: str, dst_ip: str, dst_port: int, switch_seed: int, num_paths: int
) -> np.ndarray:
    """ECMP path for every RoCEv2 source port, precomputed.

    A connection's QPs share the 5-tuple except for the source port
    (§3.3), so one pass over the 16384-port dynamic range turns the
    per-trial hash loop into a NumPy table lookup — same ``ecmp_hash``,
    just evaluated once per port instead of once per (trial, QP)."""
    return np.array(
        [
            ecmp_hash(
                FiveTuple(src_ip, dst_ip, ROCE_V2_BASE_PORT + off, dst_port),
                switch_seed,
                num_paths,
            )
            for off in range(NUM_PORT_OFFSETS)
        ],
        dtype=np.int64,
    )


def collision_index(p: Sequence[float]) -> float:
    """``sum_l p_l**2`` — minimized (=1/K) by the uniform distribution."""
    arr = np.asarray(p, dtype=np.float64)
    if not np.isclose(arr.sum(), 1.0):
        raise ValueError(f"path distribution must sum to 1, got {arr.sum()}")
    return float(np.sum(arr**2))


def expected_collisions(num_flows: int, p: Sequence[float]) -> float:
    """Eq. 5: E[C] = C(N,2) * sum p^2."""
    return math.comb(num_flows, 2) * collision_index(p)


def collision_reduction(p_base: Sequence[float], p_prop: Sequence[float]) -> float:
    """Eq. 10: Delta_C = 1 - sum(p_prop^2)/sum(p_base^2)."""
    return 1.0 - collision_index(p_prop) / collision_index(p_base)


@dataclass
class MonteCarloResult:
    mean_pairwise_collisions: float
    path_distribution: np.ndarray  # pooled over trials
    empirical_index: float  # sum p^2 of the pooled distribution
    analytic_expected: float  # Eq. 5 on the pooled distribution
    #: Eq. 5 evaluated on each trial's own induced distribution, then
    #: averaged — the paper's setting is a fixed workload whose QP set
    #: induces a persistent p, so the per-trial form is the right
    #: cross-check against the Monte-Carlo collision count.
    analytic_expected_per_trial: float = 0.0
    per_trial_index: float = 0.0


def monte_carlo_collisions(
    *,
    num_qps: int,
    num_paths: int,
    scheme: str,
    trials: int = 2000,
    k_bins: int = 4,
    qp_stride: int = 1,
    seed: int = 0,
    src_ip: str = "192.168.1.1",
    dst_ip: str = "192.168.2.1",
    dst_port: int = 4791,
) -> MonteCarloResult:
    """Drive an allocator through the ECMP hash and count path collisions.

    Each trial draws a random base QP number (as a fresh connection setup
    would), allocates ports for ``num_qps`` QPs spaced ``qp_stride`` apart,
    hashes the resulting 5-tuples onto ``num_paths`` paths, and counts
    pairwise collisions.  The empirical path distribution (pooled over
    trials) feeds the analytic Eq. 5 for cross-checking.
    """
    rng = np.random.default_rng(seed)
    switch_seed = 0x5EED
    table = _port_path_table(src_ip, dst_ip, dst_port, switch_seed, num_paths)
    path_counts = np.zeros(num_paths, dtype=np.int64)
    total_collisions = 0
    per_trial_expected = 0.0
    per_trial_index = 0.0
    for _ in range(trials):
        base = int(rng.integers(0, 2**31))
        qps = make_queue_pairs(num_qps, base_number=base, stride=qp_stride)
        ports = allocate_ports(qps, scheme=scheme, k=k_bins)
        paths = table[np.asarray(ports, dtype=np.int64) - ROCE_V2_BASE_PORT]
        counts = np.bincount(paths, minlength=num_paths)
        path_counts += counts
        total_collisions += int(np.sum(counts * (counts - 1) // 2))
        p_trial = counts / num_qps
        idx = float(np.sum(p_trial**2))
        per_trial_index += idx
        per_trial_expected += math.comb(num_qps, 2) * idx
    p = path_counts / path_counts.sum()
    return MonteCarloResult(
        mean_pairwise_collisions=total_collisions / trials,
        path_distribution=p,
        empirical_index=collision_index(p),
        analytic_expected=expected_collisions(num_qps, p),
        analytic_expected_per_trial=per_trial_expected / trials,
        per_trial_index=per_trial_index / trials,
    )


def compare_schemes(
    *,
    num_qps: int,
    num_paths: int = 4,
    trials: int = 2000,
    qp_stride: int = 1,
    seed: int = 0,
) -> Dict[str, object]:
    """Baseline vs QP-aware: Monte-Carlo collisions + analytic Delta_C."""
    base = monte_carlo_collisions(
        num_qps=num_qps, num_paths=num_paths, scheme="baseline",
        trials=trials, qp_stride=qp_stride, seed=seed,
    )
    prop = monte_carlo_collisions(
        num_qps=num_qps, num_paths=num_paths, scheme="qp_aware",
        trials=trials, qp_stride=qp_stride, seed=seed,
    )
    # Eq. 10 on the per-trial (workload-induced) collision indices — the
    # pooled distributions are both ~uniform by symmetry and would hide
    # the correlation the mechanism removes.
    delta_c_analytic = 1.0 - prop.per_trial_index / base.per_trial_index
    delta_c_empirical = (
        1.0 - prop.mean_pairwise_collisions / base.mean_pairwise_collisions
        if base.mean_pairwise_collisions > 0
        else 0.0
    )
    return {
        "baseline": base,
        "proposed": prop,
        "delta_c_analytic": delta_c_analytic,
        "delta_c_empirical": delta_c_empirical,
    }
