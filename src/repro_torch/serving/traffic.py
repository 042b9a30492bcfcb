"""Open-loop geo-serving request generation.

Each DC hosts a pinned user population (the data-sovereignty assumption:
users are regional, their traffic originates where they live).  Arrivals
per emulated step are Poisson with a rate modulated by a sinusoidal
diurnal curve whose peak *rotates* across DCs — DC 1 peaks first, the
last DC peaks ``(num_dcs-1)/num_dcs`` of a period later — so at any
instant some region is near peak while another idles, the load shape
that makes geo-failover worth having.  Per-request context lengths are
heavy-tailed (lognormal or Pareto), matching measured LLM-serving token
distributions: most requests are short, the p99 is many multiples of the
mean, and it is exactly those tail requests whose KV handoff bytes hurt
on a degraded WAN.

The whole trace is a pure function of ``(spec, num_dcs, num_steps)`` via
one ``numpy`` generator seeded from ``spec.seed`` — sweep workers and
JSON round-trips reproduce it byte-for-byte.
"""
# Port: the imports of ``repro.*`` modules are relative (``..*``), to the port's own copies; nothing else differs.

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

from ..scenario.spec import ServingSpec

__all__ = [
    "Request",
    "diurnal_factor",
    "generate_trace",
    "resolve_populations",
]


@dataclass(frozen=True)
class Request:
    """One inference request: ``user`` in ``home_dc`` wants ``tokens`` of
    context served at ``step``.  ``rid`` is globally unique within a
    trace and seeds the request's QPN."""

    rid: int
    step: int
    home_dc: int
    user: int
    tokens: int


def resolve_populations(spec: ServingSpec, num_dcs: int) -> Tuple[int, ...]:
    """Per-DC user counts: explicit ``users_per_dc`` or ``users`` split
    near-evenly (first DCs absorb the remainder, like ``split_bytes``)."""
    if spec.users_per_dc:
        if len(spec.users_per_dc) != num_dcs:
            raise ValueError(
                f"users_per_dc has {len(spec.users_per_dc)} entries for "
                f"{num_dcs} DCs"
            )
        return spec.users_per_dc
    from ..core.flows import split_bytes

    return tuple(split_bytes(spec.users, num_dcs))


def diurnal_factor(spec: ServingSpec, step: int, dc: int, num_dcs: int) -> float:
    """Arrival-rate multiplier in ``[1-A, 1+A]``; DC phases are spread a
    full period apart across the fleet (time zones)."""
    phase = (dc - 1) / max(num_dcs, 1)
    return 1.0 + spec.diurnal_amplitude * math.sin(
        2.0 * math.pi * (step / spec.diurnal_period_steps + phase)
    )


def generate_trace(
    spec: ServingSpec, num_dcs: int, num_steps: int
) -> Tuple[Tuple[Request, ...], ...]:
    """The full deterministic trace: ``trace[step]`` is that step's
    requests, ordered by (DC, draw order)."""
    import numpy as np

    populations = resolve_populations(spec, num_dcs)
    rng = np.random.default_rng(spec.seed)
    # lognormal mu chosen so E[tokens] == mean_tokens for the given sigma
    mu = math.log(spec.mean_tokens) - spec.tail_sigma**2 / 2.0
    # Pareto scale xm with E = xm * alpha / (alpha - 1)
    xm = spec.mean_tokens * (spec.tail_alpha - 1.0) / spec.tail_alpha

    trace: List[Tuple[Request, ...]] = []
    rid = 0
    for step in range(num_steps):
        step_requests: List[Request] = []
        for dc in range(1, num_dcs + 1):
            pop = populations[dc - 1]
            rate = pop * spec.requests_per_user_step
            if rate <= 0.0:
                continue
            n = int(rng.poisson(rate * diurnal_factor(spec, step, dc, num_dcs)))
            for _ in range(n):
                user = int(rng.integers(0, pop))
                if spec.tail == "lognormal":
                    raw = float(rng.lognormal(mu, spec.tail_sigma))
                else:
                    raw = xm * (1.0 + float(rng.pareto(spec.tail_alpha)))
                tokens = max(1, int(round(raw)))
                step_requests.append(
                    Request(rid=rid, step=step, home_dc=dc, user=user, tokens=tokens)
                )
                rid += 1
        trace.append(tuple(step_requests))
    return tuple(trace)
