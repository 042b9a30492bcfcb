"""Geo-serving walkthrough: millions of users on the training fabric.

Port of ``examples/serve_geo.py``.  Runs the ``serving_under_flap`` library
scenario (inference traffic co-scheduled with hierarchical training through
one gray-failure arc: WAN brownout -> SLA-probe trip -> session failover ->
recovery) and prints the per-step serving story: request counts, latency
percentiles, SLO misses, and the migration wave with its concrete WAN KV
bytes.

Then it bridges sim to silicon: the first trace request of the peak step
is materialized as a real model batch via ``repro_torch.serving.request_batch``
and run through prefill, on the card (``--device cuda``, the default) or,
when asked, on the CPU; the smoke config unless ``--full-config``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_geo
      PYTHONPATH=src python -m repro_torch.examples.serve_geo --device cpu
"""

from __future__ import annotations

import argparse

from ..scenario import get_scenario, run_scenario


def peak_requests(scenario, result):
    """(the serving step with the most requests, its trace requests)."""
    from ..serving import generate_trace

    peak = max(result.serving_steps, key=lambda s: s.requests)
    trace = generate_trace(scenario.serving, scenario.topology.num_pods, scenario.workload.steps)
    return peak, trace[peak.step]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full-config", action="store_true",
                    help="prefill on the full (paper-scale) config instead of the smoke one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)
    scenario = get_scenario("serving_under_flap")
    print(f"=== {scenario.name}: {scenario.description}\n")
    result = run_scenario(scenario)

    print(f"{'step':>4s} {'reqs':>5s} {'remote':>6s} {'p50 ms':>8s} "
          f"{'p99 ms':>9s} {'miss':>5s} {'migrated':>8s} {'KV MB':>7s}")
    for s in result.serving_steps:
        flag = " <- failover wave" if s.migrated_sessions else ""
        print(f"{s.step:>4d} {s.requests:>5d} {s.remote_requests:>6d} "
              f"{s.p50_ms:>8.1f} {s.p99_ms:>9.1f} {s.slo_misses:>5d} "
              f"{s.migrated_sessions:>8d} {s.migration_bytes / 1e6:>7.1f}{flag}")

    m = result.metrics()
    print(f"\n{int(m['serving_requests'])} requests, "
          f"p99 {m['serving_p99_ms']:.0f} ms, "
          f"{m['serving_slo_miss_frac']:.1%} SLO misses, "
          f"{int(m['serving_migrated_sessions'])} sessions migrated "
          f"({m['serving_migration_bytes'] / 1e6:.0f} MB of KV over the WAN)")

    # sim -> silicon: serve the peak step's first request for real
    _, requests = peak_requests(scenario, result)
    req = requests[0]
    print(f"\nmaterializing request rid={req.rid} "
          f"({req.tokens} tokens, home DC {req.home_dc}) as a model batch:")
    import torch

    from ..configs import get_config, get_smoke_config
    from ..models import init_params, prefill
    from ..serving import request_batch

    cfg = get_config("distilgpt2-82m") if args.full_config else get_smoke_config("distilgpt2-82m")
    batch = request_batch(cfg, req, device=device)
    params = init_params(cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)
    logits, _cache = prefill(params, batch, cfg, max_len=req.tokens + 8)
    print(f"prefill logits: {tuple(logits.shape)}")


if __name__ == "__main__":
    main()
