"""Quickstart: the whole stack in about a minute.

Port of ``examples/quickstart.py``, in its four parts:

1. Declare the experiment once: a ``repro_torch.scenario.Scenario`` carries
   the topology, the workload and the costing options; build the emulated
   2-DC EVPN-VXLAN fabric from it and ping across the WAN.
2. Allocate queue-pair source ports both ways (Algorithm 1 against stock
   RXE).
3. Cost every registered WAN sync schedule (the paper's strategies and
   the phased / overlapped ones) for the smoke model's gradients under the
   event-driven congestion model, one spec edit per strategy, with
   per-phase timelines for multi-phase schedules.
4. Train the smoke model for the spec's 20 steps with the geo trainer,
   driven by the same spec, on the card (``--device cuda``, the default)
   or, when asked, on the CPU.

Parts 1-3 are the numpy cost model (copies under ``repro_torch/core`` and
``repro_torch/scenario``) and print what the JAX script prints.  The JAX
script's checkpoint directory is fixed, so a second run restores the
finished one and trains nothing; here ``--checkpoint-dir`` names it
(default: ``repro_quickstart_ckpt`` in the temporary directory).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu --checkpoint-dir /path/to/new/dir
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from ..core.ports import allocate_ports, make_correlated_queue_pairs
from ..core.schedule import strategy_names
from ..scenario import Scenario, SyncOptions, TopologySpec, WorkloadSpec, run_scenario

ARCH = "distilgpt2-82m"

#: The whole experiment as one declarative spec: 2 DCs x 2 workers, the
#: smoke model's gradients, contended congestion costing, 20 train steps.
QUICKSTART = Scenario(
    name="quickstart",
    topology=TopologySpec(num_pods=2, workers_per_pod=2, seed=0),
    workload=WorkloadSpec(strategy="allreduce", grad_bytes=0, steps=20),
    options=SyncOptions(jitter=False, congestion=True),
    description="The README's 60-second tour, as a spec.",
)


def smoke_grad_bytes() -> int:
    """float32 gradient bytes of the smoke distilgpt2-82m (its parameters on
    the meta device)."""
    from ..configs import get_smoke_config
    from ..launch.shapes import params_specs
    from ..tree import tree_leaves

    return sum(t.numel() * 4 for t in tree_leaves(params_specs(get_smoke_config(ARCH))))


def sync_costs(geo, grad_bytes: int):
    """strategy -> its ``SyncCost`` for ``grad_bytes`` on ``geo``, one spec
    edit per registered strategy."""
    costs = {}
    for strategy in strategy_names():
        spec = dataclasses.replace(
            QUICKSTART, workload=WorkloadSpec(strategy=strategy, grad_bytes=grad_bytes, steps=1)
        )
        costs[strategy] = run_scenario(spec, geo=geo).sync
    return costs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default=os.path.join(tempfile.gettempdir(), "repro_quickstart_ckpt"))
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)

    # -- 1. fabric, from the spec --------------------------------------------
    geo = QUICKSTART.topology.build()
    rtt = geo.rtt_ms(count=20)
    print(f"[fabric] 2 DCs up; inter-DC RTT {rtt.mean():.1f} ms (paper ~22 ms)")

    # -- 2. Algorithm 1 ------------------------------------------------------
    qps = make_correlated_queue_pairs(8, base_number=1234)
    base = allocate_ports(qps, scheme="baseline")
    ours = allocate_ports(qps, scheme="qp_aware")
    print(f"[ports] stock RXE:   {sorted(base)} ({len(set(base))} distinct)")
    print(f"[ports] Algorithm 1: {sorted(ours)} ({len(set(ours))} distinct)")

    # -- 3. WAN sync costing: one spec edit per strategy ----------------------
    grad_bytes = smoke_grad_bytes()
    print(f"[sync]  gradient volume {grad_bytes / 1e6:.1f} MB across the WAN:")
    costs = sync_costs(geo, grad_bytes)
    for strategy, c in costs.items():
        phased = (
            " | ".join(f"{p.name} {p.duration_s * 1e3:.1f}ms" for p in c.phases)
            if len(c.phases) > 1
            else ""
        )
        print(f"        {strategy:14s} {c.amortized_seconds * 1e3:8.1f} ms/step "
              f"({c.wan_bytes / 1e6:6.1f} MB on WAN links)"
              + (f"  [{phased}]" if phased else ""))

    # -- 4. train: the trainer consumes the same scenario ---------------------
    from ..configs import get_smoke_config
    from ..launch.mesh import make_host_mesh
    from ..optim import AdamWConfig
    from ..runtime import GeoTrainer, TrainerConfig

    trainer = GeoTrainer(
        get_smoke_config(ARCH), make_host_mesh(device=device),
        trainer_cfg=TrainerConfig(seq_len=64, global_batch=4, log_every=5,
                                  opt=AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=400)),
        checkpoint_dir=args.checkpoint_dir,
        scenario=QUICKSTART,
        device=device,
    )
    result = trainer.run()
    losses = [m["loss"] for m in result["metrics"]]
    if losses:
        print(f"[train] loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps "
              f"(checkpointed at step {result['last_checkpoint']})")
    else:
        print(f"[train] nothing to do: restored checkpoint already at step "
              f"{result['last_checkpoint']} (delete the checkpoint dir to retrain)")
    return {"rtt_ms": rtt, "ports": {"baseline": base, "qp_aware": ours}, "grad_bytes": grad_bytes,
            "costs": costs, "losses": losses, "result": result}


if __name__ == "__main__":
    main()
