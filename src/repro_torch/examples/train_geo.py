"""End-to-end walkthrough: train the paper's model across emulated DCs.

Port of ``examples/train_geo.py``.  Trains distilgpt2-82m (the paper's
Fig-14 workload) with the full substrate (synthetic WikiText-like
pipeline, AdamW, async checksummed checkpoints, BFD-style heartbeats,
straggler monitor) under a chosen WAN sync strategy, and reports the
per-step WAN economics from the emulated EVPN-VXLAN fabric alongside the
training curve.

The experiment is one declarative ``repro_torch.scenario.Scenario``
(topology + workload + costing options) handed to the trainer; the CLI
flags are spec edits.  The spec's ``topology.num_pods`` is the pod count
and ``--data`` the ranks of each DC: ``pods x data`` processes of one gloo
group, FSDP over each DC's ranks, the WAN strategy as real collectives
between the DCs.  Default is a few hundred steps of the
reduced config; ``--paper-scale`` trains the real 82M model.  It runs on
the card (``--device cuda``, the default) or, when asked, on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_geo --steps 200
      PYTHONPATH=src python -m repro_torch.examples.train_geo --paper-scale --steps 30
      PYTHONPATH=src python -m repro_torch.examples.train_geo --strategy hier_int8
      PYTHONPATH=src python -m repro_torch.examples.train_geo --inject-failure-at 50
      PYTHONPATH=src python -m repro_torch.examples.train_geo --device cpu --steps 4
      PYTHONPATH=src python -m repro_torch.examples.train_geo --device cpu --steps 4 --data 2
"""

from __future__ import annotations

import argparse
import tempfile

from ..core.schedule import SYNC_STRATEGIES
from ..scenario import Scenario, SyncOptions, TopologySpec, WorkloadSpec


def geo_scenario(strategy: str, steps: int, *, pods: int = 2, events=()) -> Scenario:
    """The example's spec: ``pods`` DCs of 2 workers, ``strategy`` for
    ``steps`` steps, jitter-free costing, and an optional event script."""
    return Scenario(
        name="train_geo",
        topology=TopologySpec(num_pods=pods, workers_per_pod=2, seed=0),
        workload=WorkloadSpec(strategy=strategy, steps=steps),
        options=SyncOptions(jitter=False),
        events=tuple(events),
        description="Fig-14-style geo training, declaratively specified.",
    )


def group_rank(rank: int, args, scenario: Scenario):
    """One rank of a DC: the trainer on a (pod, data) mesh of the spec's DCs."""
    from ..configs import get_config, get_smoke_config
    from ..launch.mesh import make_host_mesh
    from ..optim import AdamWConfig
    from ..runtime import GeoTrainer, TrainerConfig

    mesh = make_host_mesh(pods=scenario.topology.num_pods, data=args.data, device=args.device)
    cfg = get_config("distilgpt2-82m") if args.paper_scale else get_smoke_config("distilgpt2-82m")
    trainer = GeoTrainer(
        cfg, mesh,
        trainer_cfg=TrainerConfig(
            seq_len=args.seq_len,
            global_batch=args.global_batch,
            steps=args.steps,
            log_every=max(args.steps // 20, 1),
            opt=AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        ),
        checkpoint_dir=args.checkpoint_dir,
        scenario=scenario,
        device=args.device,
    )
    return trainer.run(inject_failure_at=args.inject_failure_at)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    # the train step implements the paper strategies; the WAN estimator
    # additionally accepts any registered schedule strategy
    ap.add_argument("--strategy", default="hier", choices=list(SYNC_STRATEGIES))
    ap.add_argument("--paper-scale", action="store_true", help="the real 82M model")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--pods", type=int, default=2, help="DCs (the spec's num_pods)")
    ap.add_argument("--data", type=int, default=1, help="ranks of each DC (FSDP over them)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..distributed import spawn

    device = resolve_device(args.device)
    args.checkpoint_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="repro_torch_train_geo_")
    scenario = geo_scenario(args.strategy, args.steps, pods=args.pods)
    result = spawn(group_rank, scenario.topology.num_pods * args.data, args, scenario, device=device)[0]
    losses = [m["loss"] for m in result["metrics"]]
    wan = result["metrics"][-1]["wan_s_est"]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"WAN sync estimate [{args.strategy}]: {wan:.3f} s/step "
          f"(fabric: {args.pods} DCs, 800 Mbit/s x 4 WAN links, 22 ms RTT)")
    print(f"sync efficiency: {result['sync_efficiency']:.2f}; "
          f"last checkpoint: step {result['last_checkpoint']}")
    for drill in result["recovery_drills"]:
        p = drill["plan"]
        print(f"recovery drill @step {drill['step']}: detected {drill['dead']} in "
              f"{p['detection_s'] * 1e3:.0f} ms; lost {p['lost_steps']} steps; "
              f"downtime {p['detection_s'] + p['restore_s'] + p['remesh_s']:.1f} s")


if __name__ == "__main__":
    main()
