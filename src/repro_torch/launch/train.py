"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

The port of ``repro.launch.train``: runs :class:`~repro_torch.runtime.GeoTrainer`
on the chosen architecture (smoke-scale unless ``--full-config``), with
``--pods`` emulated pods on one device and a WAN sync strategy.  Runs on
the card (``--device cuda``, the default) or, when asked, on the CPU
through the plain PyTorch path.  ``--profile`` (card only) runs one more
step under ``torch.profiler`` and prints the device's busy share of the
step's wall time and the ops by device time.  It checkpoints into
``--checkpoint-dir`` (a new temporary directory unless given; a directory
that holds checkpoints resumes from the newest) every ``--checkpoint-every``
steps (Young/Daly when not given), takes a named shape of
:data:`~repro_torch.launch.shapes.SHAPES` through ``--shape``, can silence
``pod1`` from ``--inject-failure-at`` on for a recovery drill, and prints the emulated
fabric's WAN seconds a step for the strategy, as ``examples/train_geo.py``
does for the JAX package.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="distilgpt2-82m")
    ap.add_argument("--full-config", action="store_true",
                    help="the full (paper-scale) config instead of the smoke one")
    ap.add_argument("--shape", default=None,
                    help="a named shape of launch.shapes.SHAPES (train_4k): sets --seq-len and --global-batch")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--strategy", default="hier",
                    choices=["allreduce", "ps", "hier", "hier_int8", "local_sgd"])
    ap.add_argument("--pods", type=int, default=1, help="emulated pods (the WAN's ends)")
    ap.add_argument("--num-channels", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--checkpoint-every", type=int, default=None, help="default: Young/Daly")
    ap.add_argument("--inject-failure-at", type=int, default=None, help="silence pod1 from this step on")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.profiling import profile_run
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.runtime import GeoTrainer, TrainerConfig

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        raise ValueError("--profile traces the card: use --device cuda")
    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    if args.shape is not None:
        spec = SHAPES[args.shape]
        args.seq_len, args.global_batch = spec.seq_len, spec.global_batch
    trainer = GeoTrainer(
        cfg,
        trainer_cfg=TrainerConfig(
            seq_len=args.seq_len,
            global_batch=args.global_batch,
            steps=args.steps,
            strategy=args.strategy,
            npods=args.pods,
            num_channels=args.num_channels,
            seed=args.seed,
            checkpoint_every=args.checkpoint_every,
        ),
        checkpoint_dir=args.checkpoint_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_"),
        device=device,
    )
    result = trainer.run(inject_failure_at=args.inject_failure_at)
    rows = result["metrics"]
    print(
        f"\nfinal loss {result['final_loss']:.4f} after {len(rows)} steps "
        f"({args.pods} pods, {args.strategy}, {args.global_batch} x {args.seq_len}); "
        f"last step {rows[-1]['step_s'] * 1e3:.2f} ms, {rows[-1]['wan_bytes']} WAN bytes/pod"
    )
    print(f"WAN sync estimate [{args.strategy}]: {rows[-1]['wan_s_est']:.3f} s/step "
          f"(emulated fabric: {trainer.geo.num_pods} DCs)")
    print(f"sync efficiency: {result['sync_efficiency']:.2f}; "
          f"last checkpoint: step {result['last_checkpoint']} in {trainer.store.root}")
    for drill in result["recovery_drills"]:
        p = drill["plan"]
        print(f"recovery drill @step {drill['step']}: detected {drill['dead']} in "
              f"{p['detection_s'] * 1e3:.0f} ms; lost {p['lost_steps']} steps; "
              f"downtime {p['detection_s'] + p['restore_s'] + p['remesh_s']:.1f} s")
    if args.out_json:
        Path(args.out_json).write_text(json.dumps(rows, indent=1))
    if args.profile:
        batch = trainer.next_batch()
        state = {"params": trainer.params, "state": trainer.state}

        def one_step():
            state["params"], state["state"], _ = trainer.step_fn(state["params"], state["state"], batch)

        profile_run(f"train step ({args.pods} pods, {args.strategy})", one_step, device, rows=25)


if __name__ == "__main__":
    main()
