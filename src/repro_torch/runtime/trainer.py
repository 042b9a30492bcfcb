"""GeoTrainer: the geo-distributed training loop on one device.

Port of ``repro.runtime.trainer``: each step takes the next batch of the
synthetic loader, runs the train step (per-pod loss and gradients,
cross-pod sync under one of the five WAN strategies, AdamW, and for
``local_sgd`` the DiLoCo outer step) and logs a row with the loss, the
step's wall time (host clock around work that ends in
``torch.cuda.synchronize()``), the gradient norm, the WAN bytes each pod
sent and ``wan_s_est``: the emulated EVPN-VXLAN fabric's price of one
step's sync (``GeoFabric.sync_cost``, the numpy cost model of
:mod:`repro_torch.core`).  Around the step, as in the JAX loop:

* checkpoints, async and checksummed, every ``checkpoint_every`` steps
  (Young/Daly from the measured step time when None) and after the last
  step; a new trainer on the same directory resumes at the newest one,
  loader included.  The snapshot is taken after the step's time is read;
* a BFD-style heartbeat monitor on a simulated clock (one beat interval a
  step), with ``inject_failure_at`` silencing ``pod1``, and the recovery
  plan priced when a pod is declared dead;
* a straggler monitor fed each step's time per pod.

``scenario=`` takes a declarative :class:`~repro_torch.scenario.Scenario`
instead of ``geo``: the spec builds the emulated deployment, its workload's
strategy, channel count and steps override the ``TrainerConfig`` (when the
workload names a strategy), its options price the sync (jitter off), and
its event script (link flaps, brownouts, tenant churn) is replayed through
the scenario runner at step boundaries, before the step's batch and outside
its timed window.  Straggler events scale modelled compute only, so the
trainer, which measures its compute, skips them.  The pod count stays
``TrainerConfig.npods``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..checkpoint import AsyncCheckpointer, CheckpointStore
from ..core import GeoFabric, SyncOptions
from ..data import loader_for_model
from ..device import DeviceLike, resolve_device
from ..distributed import init_pod_params, init_train_state, make_train_step
from ..models import init_params
from ..models.config import ModelConfig
from ..optim import AdamWConfig, DilocoConfig
from ..tree import tree_leaves
from .failure import HeartbeatMonitor, optimal_checkpoint_interval, plan_recovery
from .straggler import StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 128
    global_batch: int = 8
    steps: int = 100
    strategy: str = "hier"
    npods: int = 1
    num_channels: int = 4
    checkpoint_every: Optional[int] = None  # None -> Young/Daly auto
    checkpoint_keep: int = 3
    log_every: int = 10
    seed: int = 0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    diloco: DilocoConfig = dataclasses.field(default_factory=DilocoConfig)
    mtbf_s: float = 6 * 3600.0  # assumed per-pod MTBF for ckpt cadence


class GeoTrainer:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        trainer_cfg: TrainerConfig,
        checkpoint_dir: str,
        geo: Optional[GeoFabric] = None,
        scenario=None,
        device: DeviceLike = "cuda",
    ):
        self.cfg = cfg
        self.tc = trainer_cfg
        self.device = resolve_device(device)
        self.sync_options = SyncOptions(jitter=False)
        self.scenario = scenario
        if scenario is not None:
            # the spec supplies the deployment, the strategy and cadence, the
            # step budget and the costing options; the fields the trainer
            # measures for real (compute_seconds, overlap_fraction,
            # grad_bytes, model) and the batch shape, optimiser and
            # checkpoint cadence of trainer_cfg are not taken from it
            if geo is not None:
                raise ValueError("pass scenario or geo, not both")
            geo = scenario.topology.build()
            wl = scenario.workload
            if wl.strategy is not None:
                # the spec is authoritative, including an explicit steps=1
                self.tc = dataclasses.replace(
                    self.tc, strategy=wl.strategy, num_channels=scenario.topology.num_channels, steps=wl.steps,
                )
            self.sync_options = dataclasses.replace(scenario.options, jitter=False)
        tc = self.tc
        # one pod stands for a mesh without a pod axis, which the JAX trainer prices as 2
        self.geo = geo or GeoFabric(num_pods=tc.npods if tc.npods > 1 else 2)
        self.store = CheckpointStore(checkpoint_dir, keep=tc.checkpoint_keep)
        self.ckpt = AsyncCheckpointer(self.store)
        pods = [f"pod{i}" for i in range(tc.npods)]
        self.heartbeats = HeartbeatMonitor(pods, interval_ms=100.0)
        self.stragglers = StragglerMonitor(pods)
        self.loader = loader_for_model(cfg, seq_len=tc.seq_len, global_batch=tc.global_batch, seed=tc.seed)
        self.step_fn = make_train_step(
            cfg, npods=tc.npods, strategy=tc.strategy, num_channels=tc.num_channels,
            opt_cfg=tc.opt, diloco_cfg=tc.diloco, device=self.device,
        )
        self.grad_bytes = sum(t.numel() * 4 for t in tree_leaves(init_params(cfg, device="meta")))
        self.metrics_log: List[Dict[str, float]] = []
        self.event_s: List[Dict[str, Any]] = []  # host seconds each replayed scenario event took
        self.params: Any = None
        self.state: Any = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def init_state(self):
        """Fresh parameters from the seed and their train state."""
        tc = self.tc
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        params = init_params(self.cfg, generator=gen, device=self.device)
        state = init_train_state(params, tc.opt, strategy=tc.strategy, npods=tc.npods)
        return init_pod_params(params, strategy=tc.strategy, npods=tc.npods), state

    def init_or_restore(self):
        """The newest checkpoint if there is one (the loader seeks to its
        data step), else :meth:`init_state`."""
        params, state = self.init_state()
        start_step = 0
        latest = self.store.latest_step()
        if latest is not None:
            (params, state), meta = self.store.restore(latest, (params, state))
            start_step = int(meta.get("data_step", latest))
            self.loader.step = start_step
        return params, state, start_step

    def next_batch(self) -> Dict[str, torch.Tensor]:
        """The loader's next batch, on the device."""
        return {k: torch.from_numpy(v).to(self.device) for k, v in self.loader.next_batch().items()}

    def _ckpt_interval(self, step_time_s: float) -> int:
        if self.tc.checkpoint_every is not None:
            return self.tc.checkpoint_every
        save_overhead = max(self.grad_bytes / 1e9, 0.05)  # ~1 GB/s disk
        return optimal_checkpoint_interval(
            step_time_s=max(step_time_s, 1e-3), save_overhead_s=save_overhead, mtbf_s=self.tc.mtbf_s
        )

    def run(
        self,
        *,
        on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
        inject_failure_at: Optional[int] = None,
    ) -> Dict[str, Any]:
        params, state, start = self.init_or_restore()
        tc = self.tc
        last_ckpt = start
        wan_cost = self.geo.sync_cost(tc.strategy, self.grad_bytes, options=self.sync_options)
        recovery_drills = []
        # the scenario's event script, replayed at step boundaries
        events_by_step: Dict[int, list] = {}
        scenario_rollup = None
        if self.scenario is not None and self.scenario.events:
            from ..scenario.runner import ScenarioResult, apply_event

            scenario_rollup = ScenarioResult(scenario=self.scenario, steps=[], sync=None, geo=self.geo)
            for ev in self.scenario.events:
                if ev.kind != "straggler":
                    events_by_step.setdefault(ev.at_step, []).append(ev)
        t_step_ewma = None
        # simulated heartbeat clock: one beat interval per training step, so
        # detection semantics are step-count-based (detect_mult missed
        # steps) regardless of wall-clock step duration.
        interval_ms = next(iter(self.heartbeats.workers.values())).session.interval_ms
        sim_ms = 0.0
        for step in range(start, tc.steps):
            for ev in events_by_step.get(step, ()):
                t0 = time.perf_counter()
                apply_event(ev, self.geo, scenario_rollup, {})
                self.event_s.append({"step": step, "kind": ev.kind, "s": time.perf_counter() - t0})
            batch = self.next_batch()
            self._sync()
            t0 = time.perf_counter()
            params, state, metrics = self.step_fn(params, state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            t_step_ewma = dt if t_step_ewma is None else 0.8 * t_step_ewma + 0.2 * dt

            sim_ms += interval_ms
            for pod in self.heartbeats.workers:
                if inject_failure_at is not None and step >= inject_failure_at and pod == "pod1":
                    continue  # pod1 goes silent
                self.heartbeats.heartbeat(pod, sim_ms)
                self.stragglers.record(pod, dt)
            # +1 ms epsilon: a pod missing detect_mult consecutive beats
            # is declared dead on exactly that step
            dead = self.heartbeats.poll(sim_ms + 1.0)
            if dead:
                plan = plan_recovery(
                    step=step,
                    last_checkpoint_step=last_ckpt,
                    step_time_s=t_step_ewma or dt,
                    detect_time_ms=self.heartbeats.detect_time_ms(),
                    checkpoint_bytes=self.grad_bytes * 3,
                )
                recovery_drills.append({"step": step, "dead": dead, "plan": dataclasses.asdict(plan)})
                inject_failure_at = None  # handled

            row = {
                "step": step,
                "loss": float(metrics["loss"]),
                "step_s": dt,
                "grad_norm": float(metrics.get("grad_norm", 0.0)),
                "wan_bytes": int(metrics["wan_bytes"]),
                "wan_s_est": wan_cost.amortized_seconds,
            }
            self.metrics_log.append(row)
            if on_step:
                on_step(step, row)
            if step % tc.log_every == 0:
                print(
                    f"step {step:5d} loss {row['loss']:7.4f} ({dt * 1e3:8.2f} ms, "
                    f"{row['wan_bytes']} WAN bytes/pod, +{row['wan_s_est']:.2f}s WAN est "
                    f"[{tc.strategy}, {tc.npods} pods])",
                    flush=True,
                )
            interval = self._ckpt_interval(t_step_ewma or dt)
            if (step + 1) % max(interval, 1) == 0 or step == tc.steps - 1:
                self.ckpt.save(step + 1, (params, state), metadata={"data_step": step + 1})
                last_ckpt = step + 1
        self.ckpt.wait()
        self.params, self.state = params, state
        return {
            "final_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
            "metrics": self.metrics_log,
            "recovery_drills": recovery_drills,
            "sync_efficiency": self.stragglers.sync_efficiency(),
            "last_checkpoint": last_ckpt,
            "wan_phases": {p.name: p.duration_s for p in wan_cost.phases},
            "scenario_recoveries": [
                {"mechanism": t.mechanism, "recovery_ms": t.recovery_ms} for t in scenario_rollup.recoveries
            ] if scenario_rollup is not None else [],
            "scenario_evpn_resyncs": len(scenario_rollup.evpn_resyncs) if scenario_rollup is not None else 0,
        }
