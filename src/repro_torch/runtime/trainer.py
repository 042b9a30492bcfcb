"""GeoTrainer: the geo-distributed training loop.

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
trainer, which measures its compute, skips them.

The pods come from one source: a ``mesh``'s ``"pod"`` size
(:mod:`repro_torch.launch.mesh`), or with ``scenario=`` the spec's
``topology.num_pods``, or else ``TrainerConfig.npods`` (default 1); a
``TrainerConfig.npods`` or mesh that disagrees with another source raises.
A mesh without a ``"pod"`` axis is one pod whatever the scenario says, as
in the JAX trainer: the spec's fabric then prices its WAN sync.
Without a mesh, or on a ``LocalMesh``, the pods run in this process.  On a
group mesh every rank runs the trainer: the loader, seeded the same on
every rank, gives each the same global batch, of which the step takes the
rank's rows.  Rank 0 alone logs and writes checkpoints; the per-pod leaves
(:func:`~repro_torch.distributed.steps.map_pod_leaves`) are gathered to it,
so a group run writes the one-process layout, and on restore each rank
takes its own slice.  The monitors get every pod's own measured step time,
all-gathered; the step time the checkpoint cadence and recovery plans use
is the slowest pod's, the same on every rank.  Each row also holds the
rank's seconds in WAN collectives (``collective_s``, 0 in one process).
On a mesh whose pods are several ranks (``data`` or ``model`` above 1)
the parameters and state are DTensors placed by the sharding rules; a
checkpoint gathers each sharded leaf over its pod before rank 0 writes
the one-process layout, a restore places each rank's shard of it, and
each row adds the rank's WAN share and its LAN bytes and seconds
(``wan_bytes_rank``, ``lan_bytes``, ``lan_s``).
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
from ..distributed import PodGroup, init_pod_params, init_train_state, make_train_step, map_pod_leaves
from ..distributed.placement import full_tree
from ..distributed.steps import place_train_state
from ..launch.mesh import intra_pod_mesh, is_group_mesh, mesh_shape, num_pods, pod_index, pod_process_group
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
    npods: Optional[int] = None  # None: the mesh's or the scenario's pods, else 1
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
        mesh=None,
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
        self.mesh = mesh
        self.tc = dataclasses.replace(self.tc, npods=self._pod_count(mesh, scenario, trainer_cfg.npods))
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
        pod_group = pod_process_group(mesh)
        self.group = PodGroup(pod_group, device=self.device) if pod_group is not None else None
        self.rank = torch.distributed.get_rank() if is_group_mesh(mesh) else 0
        self.pod = pod_index(mesh)
        self.intra = intra_pod_mesh(mesh)
        self.store = CheckpointStore(checkpoint_dir, keep=tc.checkpoint_keep)
        self.ckpt = AsyncCheckpointer(self.store)
        pods = [f"pod{i}" for i in range(tc.npods)]
        self.heartbeats = HeartbeatMonitor(pods, interval_ms=100.0)
        self.stragglers = StragglerMonitor(pods)
        self.loader = loader_for_model(cfg, seq_len=tc.seq_len, global_batch=tc.global_batch, seed=tc.seed)
        self.step_fn = make_train_step(
            cfg, mesh=mesh, npods=tc.npods, strategy=tc.strategy, num_channels=tc.num_channels,
            opt_cfg=tc.opt, diloco_cfg=tc.diloco, device=self.device,
        )
        self.grad_bytes = sum(t.numel() * 4 for t in tree_leaves(init_params(cfg, device="meta")))
        self.metrics_log: List[Dict[str, float]] = []
        self.event_s: List[Dict[str, Any]] = []  # host seconds each replayed scenario event took
        self.params: Any = None
        self.state: Any = None

    @staticmethod
    def _pod_count(mesh, scenario, npods: Optional[int]) -> int:
        sources = {}
        if mesh is not None:
            sources["the mesh"] = num_pods(mesh)
            if "pod" not in mesh_shape(mesh):
                # as the JAX trainer: a mesh without a pod axis trains one
                # pod, and the scenario's DCs only price its WAN sync
                scenario = None
        if scenario is not None:
            sources["the scenario's topology.num_pods"] = scenario.topology.num_pods
        if npods is not None:
            sources["TrainerConfig.npods"] = npods
        if len(set(sources.values())) > 1:
            raise ValueError(f"pod counts disagree: {sources}")
        return next(iter(sources.values()), 1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pod_leaves(self, fn, params, state):
        return map_pod_leaves(fn, params, state, strategy=self.tc.strategy, npods=self.tc.npods)

    def init_state(self):
        """Fresh parameters from the seed and their train state (on a group
        mesh, the rank's own)."""
        tc = self.tc
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        params = init_params(self.cfg, generator=gen, device=self.device)
        state = init_train_state(params, tc.opt, strategy=tc.strategy, npods=tc.npods, mesh=self.mesh)
        return init_pod_params(params, strategy=tc.strategy, npods=tc.npods, mesh=self.mesh), state

    def init_or_restore(self):
        """The newest checkpoint if there is one (the loader seeks to its
        data step), else :meth:`init_state`.  On a group mesh each rank
        reads the one-process layout and keeps its own slice."""
        params, state = self.init_state()
        start_step = 0
        latest = self.store.latest_step()
        if latest is not None:
            if not is_group_mesh(self.mesh):
                (params, state), meta = self.store.restore(latest, (params, state))
            else:
                n, pod = self.tc.npods, self.pod
                own = self._own_layout(params, state)
                like = self._pod_leaves(lambda t: t.expand(n, *t.shape), *own)
                whole, meta = self.store.restore(latest, like)
                params, state = self._pod_leaves(lambda t: t[pod].clone(), *whole)
                if self.intra is not None:  # each rank keeps its shard
                    params = init_pod_params(params, strategy=self.tc.strategy, mesh=self.mesh)
                    state = place_train_state(state, self.mesh, strategy=self.tc.strategy)
            start_step = int(meta.get("data_step", latest))
            self.loader.step = start_step
        return params, state, start_step

    def _own_layout(self, params, state):
        """A rank's (params, state) as one pod's whole tensors: its shards
        gathered over its pod on a pod of several ranks."""
        if self.intra is None:
            return params, state
        lan = self.step_fn.lan
        with lan, lan.uncounted():
            return full_tree(params), full_tree(state)

    def _save(self, step: int, params, state) -> None:
        """Checkpoint ``step``; on a group mesh the sharded leaves are
        gathered over each pod, every rank hands its per-pod leaves to rank
        0, which writes the one-process layout."""
        tree = self._own_layout(params, state)
        if is_group_mesh(self.mesh):
            stack = self.group.gather_to_root if self.group is not None else (lambda t: t.unsqueeze(0))
            tree = self._pod_leaves(stack, *tree)
            if self.rank != 0:
                return
        self.ckpt.save(step, tree, metadata={"data_step": step})

    def _pod_step_s(self, dt: float) -> List[float]:
        """Every monitored pod's measured step time: in one process the
        step's, on a group mesh each rank's own, all-gathered."""
        if self.group is None:
            return [dt] * len(self.heartbeats.workers)
        return self.group.all_gather(torch.tensor(dt, dtype=torch.float64), wan=False).tolist()

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
            pod_dt = self._pod_step_s(dt)
            slowest = max(pod_dt)
            t_step_ewma = slowest if t_step_ewma is None else 0.8 * t_step_ewma + 0.2 * slowest

            sim_ms += interval_ms
            for pod, pod_s in zip(self.heartbeats.workers, pod_dt):
                if inject_failure_at is not None and step >= inject_failure_at and pod == "pod1":
                    continue  # pod1 goes silent
                self.heartbeats.heartbeat(pod, sim_ms)
                self.stragglers.record(pod, pod_s)
            # +1 ms epsilon: a pod missing detect_mult consecutive beats
            # is declared dead on exactly that step
            dead = self.heartbeats.poll(sim_ms + 1.0)
            if dead:
                plan = plan_recovery(
                    step=step,
                    last_checkpoint_step=last_ckpt,
                    step_time_s=t_step_ewma or slowest,
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
                "collective_s": float(metrics.get("collective_s", 0.0)),
            }
            if self.intra is not None:
                row.update(wan_bytes_rank=int(metrics["wan_bytes_rank"]), lan_bytes=int(metrics["lan_bytes"]),
                           lan_s=float(metrics["lan_s"]))
            self.metrics_log.append(row)
            if on_step:
                on_step(step, row)
            if step % tc.log_every == 0 and self.rank == 0:
                print(
                    f"step {step:5d} loss {row['loss']:7.4f} ({dt * 1e3:8.2f} ms, "
                    f"{row['wan_bytes']} WAN bytes/pod, +{row['wan_s_est']:.2f}s WAN est "
                    f"[{tc.strategy}, {tc.npods} pods])",
                    flush=True,
                )
            interval = self._ckpt_interval(t_step_ewma or slowest)
            if (step + 1) % max(interval, 1) == 0 or step == tc.steps - 1:
                self._save(step + 1, params, state)
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
