"""Training-process failure detection — the BFD insight applied upward.

The paper shows (Figs 9/13) that detection latency, not reroute cost,
dominates recovery: default BGP hold timers take 180 s while BFD's
aggressive keepalives converge in ~110 ms.  The training runtime has the
same structure: a pod that stops sending heartbeats must be declared dead
after ``interval * multiplier`` — not after an RPC timeout minutes later —
so the job can restore-and-remesh with minimal lost work.

:class:`HeartbeatMonitor` is that state machine (simulated clock, same
semantics as :class:`repro.core.bfd.BfdSession`), and
:class:`RecoveryPlan` quantifies the paper's economics: lost work =
steps since last checkpoint + detection + restore + re-mesh.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List

from ..core.bfd import BfdSession, BfdState


class WorkerState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class WorkerHealth:
    name: str
    session: BfdSession
    state: WorkerState = WorkerState.HEALTHY


class HeartbeatMonitor:
    """BFD-style liveness over training workers (pods or hosts)."""

    def __init__(
        self,
        workers: List[str],
        *,
        interval_ms: float = 100.0,
        detect_mult: int = 3,
        start_ms: float = 0.0,
    ):
        self.workers: Dict[str, WorkerHealth] = {}
        for w in workers:
            s = BfdSession("monitor", w, interval_ms=interval_ms, detect_mult=detect_mult)
            s.bring_up(start_ms)
            self.workers[w] = WorkerHealth(name=w, session=s)

    def heartbeat(self, worker: str, now_ms: float) -> None:
        wh = self.workers[worker]
        wh.session.on_rx(now_ms)
        if wh.state != WorkerState.DEAD:
            wh.state = WorkerState.HEALTHY

    def poll(self, now_ms: float) -> List[str]:
        """Advance timers; returns newly dead workers."""
        newly_dead = []
        for wh in self.workers.values():
            if wh.state == WorkerState.DEAD:
                continue
            if wh.session.poll(now_ms) == BfdState.DOWN:
                wh.state = WorkerState.DEAD
                newly_dead.append(wh.name)
            elif now_ms - wh.session.last_rx_ms > wh.session.interval_ms * 1.5:
                wh.state = WorkerState.SUSPECT
            else:
                # heartbeats resumed inside the suspect window: a SUSPECT
                # worker must fall back to HEALTHY even when the rx path
                # touched the session directly rather than heartbeat().
                wh.state = WorkerState.HEALTHY
        return newly_dead

    def alive(self) -> List[str]:
        return [w for w, wh in self.workers.items() if wh.state != WorkerState.DEAD]

    def detect_time_ms(self) -> float:
        any_worker = next(iter(self.workers.values()))
        return any_worker.session.detect_time_ms


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """Quantified recovery timeline after a pod/worker failure."""

    detection_s: float
    restore_s: float
    remesh_s: float
    lost_steps: int
    step_time_s: float

    @property
    def lost_work_s(self) -> float:
        return self.lost_steps * self.step_time_s

    @property
    def total_downtime_s(self) -> float:
        return self.detection_s + self.restore_s + self.remesh_s

    @property
    def total_cost_s(self) -> float:
        return self.total_downtime_s + self.lost_work_s


def plan_recovery(
    *,
    step: int,
    last_checkpoint_step: int,
    step_time_s: float,
    detect_time_ms: float,
    checkpoint_bytes: float,
    restore_bandwidth_gbps: float = 10.0,
    remesh_s: float = 30.0,
) -> RecoveryPlan:
    """Cost model used by the trainer to choose checkpoint cadence."""
    restore_s = checkpoint_bytes * 8 / (restore_bandwidth_gbps * 1e9)
    return RecoveryPlan(
        detection_s=detect_time_ms / 1e3,
        restore_s=restore_s,
        remesh_s=remesh_s,
        lost_steps=max(step - last_checkpoint_step, 0),
        step_time_s=step_time_s,
    )


def optimal_checkpoint_interval(
    *, step_time_s: float, save_overhead_s: float, mtbf_s: float
) -> int:
    """Young/Daly optimum: sqrt(2 * delta * MTBF) in steps."""
    import math

    interval_s = math.sqrt(2.0 * save_overhead_s * mtbf_s)
    return max(1, int(interval_s / max(step_time_s, 1e-9)))
