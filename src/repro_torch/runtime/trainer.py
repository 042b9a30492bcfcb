"""GeoTrainer: the geo-distributed training loop on one device.

Port of the loop of ``repro.runtime.trainer``: each step takes the next
batch of the synthetic loader, runs the train step (per-pod loss and
gradients, cross-pod sync, AdamW) and logs a row with the loss, the step's
wall time (host clock around work that ends in ``torch.cuda.synchronize()``),
the gradient norm and the WAN bytes each pod sent.

Not ported yet, and so left out of this loop: checkpointing (ROADMAP queue
1, item 8), the heartbeat and straggler monitors and their recovery drills,
``GeoFabric``'s WAN pricing of each step, and the scenario path (item 9;
the monitors need the port's own copy of ``repro.core.bfd``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..data import loader_for_model
from ..device import DeviceLike, resolve_device
from ..distributed import init_train_state, make_train_step
from ..models import init_params
from ..models.config import ModelConfig
from ..optim import AdamWConfig


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 128
    global_batch: int = 8
    steps: int = 100
    strategy: str = "hier"
    npods: int = 1
    num_channels: int = 4
    log_every: int = 10
    seed: int = 0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class GeoTrainer:
    def __init__(self, cfg: ModelConfig, *, trainer_cfg: TrainerConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.tc = trainer_cfg
        self.device = resolve_device(device)
        tc = trainer_cfg
        self.loader = loader_for_model(cfg, seq_len=tc.seq_len, global_batch=tc.global_batch, seed=tc.seed)
        self.step_fn = make_train_step(
            cfg, npods=tc.npods, strategy=tc.strategy, num_channels=tc.num_channels,
            opt_cfg=tc.opt, device=self.device,
        )
        self.metrics_log: List[Dict[str, float]] = []
        self.params: Any = None
        self.state: Any = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(self.cfg, generator=gen, device=self.device)
        state = init_train_state(params, self.tc.opt, strategy=self.tc.strategy, npods=self.tc.npods)
        return params, state

    def next_batch(self) -> Dict[str, torch.Tensor]:
        """The loader's next batch, on the device."""
        return {k: torch.from_numpy(v).to(self.device) for k, v in self.loader.next_batch().items()}

    def run(self, *, on_step: Optional[Callable[[int, Dict[str, float]], None]] = None) -> Dict[str, Any]:
        tc = self.tc
        params, state = self.init_state()
        for step in range(tc.steps):
            batch = self.next_batch()
            self._sync()
            t0 = time.perf_counter()
            params, state, metrics = self.step_fn(params, state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            row = {
                "step": step,
                "loss": float(metrics["loss"]),
                "step_s": dt,
                "grad_norm": float(metrics.get("grad_norm", 0.0)),
                "wan_bytes": int(metrics["wan_bytes"]),
            }
            self.metrics_log.append(row)
            if on_step:
                on_step(step, row)
            if step % tc.log_every == 0:
                print(
                    f"step {step:5d} loss {row['loss']:7.4f} ({dt * 1e3:8.2f} ms, "
                    f"{row['wan_bytes']} WAN bytes/pod [{tc.strategy}, {tc.npods} pods])",
                    flush=True,
                )
        self.params, self.state = params, state
        return {
            "final_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
            "metrics": self.metrics_log,
        }
