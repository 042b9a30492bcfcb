"""The pod axis as a ``torch.distributed`` process group: the ranks of the data centers.

:func:`spawn` starts one process per rank in ``spawn`` mode (a fork after
CUDA is initialised fails), after building the CUDA kernels once in the
parent so that the ranks do not race on the build directory.  Each rank
joins a gloo group through a ``FileStore`` with an explicit timeout, so a
collective that hangs fails instead of waiting forever; on the card every
rank sets the same device (NCCL refuses two ranks on one GPU, gloo does
not).  All ranks run on this host, so the launcher points gloo at the
loopback interface (``GLOO_SOCKET_IFNAME=lo``) unless the caller has set
the variable.

:class:`PodGroup` wraps the three collectives the WAN strategies need,
``all_reduce``, ``all_gather`` and ``broadcast``.  Each call counts the
bytes of the tensor it was handed and the host seconds it took, under its
op's name; the strategy's WAN bytes are a function of those counts
(:func:`repro_torch.distributed.sync.group_wan_bytes`).  Collectives that
are not WAN traffic of the strategy (the step's loss and metrics, step
times for the monitors, checkpoint gathers) pass ``wan=False`` and are
neither counted nor timed.  Gloo takes CUDA tensors of these three ops
(float32, bfloat16 and int8 alike) and moves them through host memory
itself, so no tensor is staged by the port.

With ``data`` or ``model`` axes a pod is several ranks and ``spawn`` takes
``pods x data x model`` of them; a rank's :class:`PodGroup` is the ``pod``
sub-group of its ``(data, model)`` coordinate, so its counted collectives
carry the rank's piece of each leaf.  The collectives between the ranks
of one pod are LAN traffic, counted apart by
:class:`~repro_torch.distributed.lan.LanCollectives`, never as WAN bytes.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

COLLECTIVE_TIMEOUT_S = 60.0  # a collective that waits longer fails


class PodGroup:
    """One rank's end of the pod axis.

    ``handed`` and ``seconds``: WAN bytes handed to each op and the host
    seconds spent in it since :meth:`reset`; ``calls``: the number of
    calls.  On the card a WAN collective synchronises the device before
    and after, so its seconds hold the transfer and not the compute
    queued before it."""

    def __init__(self, group=None, *, device: DeviceLike = "cuda"):
        self.group = group
        self.device = resolve_device(device)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.root = dist.get_global_rank(group, 0) if group is not None else 0
        self.reset()

    def reset(self) -> None:
        self.handed: Counter = Counter()
        self.seconds: Counter = Counter()
        self.calls: Counter = Counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, op: str, t: torch.Tensor, wan: bool, call: Callable[[], Any]) -> None:
        if not wan:
            call()
            return
        self._sync()
        t0 = time.perf_counter()
        call()
        self._sync()
        self.seconds[op] += time.perf_counter() - t0
        self.handed[op] += t.numel() * t.element_size()
        self.calls[op] += 1

    @property
    def wan_seconds(self) -> float:
        return float(sum(self.seconds.values()))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the pods of a contiguous ``t``; returns ``t``."""
        if not t.is_contiguous():
            raise ValueError("all_reduce works in place on a contiguous tensor")
        self._run("all_reduce", t, True, lambda: dist.all_reduce(t, group=self.group))
        return t

    def all_gather(self, t: torch.Tensor, *, wan: bool = True) -> torch.Tensor:
        """Every pod's ``t``, stacked in rank order: ``[size, *t.shape]``."""
        t = t.contiguous()
        out = torch.empty((self.size, *t.shape), dtype=t.dtype, device=t.device)
        self._run("all_gather", t, wan, lambda: dist.all_gather(list(out.unbind(0)), t, group=self.group))
        return out

    def broadcast(self, t: torch.Tensor, *, wan: bool = True) -> torch.Tensor:
        """Rank 0's ``t`` on every pod, in place; returns ``t``."""
        if not t.is_contiguous():
            raise ValueError("broadcast works in place on a contiguous tensor")
        self._run("broadcast", t, wan, lambda: dist.broadcast(t, src=self.root, group=self.group))
        return t

    def gather_to_root(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """Every pod's ``t`` on rank 0 as a host tensor ``[size, *t.shape]``
        (None on the other ranks); not WAN traffic."""
        host = t.detach().to("cpu").contiguous()
        out = [torch.empty_like(host) for _ in range(self.size)] if self.rank == 0 else None
        self._run("gather", host, False, lambda: dist.gather(host, out, dst=self.root, group=self.group))
        return torch.stack(out) if out is not None else None

    def mean_in_rank_order(self, x: torch.Tensor) -> torch.Tensor:
        """The pods' mean of a scalar, summed in rank order as the
        one-process step's ``sum(losses) / npods`` sums; not WAN traffic."""
        vals = self.all_gather(x.detach().reshape(()), wan=False)
        return sum(vals.unbind(0)) / self.size


def _rank_main(fn, rank: int, nprocs: int, store: str, workdir: str, device: str, args):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank runs on this host
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    else:  # the ranks share this host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // nprocs))
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, nprocs), rank=rank, world_size=nprocs,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    try:
        result = fn(rank, *args)
        torch.save(result, Path(workdir) / f"rank{rank}.pt")
    except BaseException:
        (Path(workdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(
    fn: Callable[..., Any],
    nprocs: int,
    *args,
    device: DeviceLike = "cuda",
    join_timeout_s: float = 600.0,
) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``nprocs`` ranks of one gloo group on
    ``device`` and return what each returned, in rank order.

    ``fn`` must be importable by name (a module-level function).  Each
    rank's result is saved with ``torch.save`` and loaded on the host.
    A rank that raises fails the call with its traceback; the other ranks
    are killed.  If the ranks have not all ended ``join_timeout_s`` seconds
    after the start, every rank is killed and ``TimeoutError`` is raised.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels import _build

        _build.build()  # once here, so the ranks find every library built
    workdir = Path(tempfile.mkdtemp(prefix="repro_torch_pods_"))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(fn, r, nprocs, str(workdir / "store"), str(workdir), str(dev), args))
        for r in range(nprocs)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout_s
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(workdir, failed, procs))
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} pod ranks still running after {join_timeout_s} s: killed")
            time.sleep(0.02)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(_failure(workdir, failed, procs))
        return [torch.load(workdir / f"rank{r}.pt", map_location="cpu", weights_only=False) for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)


def _failure(workdir: Path, failed, procs) -> str:
    lines = []
    for r in failed:
        err = workdir / f"rank{r}.err"
        lines.append(f"pod rank {r} exited with {procs[r].exitcode}:\n"
                     + (err.read_text() if err.exists() else "(no traceback)"))
    return "\n".join(lines)
