"""Fault-tolerant checkpointing: atomic, checksummed, async, GC'd.

Port of ``repro.checkpoint.store``, with the JAX package's layout byte for
byte, so either package restores what the other wrote:

    <root>/step_00000123/
        manifest.json     # step, metadata, leaves [{key, file, shape, dtype, crc32}], written_at
        arr_00000.npy ... # one file per leaf
    <root>/step_00000123.COMMITTED   # atomic commit marker

A leaf's ``key`` is the string ``jax.tree_util.keystr`` gives it
(:func:`repro_torch.tree.tree_keystr_items`), e.g.
``[1].adam.m['groups']['slot0']['attn']['wq']``.  Writes go to
``step_X.tmp-<pid>-<tid>`` and are renamed into place, then the commit
marker is written: a crashed writer never leaves a checkpoint that
``latest_step`` would pick up.  Every leaf carries a crc32; restore checks
it and the shape, and raises on a mismatch.  :class:`AsyncCheckpointer`
copies the tensors to host memory synchronously and writes them on a worker
thread, which never touches a CUDA tensor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_keystr_items, tree_map, tree_unflatten


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor (bf16 as float32, which holds it exactly)."""
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flatten(tree) -> List[Tuple[str, np.ndarray]]:
    return [(key, leaf if isinstance(leaf, np.ndarray) else _host_copy(leaf))
            for key, leaf in tree_keystr_items(tree)]


@dataclasses.dataclass
class CheckpointInfo:
    step: int
    path: Path
    metadata: Dict[str, Any]


class CheckpointStore:
    """``clock`` is the store's only wall-clock seam: it stamps
    ``written_at`` in the manifest and the commit-marker content.
    Recovery drills pin it (``clock=lambda: t``) so checkpoint metadata
    is reproducible; the default is real time."""

    def __init__(self, root: str | Path, *, keep: int = 3, clock: Callable[[], float] = time.time):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.clock = clock

    # -- paths ---------------------------------------------------------------

    def _dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def _marker(self, step: int) -> Path:
        return self.root / f"step_{step:08d}.COMMITTED"

    def steps(self) -> List[int]:
        out = []
        for p in self.root.glob("step_*.COMMITTED"):
            try:
                out.append(int(p.stem.split("_")[1].split(".")[0]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def nbytes(self, step: int) -> int:
        """Bytes on disk of a committed step's directory."""
        return sum(f.stat().st_size for f in self._dir(step).iterdir())

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree, metadata: Optional[Dict[str, Any]] = None) -> CheckpointInfo:
        """Write ``tree`` (tensors, or the numpy snapshot of them) as ``step``."""
        named = _flatten(tree)
        tmp = self.root / f"step_{step:08d}.tmp-{os.getpid()}-{threading.get_ident()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: Dict[str, Any] = {
            "step": step,
            "metadata": metadata or {},
            "leaves": [],
            "written_at": self.clock(),
        }
        for i, (key, arr) in enumerate(named):
            fname = f"arr_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append({
                "key": key,
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        final = self._dir(step)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._marker(step).write_text(str(self.clock()))
        self.gc()
        return CheckpointInfo(step=step, path=final, metadata=manifest["metadata"])

    # -- restore -----------------------------------------------------------------

    def restore(self, step: int, like) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf comes back as a tensor of its ``like`` leaf's dtype on its
        device.  Checks every crc32 and shape; raises on a mismatch."""
        d = self._dir(step)
        if not self._marker(step).exists():
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        manifest = json.loads((d / "manifest.json").read_text())
        by_key = {entry["key"]: entry for entry in manifest["leaves"]}
        leaves = []
        for key, placeholder in tree_keystr_items(like):
            entry = by_key.get(key)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(d / entry["file"])
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != entry["crc32"]:
                raise IOError(f"checksum mismatch for {key}: file corrupt ({crc} != {entry['crc32']})")
            if list(arr.shape) != list(placeholder.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(placeholder.shape)}")
            leaves.append(torch.from_numpy(arr).to(device=placeholder.device, dtype=placeholder.dtype))
        return tree_unflatten(like, leaves), manifest["metadata"]

    def restore_latest(self, like):
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        tree, meta = self.restore(step, like)
        return step, tree, meta

    # -- gc -------------------------------------------------------------------

    def gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
            self._marker(s).unlink(missing_ok=True)


class AsyncCheckpointer:
    """Snapshot-now, write-later checkpointing on a worker thread.

    ``snapshot_s`` and ``write_s`` are the host-clock seconds of the last
    save's copy to host memory and of its write to disk."""

    def __init__(self, store: CheckpointStore):
        self.store = store
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.snapshot_s = self.write_s = 0.0

    def save(self, step: int, tree, metadata=None) -> None:
        self.wait()  # one in flight at a time
        t0 = time.perf_counter()
        snapshot = tree_map(_host_copy, tree)
        self.snapshot_s = time.perf_counter() - t0

        def work():
            try:
                t1 = time.perf_counter()
                self.store.save(step, snapshot, metadata)
                self.write_s = time.perf_counter() - t1
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
