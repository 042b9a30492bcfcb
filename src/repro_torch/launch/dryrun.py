"""Multi-pod dry run of the port: does a cell fit, and what binds it, on the production meshes.

Port of ``repro.launch.dryrun``.  For every (architecture x input-shape)
cell, on both production meshes (16 x 16, one pod of 256 GPUs, and 2 x 16
x 16, the paper's two data centres of 512), it traces one train step, one
prefill or one decode step at full width and reports one device's view:
memory, FLOPs and bytes, collective bytes by kind and the WAN share, and a
roofline.

The JAX dry run leans on XLA (``lower``/``compile``, ``memory_analysis``,
``cost_analysis``, the HLO text).  The port has none of these: it runs the
port's own step, as a rank of the mesh runs it, on **fake tensors** (a
``FakeTensorMode``: shapes, dtypes and strides, no storage, nothing
computed) over a **fake process group** of 256 or 512 ranks in this one
process (``torch.testing._internal.distributed.fake_pg``: its collectives
return at once and move nothing), and counts what the rank does with
:class:`~repro_torch.launch.counting.DeviceCounter`: FLOPs by operand type
from ``torch.utils.flop_counter``'s registry (the kernels' custom ops
included), bytes as every op's operands plus outputs (XLA's "bytes
accessed"), the collectives it issues (:mod:`.collectives`) and the live
storage's peak.  Nothing is allocated and no card is needed.

By default the trace takes the card's routes: every kernel wrapper calls
its custom op, whose fake implementation gives the outputs' shapes and
whose FLOP formula comes from :mod:`repro_torch.kernels.costs`.  The fake
tensors lie on the CPU device with :func:`repro_torch.kernels.card_routes`
on (autograd cannot take a fake CUDA tensor in a build of PyTorch without
CUDA); nothing in the step but the kernel wrappers depends on the device.
``--device cpu`` traces the plain routes instead (the attention reference's
S x S scores, the recurrences' loops).

The record (``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``) keeps
the JAX record's keys.  ``memory``: ``argument_bytes`` are the step's
inputs as one device holds them (its shards of the parameters, optimizer
state and cache, its rows of the batch, decode's position as one int32, as
the JAX step takes it); ``output_bytes`` the step's outputs;
``alias_bytes`` the outputs that are inputs' storage (decode writes its
cache in place); ``peak_estimate_bytes`` the live storage's peak, the
inputs as the port's step takes them included (the global batch, which
each rank slices); ``temp_bytes`` the rest of the peak, so that the peak is
``argument + temp + output - alias`` as in the JAX record; ``by_category``
what was live at the peak.

Two differences from the JAX dry run:

* **Constants.** The roofline takes an NVIDIA H100 SXM's data-sheet
  figures, not measurements: dense bf16 989e12 FLOP/s (float32 work at its
  own rates, :data:`repro_torch.kernels.costs.PEAK_FLOPS`), HBM 3.35e12
  B/s, 80 GB a device for ``fits``, and 50e9 B/s a GPU for collectives:
  one NDR 400 Gb/s port per H100, which a 16-wide axis of a 256-GPU pod
  crosses.
* **No ``attn_scan_correction``.** The port has no scan: it loops over its
  layer groups in Python, and its flash op counts the pairs its mask
  keeps, so the main trace counts every layer's work.  The roofline is the
  main trace's (remat's recomputation included); the 1- and 2-group probes
  are kept for the same ``per_group`` / ``base`` / ``estimated_total``
  record.

The prefill is traced with the residual's sequence over ``model``
between blocks, as the JAX dry run lowers it; the train step shards it so
itself (sequence parallelism, :mod:`repro_torch.distributed.act_sharding`),
and is traced without donation, as the JAX ``_lower_train``.

A cell that raises is recorded as ``status: error`` with its message, as
the JAX dry run records one; none is skipped quietly.

Usage (``PYTHONPATH=src``):
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh both
    python -m repro_torch.launch.dryrun --all --mesh both [--skip-existing] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..configs import ASSIGNED_ARCHS, get_config
from ..distributed.placement import place_tree
from ..distributed.sharding import cache_placements
from ..distributed.steps import (init_pod_params, init_train_state, intra_placements, make_decode_step,
                                 make_prefill_step, make_train_step, place_batch)
from ..kernels import card_routes, costs
from ..models import prefill
from ..optim.adamw import AdamWConfig
from ..tree import tree_map
from .counting import DeviceCounter, local_tensors
from .mesh import chips_per_pod, intra_pod_mesh, is_group_mesh, make_production_mesh, mesh_shape
from .shapes import SHAPES, input_specs, params_specs, shape_supported, token_specs

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# NVIDIA H100 SXM data sheet (roofline; not measurements)
HBM_BW = costs.HBM_BYTES_PER_S
HBM_BYTES = costs.HBM_BYTES
NET_BW = 50e9  # one NDR 400 Gb/s port a GPU

TRACE_DEVICE = torch.device("cpu")  # fake tensors lie here; the routes follow --device


def _start_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, this
    process its rank 0; an earlier one of another size is destroyed."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _mesh_for(name: str):
    """The production mesh ``name`` on a fake process group of its size."""
    _start_fake_world(512 if name == "multi" else 256)
    mesh = make_production_mesh(multi_pod=(name == "multi"), device=TRACE_DEVICE)
    intra_pod_mesh(mesh)  # its sub-mesh made now: a mesh is not built under fake tensors
    return mesh


@contextlib.contextmanager
def fake_tensors(device: str = "cuda"):
    """Fake tensors on :data:`TRACE_DEVICE`, taking the card's kernel routes
    for ``device`` ``"cuda"`` and the plain ones for ``"cpu"``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True), (card_routes() if device == "cuda" else contextlib.nullcontext()):
        yield


def _fake(meta_tree):
    """Fake tensors of a tree of meta-device specs."""
    return tree_map(lambda m: torch.empty(tuple(m.shape), dtype=m.dtype, device=TRACE_DEVICE), meta_tree)


def pod_size_of(mesh) -> int:
    """Ranks a pod: what the collectives' classification divides by (0
    without a pod axis)."""
    return chips_per_pod(mesh) if mesh is not None and "pod" in mesh_shape(mesh) else 0


def trace(run: Callable[[], object], inputs: Dict[str, object], *, argument_bytes: int, pod_size: int = 0,
          output: Optional[Callable[[object], object]] = None,
          extra: Optional[Callable[[object], dict]] = None) -> dict:
    """``run()`` under a :class:`DeviceCounter` -> the record's ``main``.

    ``inputs``: category -> the tree the step takes (already made, fake),
    counted live from the start; ``argument_bytes``: their bytes as one
    device holds them (the record's); ``output``: the part of ``run()``'s
    result the record counts as outputs (all of it by default); ``extra``:
    more entries of ``main`` from that result."""
    counter = DeviceCounter(pod_size)
    for category, tree in inputs.items():
        counter.track(tree, category)
    in_keys = counter.storage_keys(list(inputs.values()))
    with counter:
        result = run()
    out_keys = counter.storage_keys(result if output is None else output(result))
    output_bytes = sum(out_keys.values())
    alias = sum(b for k, b in out_keys.items() if k in in_keys)
    peak = counter.peak
    colls = counter.collectives
    more = extra(result) if extra is not None else {}
    del result
    return more | {
        "flops_per_device": counter.flops,
        "flops_by_type": dict(counter.flops_by_type),
        "bytes_per_device": float(counter.bytes),
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": peak - argument_bytes - output_bytes + alias,
            "alias_bytes": alias,
            "peak_estimate_bytes": peak,
            "by_category": counter.peak_by_category,
        },
        "collectives": {
            "by_kind": colls.bytes_by_kind,
            "total_bytes": colls.total_bytes,
            "cross_pod_bytes": colls.cross_pod_bytes,
            "unclassified_bytes": colls.unclassified_bytes,
            "count": colls.count,
            "by_shape": colls.by_shape,
        },
        "ops": counter.ops,
    }


def local_bytes(tree) -> int:
    """Bytes of a tree's tensors as one device holds them (a DTensor's local shard)."""
    return sum(t.numel() * t.element_size() for t in local_tensors(tree))


def _params(cfg, mesh, strategy: str = "hier", npods: Optional[int] = None):
    """Fake parameters as the step takes them (on a group mesh, the rank's)."""
    return init_pod_params(_fake(params_specs(cfg)), strategy=strategy, npods=npods, mesh=mesh)


def _rows(batch, mesh):
    """The rank's rows of the global batch, placed as the step places them."""
    return place_batch(batch, mesh) if is_group_mesh(mesh) else batch


def trace_train_step(cfg, batch_specs, *, strategy: str, opt_cfg: AdamWConfig, mesh=None, npods: Optional[int] = None,
                     device: str = "cuda") -> dict:
    """One train step (``make_train_step``, not donating) on a global batch of
    ``batch_specs`` (meta tensors), traced: on a group ``mesh`` one rank's;
    without one the one-process step ``GeoTrainer`` builds, its ``npods``
    pods one after another on the one device.  ``main["wan_bytes_rank"]``
    is what the step's own metrics count as the rank's WAN bytes."""
    with fake_tensors(device):
        params = _params(cfg, mesh, strategy, npods)
        state = init_train_state(params, opt_cfg, strategy=strategy, npods=npods, mesh=mesh)
        batch = _fake(batch_specs)
        step = make_train_step(cfg, mesh=mesh, npods=npods, strategy=strategy, opt_cfg=opt_cfg, device=TRACE_DEVICE)
        args = local_bytes(params) + local_bytes(state) + local_bytes(_rows(batch, mesh))
        return trace(lambda: step(params, state, batch),
                     {"parameters": params, "optimizer_state": state, "inputs": batch},
                     argument_bytes=args, pod_size=pod_size_of(mesh), output=lambda out: out[:2],
                     extra=lambda out: {"wan_bytes_rank": int(out[2].get("wan_bytes_rank", out[2]["wan_bytes"]))})


def trace_prefill(cfg, batch_specs, *, max_len: Optional[int] = None, mesh=None, device: str = "cuda") -> dict:
    """A prefill of a batch of ``batch_specs`` (meta tensors), traced: on a
    group ``mesh`` one rank's ``make_prefill_step``, the residual's sequence
    over ``model`` between blocks, as the JAX dry run lowers it; without
    one ``prefill`` in one process (the serving path's first call)."""
    with fake_tensors(device):
        params = _params(cfg, mesh)
        batch = _fake(batch_specs)
        if is_group_mesh(mesh):
            step, _ = make_prefill_step(cfg, mesh, device=TRACE_DEVICE, sequence_parallel=True)
            run = lambda: step(params, batch, max_len)  # noqa: E731
        else:
            run = lambda: prefill(params, batch, cfg, max_len=max_len)  # noqa: E731
        args = local_bytes(params) + local_bytes(_rows(batch, mesh))
        return trace(run, {"parameters": params, "inputs": batch}, argument_bytes=args, pod_size=pod_size_of(mesh))


def trace_decode(cfg, mesh, shape_name: str, *, device: str = "cuda") -> dict:
    """One rank's decode step (``make_decode_step``) at ``shape_name``: a
    token at the last position against a ``seq_len``-deep cache, the rank's
    shards of its pod's cache (the pod's rows, as its prefill leaves them)."""
    from ..models.transformer import init_decode_cache

    spec = SHAPES[shape_name]
    with fake_tensors(device):
        params = _params(cfg, mesh)
        pods = mesh_shape(mesh).get("pod", 1) if is_group_mesh(mesh) else 1
        meta_cache = init_decode_cache(cfg, spec.global_batch // pods, spec.seq_len, device="meta")
        cache = _fake(meta_cache)
        if intra_pod_mesh(mesh) is not None:
            want = intra_placements(cache_placements(meta_cache, mesh), mesh)
            cache = place_tree(cache, intra_pod_mesh(mesh), want)
        tokens = _fake({"t": input_specs(cfg, shape_name)["tokens_t"]})["t"]
        step, _ = make_decode_step(cfg, mesh, device=TRACE_DEVICE)
        args = local_bytes(params) + local_bytes(cache) + local_bytes(_rows({"t": tokens}, mesh)) + 4  # + position
        return trace(lambda: step(params, tokens, cache, spec.seq_len - 1),
                     {"parameters": params, "cache": cache, "inputs": tokens}, argument_bytes=args,
                     pod_size=pod_size_of(mesh))


def trace_cell(cfg, mesh, shape_name: str, *, device: str = "cuda") -> dict:
    """The cell's step traced on fake tensors -> the record's ``main``; the
    train step as the JAX ``_lower_train`` sets it: strategy ``hier`` on the
    multi mesh and ``allreduce`` on the single one, ``AdamWConfig()``."""
    spec = SHAPES[shape_name]
    if spec.kind == "train":
        strategy = "hier" if "pod" in mesh_shape(mesh) else "allreduce"
        return trace_train_step(cfg, input_specs(cfg, shape_name)["batch"], strategy=strategy,
                                opt_cfg=AdamWConfig(), mesh=mesh, device=device)
    if spec.kind == "prefill":
        return trace_prefill(cfg, input_specs(cfg, shape_name)["batch"], mesh=mesh, device=device)
    return trace_decode(cfg, mesh, shape_name, device=device)


def probe_costs(cfg, mesh, shape_name: str, *, device: str = "cuda") -> dict:
    """The L = |pattern| and L = 2 |pattern| probes -> per-group costs."""
    plen = len(cfg.pattern)
    probes = {}
    for mult in (1, 2):
        pcfg = dataclasses.replace(cfg, num_layers=mult * plen, scan_layers=False, remat="none")
        probes[mult] = trace_cell(pcfg, mesh, shape_name, device=device)
    g_flops = probes[2]["flops_per_device"] - probes[1]["flops_per_device"]
    g_bytes = probes[2]["bytes_per_device"] - probes[1]["bytes_per_device"]
    g_coll = probes[2]["collectives"]["total_bytes"] - probes[1]["collectives"]["total_bytes"]
    n_groups_total = cfg.num_layers / plen  # fractional remainder ok
    base_flops = probes[1]["flops_per_device"] - g_flops
    base_bytes = probes[1]["bytes_per_device"] - g_bytes
    base_coll = probes[1]["collectives"]["total_bytes"] - g_coll
    return {
        "per_group": {"flops": g_flops, "bytes": g_bytes, "collective_bytes": g_coll},
        "base": {"flops": base_flops, "bytes": base_bytes, "collective_bytes": base_coll},
        "estimated_total": {
            "flops": base_flops + g_flops * n_groups_total,
            "bytes": base_bytes + g_bytes * n_groups_total,
            "collective_bytes": base_coll + g_coll * n_groups_total,
        },
        "probe1": probes[1],
        "probe2": probes[2],
    }


def model_flops(cfg, shape_name: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); decode: D = batch."""
    spec = SHAPES[shape_name]
    n = cfg.active_param_count()
    if spec.kind == "train":
        tokens = spec.seq_len * spec.global_batch
        return 6.0 * n * tokens
    if spec.kind == "prefill":
        tokens = spec.seq_len * spec.global_batch
        return 2.0 * n * tokens  # forward only
    return 2.0 * n * spec.global_batch  # one token per sequence


def roofline(main: dict, model_flops_total: float, chips: int) -> dict:
    """Compute, memory and collective seconds of one device at the data
    sheet's rates, and which is largest."""
    r = {
        "compute_s": costs.ops_seconds(main["flops_by_type"]),
        "memory_s": main["bytes_per_device"] / HBM_BW,
        "collective_s": main["collectives"]["total_bytes"] / NET_BW,
        "model_flops_ratio": model_flops_total / chips / max(main["flops_per_device"], 1.0),
    }
    terms = {k: r[f"{k}_s"] for k in ("compute", "memory", "collective")}
    r["bottleneck"] = max(terms, key=terms.get)
    return r


def run_cell(arch: str, shape_name: str, mesh_name: str, *, probes: bool, out_dir: Path,
             device: str = "cuda") -> dict:
    cfg = get_config(arch)
    ok, why = shape_supported(cfg, shape_name)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "device": device,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        return record
    mesh = _mesh_for(mesh_name)
    chips = 1
    for s in mesh_shape(mesh).values():
        chips *= s
    t0 = time.time()
    record["main"] = trace_cell(cfg, mesh, shape_name, device=device)
    record["trace_seconds"] = time.time() - t0
    if probes:
        t0 = time.time()
        record["probes"] = probe_costs(cfg, mesh, shape_name, device=device)
        record["probes"]["seconds"] = time.time() - t0
    record["status"] = "ok"
    record["chips"] = chips
    record["model_flops_total"] = model_flops(cfg, shape_name)
    record["fits"] = record["main"]["memory"]["peak_estimate_bytes"] <= HBM_BYTES
    if mesh_name == "single":  # roofline terms (single-pod only, as the JAX record)
        record["roofline"] = roofline(record["main"], record["model_flops_total"], chips)
    return record


def _run_one(arch: str, shape_name: str, mesh_name: str, probes: bool, out_dir: Path, device: str) -> dict:
    path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    t0 = time.time()
    try:
        rec = run_cell(arch, shape_name, mesh_name, probes=probes, out_dir=out_dir, device=device)
    except Exception as e:  # noqa: BLE001 — record and continue
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name, "device": device,
            "status": "error", "error": str(e)[:2000],
            "traceback": traceback.format_exc()[-4000:],
        }
    rec["wall_seconds"] = time.time() - t0
    path.write_text(json.dumps(rec, indent=2))
    return rec


def _print_cell(rec: dict, wall: float) -> None:
    status = rec.get("status", "error")
    extra = ""
    if status == "ok":
        mem = rec["main"]["memory"]["peak_estimate_bytes"] / 2**30
        extra = f"peak={mem:.2f}GiB colls={rec['main']['collectives']['count']}"
        if "roofline" in rec:
            r = rec["roofline"]
            extra += (
                f" compute={r['compute_s']*1e3:.1f}ms mem={r['memory_s']*1e3:.1f}ms"
                f" coll={r['collective_s']*1e3:.1f}ms bottleneck={r['bottleneck']}"
            )
    elif status == "error":
        extra = rec.get("error", "").splitlines()[0][:200] if rec.get("error") else ""
    print(
        f"[{status}] {rec['arch']} {rec['shape']} {rec['mesh']} ({wall:.0f}s) {extra}",
        flush=True,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ASSIGNED_ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the routes traced: the card's kernels (default) or the plain versions")
    ap.add_argument(
        "--in-process", action="store_true",
        help="run cells in this process (default: one subprocess per cell, "
        "so that a cell that kills its process cannot end the sweep)",
    )
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(ASSIGNED_ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    single_cell = len(archs) == 1 and len(shapes) == 1 and len(meshes) == 1

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
                if args.skip_existing and path.exists():
                    try:
                        if json.loads(path.read_text()).get("status") in ("ok", "skipped"):
                            print(f"[skip] {path.name}")
                            continue
                    except Exception:  # noqa: BLE001
                        pass
                probes = not args.no_probes and mesh_name == "single"
                t0 = time.time()
                if single_cell or args.in_process:
                    rec = _run_one(arch, shape_name, mesh_name, probes, out_dir, args.device)
                else:
                    rec = _run_subprocess(arch, shape_name, mesh_name, out_dir, args, path)
                if rec.get("status") == "error":
                    failures.append(path.name)
                _print_cell(rec, time.time() - t0)
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall requested dry-run cells passed")


def _run_subprocess(arch, shape_name, mesh_name, out_dir, args, path) -> dict:
    """One cell in its own process: a fake group's world is set once a
    process, and a cell that kills its process ends only itself."""
    cmd = [
        sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape_name,
        "--mesh", mesh_name, "--out", str(out_dir), "--device", args.device,
    ]
    if args.no_probes:
        cmd.append("--no-probes")
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH")) if p))
    path.unlink(missing_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if path.exists():
        return json.loads(path.read_text())
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "device": args.device,
        "status": "error", "error": f"worker died rc={proc.returncode}",
        "stderr_tail": proc.stderr[-3000:],
    }
    path.write_text(json.dumps(rec, indent=2))
    return rec


if __name__ == "__main__":
    main()
