#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each printing one JSON line on stdout:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions.
2. ``build``: every kernel of the port compiled from this checkout's sources
   (one ``nvcc`` per source, all started together).
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes and the variants below, with times: the flash
   forward and backward, the WAN int8 quantiser and dequantiser, and the
   RWKV6 WKV recurrence.
4. ``serve``: the serving path, distilgpt2-82m at full width (random
   weights from a seed): prefill of 8 x 1024 tokens, then 32 greedy decode
   steps, with the kernel launch counts of that run; then the card against
   the CPU on a [1, 256] prompt (prefill and 4 decode steps).
5. ``train``: the training path, distilgpt2-82m at full width on 2 emulated
   pods with the ``hier_int8`` WAN sync, global batch 16 x 1024, through
   ``GeoTrainer``: 2 warm-up steps and 10 timed, with the kernel launch
   counts of that run, the emulated fabric's modelled WAN seconds a step
   (``wan_s_est``, held to its value for 324,504,576 gradient bytes, and
   printed for all five strategies), the straggler monitor's sync
   efficiency and the final checkpoint (bytes on disk, snapshot ms, write
   s); then one ``hier_int8`` step at global batch 2 x 128 on the card
   against the CPU (loss, gradient norm, every synced leaf, the whole step).
   ``train_ps`` and ``train_local_sgd``: the same run under the parameter
   server and under local SGD with the DiLoCo outer step (H = 8: step 7 is
   the outer step), each with its WAN bytes held to their analytic values,
   12 + 12 flash launches a step on ``wgmma`` and no ``wan_quant``, and its
   own step on the card against the CPU (for local_sgd an outer step).
   ``train_scenario``: the scenario path, a ``repro_torch.scenario.Scenario``
   (``repro_torch.examples.train_geo``'s spec: 2 DCs, ``hier_int8``, 12
   steps) whose event script (a BFD-detected link flap at steps 3-6, a
   brownout of the DC pair at steps 4-8) is replayed at step boundaries,
   through the trainer ``train_geo`` builds, with the ``train`` phase's
   configuration: its losses must equal ``train``'s (rtol 1e-6), with one
   ``bfd`` recovery, 2 EVPN resyncs and the link up at the end; then the
   paper's Fig. 14 step modelled with this card's median step as compute.
   ``serve_geo``: ``serving_under_flap`` on the host, its metrics held to
   the JAX package's (``SERVING_UNDER_FLAP``), then the peak step's first 8
   trace requests (``request_batch``, ragged prompt lengths) prefilled at
   full width on the card, 6 flash launches each on ``wgmma``, each one's
   logits held to its prefill on the CPU (rtol = atol = 5e-2).
   ``checkpoint``: 4 ``hier_int8`` steps checkpointed every 2 with ``pod1``
   silenced from step 1 (the drill must declare it dead after
   ``detect_mult`` steps), then a new trainer restores step 2 from a copy
   of the directory: its losses must equal the uninterrupted run's (rtol
   1e-6); save and restore seconds and bytes on disk.  Checkpoints go to
   ``build/chip_smoke_checkpoints/`` and are removed after each phase.
6. ``serve_rwkv``: the serving path of rwkv6-7b at full width and full
   depth (32 RWKV layers, 7.5 B parameters, random weights from a seed):
   prefill of 4 x 4096 tokens, then 32 greedy decode steps, with the WKV
   kernel's launches (32 a prefill, 32 a decode step); then a 2-layer cut
   on the card against the CPU on a [1, 256] prompt (prefill and 4 decode
   steps), and the state carried from a 4096-token prefill through one
   decode step against a 4097-token prefill.  It runs after the train
   phases' tensors are released.

Then the ``{"kernels": [...]}`` summary, the card's name and power limit as
``nvidia-smi`` prints them, and, last, ``{"ok": true, "device": ...}``.
A kernel's ``ms`` (and ``library_ms``) is its device time: ``GRAPH_CALLS``
calls captured in one CUDA graph, the replay timed with one event pair and
divided by the count, so the wrapper's host time is left out.  ``call_ms``
(and ``library_call_ms``) is the median of event pairs around single
Python calls, host included, as earlier runs reported ``ms``.  The flash
backward's ``library_ms`` is ``scaled_dot_product_attention``'s forward and
backward together, ``library_bwd_ms`` its backward alone (one forward
outside the graph, the backward captured on the forward's stream).  Each
flash check, and every flash launch of the serve and train phases, is held
to the route ``fwd_route`` / ``bwd_route`` names.
Any failure raises: the script exits non-zero and prints no result.  It
also fails without a card, and where the port's sources are absent.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense: HBM rate and peak rates by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # float32: CUDA cores, no TF32
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # kernel vs plain; rtol = atol
SERVE_TOL = 5e-2  # bf16 logits, card vs CPU: rounding points differ
TRAIN_TOL = 5e-2  # bf16 loss, grad norm, synced leaves (relative norm), card vs CPU

# (label, B, S, H, KVH, hd, dtype, window, softcap, forward route); the
# first is the path's shape
FLASH_CASES = [
    ("path", 8, 1024, 12, 12, 64, "bfloat16", None, None, "wgmma"),
    ("ragged_s1000", 8, 1000, 12, 12, 64, "bfloat16", None, None, "wgmma"),
    ("gqa_h8_kvh2_hd128", 8, 1024, 8, 2, 128, "bfloat16", None, None, "wgmma"),
    ("window256", 8, 1024, 12, 12, 64, "bfloat16", 256, None, "wgmma"),
    ("softcap30", 8, 1024, 12, 12, 64, "bfloat16", None, 30.0, "wgmma"),
    ("f32", 8, 1024, 12, 12, 64, "float32", None, None, "f32"),
    ("phi3v_hd96", 2, 1024, 32, 32, 96, "bfloat16", None, None, "mma_sync"),
    ("padded_hd12_gqa6_2", 2, 1024, 6, 2, 12, "bfloat16", None, None, "mma_sync"),
    ("padded_hd8_gqa7_1", 2, 1024, 7, 1, 8, "bfloat16", None, None, "mma_sync"),
]
# (label, B, S, H, KVH, hd, dtype, window, softcap, backward route); the
# first is the train path's shape
FLASH_BWD_CASES = [
    ("path", 8, 1024, 12, 12, 64, "bfloat16", None, None, "wgmma"),
    ("window256", 8, 1024, 12, 12, 64, "bfloat16", 256, None, "wgmma"),
    ("softcap30", 8, 1024, 12, 12, 64, "bfloat16", None, 30.0, "wgmma"),
    ("gqa_h8_kvh2_hd128", 8, 1024, 8, 2, 128, "bfloat16", None, None, "wgmma"),
    ("f32", 8, 1024, 12, 12, 64, "float32", None, None, "f32"),
    ("phi3v_hd96", 2, 1024, 32, 32, 96, "bfloat16", None, None, "mma_sync"),
    ("padded_hd12_gqa6_2", 2, 1024, 6, 2, 12, "bfloat16", None, None, "mma_sync"),
    ("padded_hd8_gqa7_1", 2, 1024, 7, 1, 8, "bfloat16", None, None, "mma_sync"),
]
# head dims the wrappers zero-pad to 16 (each such launch also moves PADDED_LAUNCHES)
PADDED_HDS = (8, 12)
# (label, rows, cols): the stacked 2-pod largest leaves and a ragged one
WAN_CASES = [
    ("embed_2x50257x768", 2 * 50257, 768),
    ("w_up_2x6x768x3072", 2 * 6 * 768, 3072),
    ("ragged_24x300", 24, 300),
]
# (label, B, T, H, N, r/k/v dtype, w dtype, state in place); the first is
# the rwkv6-7b prefill's shape, the second its decode step's
WKV_CASES = [
    ("path_prefill", 4, 4096, 64, 64, "bfloat16", "float32", False),
    ("path_decode_t1_in_place", 4, 1, 64, 64, "bfloat16", "float32", True),
    ("ragged_t1000", 4, 1000, 64, 64, "bfloat16", "float32", False),
    ("n16", 4, 1024, 16, 16, "bfloat16", "float32", False),
    ("n8", 4, 1024, 8, 8, "bfloat16", "bfloat16", False),
    ("f32", 4, 1024, 64, 64, "float32", "float32", False),
    ("t37_off_chunk", 4, 37, 64, 64, "bfloat16", "float32", False),
    ("n128", 4, 1024, 32, 128, "bfloat16", "float32", False),
    ("n32", 4, 1024, 128, 32, "bfloat16", "float32", False),
]
WKV_TOL = {"bfloat16": 5e-2, "float32": 1e-4}  # TestWkv6's, by the r/k/v dtype
B_SERVE, PROMPT, GEN = 8, 1024, 32
B_RWKV, PROMPT_RWKV, GEN_RWKV = 4, 4096, 32
RWKV_PARAMS, RWKV_LEAVES = 7_534_682_112, 27  # jax.eval_shape of init_params
NPODS, B_TRAIN, SEQ_TRAIN, STEPS, WARMUP = 2, 16, 1024, 12, 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


GRAPH_CALLS = 20  # calls captured in one CUDA graph for a device time
MS_IS = "device time: calls captured in one CUDA graph, the replay timed with one event pair, / calls"


def device_ms(fn, calls: int = GRAPH_CALLS, replays: int = 5, stream=None) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph
    (after warm-up calls on a side stream), the median replay of
    ``replays``, each timed with one event pair, divided by ``calls``.
    The host's time per call (checks, allocation, the launch) is left out.
    ``stream``, if given, is the side stream and the capture's: an autograd
    backward must be captured on the stream its forward ran on.
    A failed capture raises: there is no fallback to the per-call time."""
    import torch

    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()  # warm
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event-timed calls after ``warmup`` calls:
    each pair also holds the host's time for the call."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Query-key pairs the mask keeps: the work this input needs."""
    q = np.arange(sq)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound(nbytes, flops, dtype):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_flops(b, s, h, hd, window):
    return 4 * b * h * hd * attention_pairs(s, s, True, window)  # q.k and p.v


def flash_bound(b, s, h, kvh, hd, dtype, window):
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * s * h * hd + 2 * b * s * kvh * hd) * itemsize  # q, o; k, v
    return bound(nbytes, flash_flops(b, s, h, hd, window), dtype)


def flash_bwd_bound(b, s, h, kvh, hd, dtype, window):
    itemsize = 2 if dtype == "bfloat16" else 4
    # q, o, dO read and dQ written; k, v read and dK, dV written; lse read
    nbytes = (4 * b * s * h * hd + 4 * b * s * kvh * hd) * itemsize + 4 * b * h * s
    flops = 10 * b * h * hd * attention_pairs(s, s, True, window)  # five products
    return bound(nbytes, flops, dtype)


def wan_bytes(rows, cols):
    """Bytes quantisation (or dequantisation) of a [rows, cols] float32
    matrix moves: the float32 values, the padded int8 and the scales."""
    nblocks = -(-cols // 256)
    return rows * cols * 4 + rows * nblocks * 256 + rows * nblocks * 4


def wkv_bound(b, t, h, n, rkv_dtype, w_dtype):
    """Each input read once (r, k, v, w; u; state0), each output written once
    (out float32, the final state); 4 N^2 float32 operations per (b, t, h)."""
    isz = {"bfloat16": 2, "float32": 4}
    elems = b * t * h * n
    nbytes = elems * (3 * isz[rkv_dtype] + isz[w_dtype] + 4) + h * n * 4 + 2 * b * h * n * n * 4
    return bound(nbytes, 4 * n * n * b * t * h, "float32")


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({
        "phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "python": sys.version.split()[0],
    })
    return smi


# ptxas lines the build phase keeps: registers, spills, and the warnings
# that it serialised a wgmma pipeline (C7513, C7515, C7520)
PTXAS_KEEP = ("registers", "spill", "C7513", "C7515", "C7520", "Compiling entry")


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if any(k in ln for k in PTXAS_KEEP)]
        for name, (_, log) in report.items()
    }
    serialised = [ln for lines in ptxas.values() for ln in lines if any(k in ln for k in PTXAS_KEEP[2:5])]
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "compiled": {n: sec for n, (sec, _) in report.items()}, "ptxas": ptxas,
        "wgmma_serialised": serialised,
    })


def phase_kernels(torch):
    """The flash forward's checks (the serving path's shape first)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES, flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.ops import PADDED_LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for label, b, s, h, kvh, hd, dtype, window, cap, route in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dt)
        kw = dict(causal=True, window=window, logit_softcap=cap)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        routes, padded = dict(ROUTE_LAUNCHES), PADDED_LAUNCHES["flash_attention_fwd"]
        out = flash_attention(q, k, v, **kw)
        took = {r: n - routes.get(r, 0) for r, n in ROUTE_LAUNCHES.items() if n != routes.get(r, 0)}
        if took != {route: 1}:
            raise AssertionError(f"flash_attention_fwd {label}: launched on routes {took}, expected {route}")
        if PADDED_LAUNCHES["flash_attention_fwd"] - padded != (hd in PADDED_HDS):
            raise AssertionError(f"flash_attention_fwd {label}: padded count moved "
                                 f"{PADDED_LAUNCHES['flash_attention_fwd'] - padded}, hd {hd}")
        plain = flash_attention_ref(qh, kh, vh, **kw)[0].transpose(1, 2)
        torch.cuda.synchronize()
        diff = (out.float() - plain.float()).abs()
        err, tol = diff.max().item(), TOL[dtype]
        # assert_allclose's form with rtol = atol = tol, as the tests hold it
        if not bool((diff <= tol + tol * plain.float().abs()).all()):
            raise AssertionError(f"flash_attention_fwd {label}: max_abs_err {err}, rtol=atol={tol}")
        library_ms = library_call_ms = None
        if window is None and cap is None:  # the same function as one PyTorch call
            qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))

            def library():
                return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=h != kvh)

            library_ms, library_call_ms = device_ms(library), time_ms(library)
        bound_ms, bound_by = flash_bound(b, s, h, kvh, hd, dtype, window)
        ms = device_ms(lambda: flash_attention(q, k, v, **kw))
        checks.append({
            "label": label, "shape": {"B": b, "S": s, "H": h, "KVH": kvh, "hd": hd},
            "dtype": dtype, "window": window, "softcap": cap, "fwd_route": route,
            "padded_to_16": hd in PADDED_HDS,
            "max_abs_err": err, "tol": tol,
            "ms": ms, "call_ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
            "tflops": flash_flops(b, s, h, hd, window) / (ms * 1e-3) / 1e12,
            "plain_ms": time_ms(lambda: flash_attention_ref(qh, kh, vh, **kw)),
            "library_ms": library_ms, "library_call_ms": library_call_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    emit({"phase": "kernels", "kernel": "flash_attention_fwd", "checks": checks})
    return checks


def phase_kernels_bwd(torch):
    """The flash backward against the plain backward on the same inputs
    (the kernel forward's output and lse), at the train path's shape first."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        BWD_ROUTE_LAUNCHES,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ops import PADDED_LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(1)
    checks = []
    for label, b, s, h, kvh, hd, dtype, window, cap, route in FLASH_BWD_CASES:
        dt = getattr(torch, dtype)
        q, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dt) for _ in range(2))
        kw = dict(causal=True, window=window, logit_softcap=cap)
        out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
        heads = [t.transpose(1, 2) for t in (q, k, v, out, do)]
        routes, padded = dict(BWD_ROUTE_LAUNCHES), PADDED_LAUNCHES["flash_attention_bwd"]
        grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        took = {r: n - routes.get(r, 0) for r, n in BWD_ROUTE_LAUNCHES.items() if n != routes.get(r, 0)}
        if took != {route: 1}:
            raise AssertionError(f"flash_attention_bwd {label}: launched on routes {took}, expected {route}")
        if PADDED_LAUNCHES["flash_attention_bwd"] - padded != (hd in PADDED_HDS):
            raise AssertionError(f"flash_attention_bwd {label}: padded count moved "
                                 f"{PADDED_LAUNCHES['flash_attention_bwd'] - padded}, hd {hd}")
        plain = flash_attention_bwd_ref(*heads[:4], lse, heads[4], **kw)
        torch.cuda.synchronize()
        tol, errs = TOL[dtype], {}
        for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
            want = want.transpose(1, 2).float()
            diff = (got.float() - want).abs()
            errs[name] = diff.max().item()
            if not bool((diff <= tol + tol * want.abs()).all()):
                raise AssertionError(f"flash_attention_bwd {label} {name}: max_abs_err {errs[name]}, rtol=atol={tol}")
        library_ms = library_call_ms = library_bwd_ms = None
        if window is None and cap is None:  # sdpa's forward plus its backward: one pair
            qc, kc, vc = (t.detach().contiguous().requires_grad_(True) for t in heads[:3])
            doc = heads[4].contiguous()

            def sdpa():
                return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=h != kvh)

            def library():
                torch.autograd.grad(sdpa(), (qc, kc, vc), doc)

            library_ms, library_call_ms = device_ms(library), time_ms(library)
            # sdpa's backward alone: its forward once, outside the graph, on
            # the stream the backward is then captured on
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                o = sdpa()
            library_bwd_ms = device_ms(
                lambda: torch.autograd.grad(o, (qc, kc, vc), doc, retain_graph=True), stream=side)
            del o
        bound_ms, bound_by = flash_bwd_bound(b, s, h, kvh, hd, dtype, window)

        def kernel():
            return flash_attention_bwd(q, k, v, out, lse, do, **kw)

        ms = device_ms(kernel)
        checks.append({
            "label": label, "shape": {"B": b, "S": s, "H": h, "KVH": kvh, "hd": hd},
            "dtype": dtype, "window": window, "softcap": cap, "bwd_route": route,
            "padded_to_16": hd in PADDED_HDS,
            "max_abs_err": max(errs.values()), "max_abs_err_dq_dk_dv": errs, "tol": tol,
            "ms": ms, "call_ms": time_ms(kernel),
            "tflops": 10 * b * h * hd * attention_pairs(s, s, True, window) / (ms * 1e-3) / 1e12,
            "plain_ms": time_ms(lambda: flash_attention_bwd_ref(*heads[:4], lse, heads[4], **kw), runs=5),
            "library_ms": library_ms, "library_call_ms": library_call_ms,
            "library_is": "scaled_dot_product_attention forward + backward",
            "library_bwd_ms": library_bwd_ms,
            "library_bwd_is": "scaled_dot_product_attention backward alone (device time)",
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        del q, k, v, do, out, lse, heads, grads, plain
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "checks": checks})
    return checks


def phase_kernels_wan(torch):
    """wan_quant / wan_dequant against their plain versions at the stacked
    2-pod shapes of the largest leaves and a ragged one, then timed over
    every leaf of one train step (distilgpt2-82m, 2 pods: 19 launches each)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.wan_quant import wan_dequant, wan_dequant_ref, wan_quant, wan_quant_ref
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(2)
    checks = []
    for label, rows, cols in WAN_CASES:
        x = torch.randn((rows, cols), generator=gen, device="cuda") * 1e-3
        x[0, : min(cols, 256)] = 0  # an all-zero block: scale 1
        q, s = wan_quant(x)
        qr, sr = wan_quant_ref(x)
        back = wan_dequant(q, s, cols)
        back_ref = wan_dequant_ref(q, s, cols)
        torch.cuda.synchronize()
        dq = (q.int() - qr.int()).abs()
        differing = int((dq != 0).sum())
        if int(dq.max()) > 1 or differing >= 1e-3 * dq.numel():
            raise AssertionError(f"wan_quant {label}: {differing} lanes differ, max |dq| {int(dq.max())}")
        if not torch.allclose(s, sr, rtol=1e-6, atol=0):
            raise AssertionError(f"wan_quant {label}: scales differ beyond rtol 1e-6")
        deq_err = (back - back_ref).abs().max().item()
        if deq_err != 0.0:
            raise AssertionError(f"wan_dequant {label}: max_abs_err {deq_err}, expected exact")
        checks.append({
            "label": label, "rows": rows, "cols": cols, "int8_lanes_differing": differing,
            "int8_max_abs_diff": int(dq.max()), "scales_max_rel_err": ((s - sr).abs() / sr).max().item(),
            "dequant_max_abs_err": deq_err,
            "quant_ms": device_ms(lambda: wan_quant(x)), "quant_call_ms": time_ms(lambda: wan_quant(x)),
            "quant_plain_ms": time_ms(lambda: wan_quant_ref(x)),
            "dequant_ms": device_ms(lambda: wan_dequant(q, s, cols)),
            "dequant_call_ms": time_ms(lambda: wan_dequant(q, s, cols)),
            "dequant_plain_ms": time_ms(lambda: wan_dequant_ref(q, s, cols)),
            "bound_ms": bound(wan_bytes(rows, cols), 0, "float32")[0],
        })

    # One train step's worth: every gradient leaf of the full model, stacked over the pods.
    shapes = [tuple(t.shape) for t in tree_leaves(init_params(get_config("distilgpt2-82m"), device="meta"))]
    mats = []
    for shp in shapes:
        cols = shp[-1] if shp else 1
        mats.append(torch.randn((NPODS * (math.prod(shp) // cols), cols), generator=gen, device="cuda") * 1e-3)
    packed = [wan_quant(m) for m in mats]
    step_bytes = sum(wan_bytes(*m.shape) for m in mats)

    def quant_step():
        return [wan_quant(m) for m in mats]

    def dequant_step():
        return [wan_dequant(q, s, m.shape[1]) for m, (q, s) in zip(mats, packed)]

    step = {
        "leaves": len(mats), "values": sum(m.numel() for m in mats), "bytes": step_bytes,
        "quant_ms": device_ms(quant_step, calls=5), "quant_call_ms": time_ms(quant_step, runs=10),
        "quant_plain_ms": time_ms(lambda: [wan_quant_ref(m) for m in mats], runs=5),
        "dequant_ms": device_ms(dequant_step, calls=5), "dequant_call_ms": time_ms(dequant_step, runs=10),
        "dequant_plain_ms": time_ms(
            lambda: [wan_dequant_ref(q, s, m.shape[1]) for m, (q, s) in zip(mats, packed)], runs=5),
        "bound_ms": bound(step_bytes, 0, "float32")[0], "bound_by": "bytes",
    }
    emit({"phase": "kernels", "kernel": "wan_quant+wan_dequant", "checks": checks, "train_step": step})
    del mats, packed
    return checks, step


def phase_kernels_wkv(torch):
    """wkv6_fwd against its plain version at the rwkv6-7b prefill and decode
    shapes (the decode step's state updated in place) and the variants."""
    from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_ref

    gen = torch.Generator(device="cuda").manual_seed(3)

    def draw(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    checks = []
    for label, b, t, h, n, rkv_dtype, w_dtype, in_place in WKV_CASES:
        r, k, v = (draw((b, t, h, n), 0.5).to(getattr(torch, rkv_dtype)) for _ in range(3))
        w = torch.sigmoid(draw((b, t, h, n), 1.0, 2.0)).to(getattr(torch, w_dtype))
        u = draw((h, n), 0.1)
        s0 = draw((b, h, n, n), 0.1)
        plain_out, plain_state = wkv6_ref(r, k, v, w, u, s0)
        state = s0.clone()
        out, final = wkv6(r, k, v, w, u, state, state_out=state if in_place else None)
        torch.cuda.synchronize()
        if in_place and final is not state:
            raise AssertionError(f"wkv6_fwd {label}: the final state is not the state0 tensor")
        # determinism: a second call from the same state gives the same bits
        again, again_final = wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        if not (torch.equal(out, again) and torch.equal(final, again_final)):
            raise AssertionError(f"wkv6_fwd {label}: two calls on the same inputs differ")
        tol, errs = WKV_TOL[rkv_dtype], {}
        for name, got, want in (("out", out, plain_out), ("state", final, plain_state)):
            diff = (got - want).abs()
            errs[name] = diff.max().item()
            if not bool((diff <= tol + tol * want.abs()).all()):
                raise AssertionError(f"wkv6_fwd {label} {name}: max_abs_err {errs[name]}, rtol=atol={tol}")
        bound_ms, bound_by = wkv_bound(b, t, h, n, rkv_dtype, w_dtype)
        slow = t >= 1000  # the plain loop launches ~6 kernels a step

        def kernel():
            return wkv6(r, k, v, w, u, state, state_out=state if in_place else None)

        checks.append({
            "label": label, "shape": {"B": b, "T": t, "H": h, "N": n}, "rkv_dtype": rkv_dtype,
            "w_dtype": w_dtype, "state_in_place": in_place, "two_calls_equal": True,
            "max_abs_err": max(errs.values()), "max_abs_err_out_state": errs, "tol": tol,
            "ms": device_ms(kernel, calls=5 if slow else GRAPH_CALLS),
            "call_ms": time_ms(kernel, runs=10 if slow else 25),
            "plain_ms": time_ms(lambda: wkv6_ref(r, k, v, w, u, s0), runs=3 if slow else 25,
                                warmup=1 if slow else 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        del r, k, v, w, u, s0, state, out, final, again, again_final, plain_out, plain_state
    emit({"phase": "kernels", "kernel": "wkv6_fwd", "checks": checks})
    return checks


def serve_run(torch, params, batch, cfg, *, prompt, gen, max_len=None):
    """The serving path once: prefill, then ``gen`` greedy decode steps.
    Returns times, the launch counts after prefill and after each decode
    step, whether every logits row was finite and of shape [B, V], and the
    last tokens."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import decode_step, prefill

    b = next(iter(batch.values())).shape[0]
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cfg, max_len=max_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = dict(LAUNCHES)
    shape_ok = tuple(logits.shape) == (b, cfg.vocab_size)
    finite &= torch.isfinite(logits).all()
    tokens = logits.argmax(-1)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(gen)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(gen)]
    after_steps = []
    t0 = time.perf_counter()
    for i in range(gen):
        starts[i].record()
        logits, cache = decode_step(params, tokens, cache, cfg, prompt + i)
        ends[i].record()
        after_steps.append(dict(LAUNCHES))
        shape_ok &= tuple(logits.shape) == (b, cfg.vocab_size)
        finite &= torch.isfinite(logits).all()
        tokens = logits.argmax(-1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    return {
        "t_prefill": t_prefill, "after_prefill": after_prefill, "after_steps": after_steps,
        "t_decode": t_decode, "step_ms": step_ms, "ok": shape_ok and bool(finite), "tokens": tokens,
    }


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_map

    cfg = get_config("distilgpt2-82m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, device="cuda")
    batch = synthetic_prompt_batch(cfg, gen, B_SERVE, PROMPT)
    max_len = PROMPT + GEN

    def run():
        return serve_run(torch, params, batch, cfg, prompt=PROMPT, gen=GEN, max_len=max_len)

    run()  # warm-up: cuBLAS handles, allocator pools, kernel library load
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    res = run()
    launches = dict(LAUNCHES)
    routes = dict(ROUTE_LAUNCHES)
    if routes != {"wgmma": cfg.num_layers}:
        raise AssertionError(f"serve: flash forward routes {routes}, expected {cfg.num_layers} on wgmma")
    peak = torch.cuda.max_memory_allocated()
    t_prefill, after_prefill, t_decode, step_ms, ok, tokens = (
        res[k] for k in ("t_prefill", "after_prefill", "t_decode", "step_ms", "ok", "tokens"))
    if not ok:
        raise AssertionError("serve: logits not finite or of the wrong shape")
    if after_prefill.get("flash_attention_fwd") != cfg.num_layers or launches != after_prefill:
        raise AssertionError(
            f"serve: flash launches {after_prefill} after prefill, {launches} after decode; "
            f"expected {cfg.num_layers} in prefill and none in decode"
        )
    prefill_ms_median = time_ms(lambda: prefill(params, batch, cfg, max_len=max_len), runs=5)

    # The card against the CPU (plain path) on a small prompt: prefill and 4
    # decode steps, both sides fed the card's argmax.
    cpu_params = tree_map(lambda t: t.cpu(), params)
    small = synthetic_prompt_batch(cfg, gen, 1, 256)
    g_logits, g_cache = prefill(params, small, cfg, max_len=260)
    c_logits, c_cache = prefill(cpu_params, tree_map(lambda t: t.cpu(), small), cfg, max_len=260)
    diffs = [_logit_diff(g_logits, c_logits)]
    for i in range(4):
        nxt = g_logits.argmax(-1)
        g_logits, g_cache = decode_step(params, nxt, g_cache, cfg, 256 + i)
        c_logits, c_cache = decode_step(cpu_params, nxt.cpu(), c_cache, cfg, 256 + i)
        diffs.append(_logit_diff(g_logits, c_logits))
    if not all(share <= 1 for _, share in diffs):
        raise AssertionError(f"serve: card vs CPU logits outside rtol=atol={SERVE_TOL}: {diffs}")

    emit({
        "phase": "serve", "arch": cfg.name, "dtype": cfg.dtype, "batch": B_SERVE,
        "prompt": PROMPT, "gen": GEN,
        "prefill_ms": t_prefill * 1e3,
        "prefill_ms_median_of_5_more": prefill_ms_median,
        "prefill_tokens_per_s": B_SERVE * PROMPT / t_prefill,
        "decode_ms_per_step_mean": statistics.fmean(step_ms),
        "decode_ms_per_step_median": statistics.median(step_ms),
        "decode_tokens_per_s": B_SERVE * GEN / t_decode,
        "decode_s": t_decode,
        "peak_memory_bytes": peak,
        "launches_main_path": launches, "fwd_routes_main_path": routes,
        "card_vs_cpu_max_abs_err": [d for d, _ in diffs],
        "card_vs_cpu_worst_share_of_tol": [share for _, share in diffs], "card_vs_cpu_tol": SERVE_TOL,
        "last_tokens": tokens.tolist(),
    })
    return launches


def phase_serve_rwkv(torch):
    """rwkv6-7b at full width and depth: the serving path through the WKV kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("rwkv6-7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params, n_leaves = sum(t.numel() for t in leaves), len(leaves)
    del leaves
    if (n_params, n_leaves) != (RWKV_PARAMS, RWKV_LEAVES):
        raise AssertionError(f"serve_rwkv: {n_params} parameters in {n_leaves} leaves, "
                             f"expected {RWKV_PARAMS} in {RWKV_LEAVES}")
    # one token more than the prompt: the state-carry check decodes it
    tokens = synthetic_prompt_batch(cfg, gen, B_RWKV, PROMPT_RWKV + 1)["tokens"]
    batch = {"tokens": tokens[:, :PROMPT_RWKV]}

    def run():
        return serve_run(torch, params, batch, cfg, prompt=PROMPT_RWKV, gen=GEN_RWKV)

    run()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    res = run()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not res["ok"]:
        raise AssertionError("serve_rwkv: logits not finite or of the wrong shape")
    per_layer = cfg.num_layers
    counts = [res["after_prefill"]] + res["after_steps"]
    wkv_counts = [c.get("wkv6_fwd", 0) for c in counts]
    expected = [per_layer * (1 + i) for i in range(GEN_RWKV + 1)]
    if wkv_counts != expected or set(launches) != {"wkv6_fwd"}:
        raise AssertionError(f"serve_rwkv: wkv6_fwd launches {wkv_counts} after prefill and each "
                             f"decode step, expected {expected}; all launches {launches}")
    prefill_ms_median = time_ms(lambda: prefill(params, batch, cfg), runs=3, warmup=0)

    # The state carried through decode: prefill of T then one decode step
    # against a prefill of T + 1, at full depth.
    _, cache = prefill(params, batch, cfg)
    carried, _ = decode_step(params, tokens[:, PROMPT_RWKV], cache, cfg, PROMPT_RWKV)
    whole, _ = prefill(params, {"tokens": tokens}, cfg)
    carry_err = ((carried.float() - whole.float()).norm() / whole.float().norm()).item()
    if not carry_err <= SERVE_TOL:
        raise AssertionError(f"serve_rwkv: state carry relative norm error {carry_err} > {SERVE_TOL}")
    del params, cache, carried, whole
    torch.cuda.empty_cache()

    # The card against the CPU (plain path): a 2-layer cut at full width.
    cut = dataclasses.replace(cfg, num_layers=2)
    params = init_params(cut, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    cut_params = sum(t.numel() for t in tree_leaves(params))
    cpu_params = tree_map(lambda t: t.cpu(), params)
    small = synthetic_prompt_batch(cut, gen, 1, 256)
    g_logits, g_cache = prefill(params, small, cut)
    t0 = time.perf_counter()
    c_logits, c_cache = prefill(cpu_params, tree_map(lambda t: t.cpu(), small), cut)
    diffs = [_logit_diff(g_logits, c_logits)]
    for i in range(4):
        nxt = g_logits.argmax(-1)
        g_logits, g_cache = decode_step(params, nxt, g_cache, cut, 256 + i)
        c_logits, c_cache = decode_step(cpu_params, nxt.cpu(), c_cache, cut, 256 + i)
        diffs.append(_logit_diff(g_logits, c_logits))
    cpu_s = time.perf_counter() - t0
    if not all(share <= 1 for _, share in diffs):
        raise AssertionError(f"serve_rwkv: card vs CPU logits outside rtol=atol={SERVE_TOL}: {diffs}")
    del params, cpu_params, g_cache, c_cache
    torch.cuda.empty_cache()

    step_ms = res["step_ms"]
    emit({
        "phase": "serve_rwkv", "arch": cfg.name, "dtype": cfg.dtype, "params": n_params,
        "leaves": n_leaves, "layers": cfg.num_layers,
        "batch": B_RWKV, "prompt": PROMPT_RWKV, "gen": GEN_RWKV, "init_s": init_s,
        "prefill_ms": res["t_prefill"] * 1e3,
        "prefill_ms_median_of_3_more": prefill_ms_median,
        "prefill_tokens_per_s": B_RWKV * PROMPT_RWKV / res["t_prefill"],
        "decode_ms_per_step_mean": statistics.fmean(step_ms),
        "decode_ms_per_step_median": statistics.median(step_ms),
        "decode_tokens_per_s": B_RWKV * GEN_RWKV / res["t_decode"],
        "decode_s": res["t_decode"],
        "peak_memory_bytes": peak,
        "launches_main_path": launches, "wkv6_fwd_per_prefill": per_layer, "wkv6_fwd_per_decode_step": per_layer,
        "state_carry_rel_err": carry_err, "state_carry_tol": SERVE_TOL,
        "card_vs_cpu": {"layers": cut.num_layers, "params": cut_params, "prompt": [1, 256], "decode_steps": 4,
                        "max_abs_err": [d for d, _ in diffs], "worst_share_of_tol": [share for _, share in diffs],
                        "tol": SERVE_TOL, "cpu_s": cpu_s},
        "last_tokens": res["tokens"].tolist(),
    })
    return launches, per_layer


def _logit_diff(card, cpu):
    """(max |card - cpu|, the largest |card - cpu| / (tol + tol * |cpu|)):
    the logits agree at rtol = atol = SERVE_TOL where the second is <= 1."""
    a, b = card.float().cpu(), cpu.float()
    d = (a - b).abs()
    return d.max().item(), (d / (SERVE_TOL + SERVE_TOL * b.abs())).max().item()


# The emulated fabric's WAN seconds a step for distilgpt2-82m's float32
# gradients (81,126,144 parameters) on 2 DCs: numpy cost model, no card.
FULL_GRAD_BYTES = 324_504_576
MODELLED_WAN_S = {"allreduce": 3.67299648, "ps": 4.88988864, "hier": 1.23921216,
                  "hier_int8": 0.32654304, "local_sgd": 0.15490152}
# serving_under_flap's metrics as the JAX package gives them (a CPU test
# holds these constants to it), its peak step, and that step's first eight
# requests' prompt lengths
SERVING_UNDER_FLAP = {
    "serving_requests": 123.0, "serving_migrated_sessions": 23.0, "serving_migration_bytes": 434110464.0,
    "serving_p99_ms": 1074.3584640000001, "serving_slo_miss_frac": 0.04878048780487805,
}
PEAK_STEP, PEAK_TOKENS = 13, (102, 276, 58, 45, 520, 91, 136, 200)


def modelled_wan_s():
    """Each strategy's modelled WAN seconds a step, held to MODELLED_WAN_S."""
    from repro_torch.core import GeoFabric, SyncOptions

    geo = GeoFabric(num_pods=NPODS)
    got = {s: geo.sync_cost(s, FULL_GRAD_BYTES, options=SyncOptions(jitter=False)).amortized_seconds
           for s in MODELLED_WAN_S}
    if any(abs(got[s] - want) > 1e-12 * want for s, want in MODELLED_WAN_S.items()):
        raise AssertionError(f"modelled WAN seconds {got}, expected {MODELLED_WAN_S}")
    return got


def ckpt_dir(name):
    """A fresh checkpoint directory in the checkout's build/ (gitignored)."""
    import shutil

    d = ROOT / "build" / "chip_smoke_checkpoints" / name
    shutil.rmtree(d, ignore_errors=True)
    return d


def train_main_path(torch, strategy, directory, *, steps=STEPS, inject_failure_at=None, scenario=None, **tc_more):
    """GeoTrainer at full width on 2 pods, the counts zeroed just before and
    read just after; with ``scenario``, built as ``repro_torch.examples.train_geo``
    builds it.  Returns (trainer, result, launches, fwd routes, bwd routes,
    peak bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.examples.train_geo import build_trainer
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import BWD_ROUTE_LAUNCHES, ROUTE_LAUNCHES
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import GeoTrainer, TrainerConfig

    cfg = get_config("distilgpt2-82m")
    opt = AdamWConfig(lr=1e-3, warmup_steps=WARMUP, total_steps=STEPS)
    tc = TrainerConfig(
        seq_len=SEQ_TRAIN, global_batch=B_TRAIN, steps=steps, strategy=strategy,
        npods=NPODS, log_every=steps, seed=0, opt=opt, **tc_more,
    )
    if scenario is None:
        trainer = GeoTrainer(cfg, device="cuda", checkpoint_dir=str(directory), trainer_cfg=tc)
    else:
        trainer = build_trainer(cfg, scenario, tc, checkpoint_dir=str(directory), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    BWD_ROUTE_LAUNCHES.clear()
    result = trainer.run(inject_failure_at=inject_failure_at)
    launches, routes, bwd_routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES), dict(BWD_ROUTE_LAUNCHES)
    return trainer, result, launches, routes, bwd_routes, torch.cuda.max_memory_allocated()


def check_train_launches(label, cfg, launches, routes, bwd_routes, n_leaves, steps, quant):
    """12 + 12 flash launches a step, all on wgmma; wan_quant/wan_dequant on
    every leaf of every step under hier_int8 and never otherwise."""
    per_step = {"flash_attention_fwd": NPODS * cfg.num_layers, "flash_attention_bwd": NPODS * cfg.num_layers}
    if quant:
        per_step.update(wan_quant=n_leaves, wan_dequant=n_leaves)
    expected = {k: steps * n for k, n in per_step.items()}
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches} over {steps} steps, expected {expected}")
    if routes != {"wgmma": expected["flash_attention_fwd"]}:
        raise AssertionError(f"{label}: flash forward routes {routes}, expected all on wgmma")
    if bwd_routes != {"wgmma": expected["flash_attention_bwd"]}:
        raise AssertionError(f"{label}: flash backward routes {bwd_routes}, expected all on wgmma")
    return per_step


def falling_losses(label, rows):
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss not finite or not falling: {losses}")
    return losses


def card_vs_cpu_step(torch, cfg, strategy):
    """One step's loss, gradient leaves and their norm at full width, global
    batch 2 x 128, from the same weights on the card and on the CPU: the
    gradients ``sync_grads`` returns (the pod mean under hier_int8 and ps,
    each pod's own under local_sgd, whose norm is pod 0's), each leaf by its
    relative norm; then the whole step (for local_sgd an outer step,
    sync_every 1) by its loss, grad_norm and WAN bytes."""
    from repro_torch.data import loader_for_model
    from repro_torch.distributed import init_pod_params, init_train_state, make_train_step, pod_grads, sync_grads
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, DilocoConfig, global_norm
    from repro_torch.tree import tree_items, tree_map

    params = init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    batch = loader_for_model(cfg, seq_len=128, global_batch=NPODS, seed=1).next_batch()
    sides = {}
    for name, p in (("card", params), ("cpu", tree_map(lambda t: t.cpu(), params))):
        dev = "cuda" if name == "card" else "cpu"
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        ef = tree_map(lambda t: torch.zeros((NPODS, *t.shape), device=dev), p) if strategy == "hier_int8" else ()
        loss, _, grads = pod_grads(p, b, cfg, NPODS)
        synced, _, _ = sync_grads(grads, ef, strategy=strategy)
        norm = global_norm(tree_map(lambda g: g[0], synced) if strategy == "local_sgd" else synced)
        leaves = tree_map(lambda t: t.float().cpu(), synced)
        del grads, synced
        step = make_train_step(cfg, npods=NPODS, strategy=strategy, opt_cfg=AdamWConfig(),
                               diloco_cfg=DilocoConfig(sync_every=1), device=dev)
        state = init_train_state(p, AdamWConfig(), strategy=strategy, npods=NPODS)
        new, _, m = step(init_pod_params(p, strategy=strategy, npods=NPODS), state, b)
        if strategy == "local_sgd" and not all(bool(torch.equal(t[0], t[1])) for _, t in tree_items(new)):
            raise AssertionError(f"{name}: the pods differ after the outer step")
        sides[name] = (loss.item(), norm.item(), leaves, m["loss"].item(), m["grad_norm"].item(), m["wan_bytes"])
        del new, state
    g, c = sides["card"], sides["cpu"]
    leaf_err = {
        path: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        for (path, a), (_, b) in zip(tree_items(g[2]), tree_items(c[2]))
    }
    pairs = {"loss": (g[0], c[0]), "grad_norm": (g[1], c[1]), "step_loss": (g[3], c[3]),
             "step_grad_norm": (g[4], c[4])}
    if (any(abs(a - b) > TRAIN_TOL * abs(b) for a, b in pairs.values())
            or max(leaf_err.values()) > TRAIN_TOL or g[5] != c[5]):
        raise AssertionError(f"{strategy}: card vs CPU {pairs}, WAN bytes {g[5]} / {c[5]}, "
                             f"leaf relative errors {leaf_err}, tolerance {TRAIN_TOL}")
    return {"batch": [NPODS, 128], **{k: list(v) for k, v in pairs.items()}, "wan_bytes": g[5],
            "leaf_rel_err_max": max(leaf_err.values()), "tol": TRAIN_TOL}


def phase_train(torch):
    """The training path: GeoTrainer at full width, 2 pods, hier_int8."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.distributed import wan_bytes_per_step
    from repro_torch.tree import tree_leaves

    cfg = get_config("distilgpt2-82m")
    directory = ckpt_dir("train")
    trainer, result, launches, routes, bwd_routes, peak = train_main_path(torch, "hier_int8", directory)
    rows = result["metrics"]
    n_leaves = len(tree_leaves(trainer.params))
    per_step = check_train_launches("train", cfg, launches, routes, bwd_routes, n_leaves, STEPS, quant=True)
    losses = falling_losses("train", rows)
    param_bytes = sum(t.numel() * 4 for t in tree_leaves(trainer.params))
    analytic = wan_bytes_per_step(param_bytes, "hier_int8", npods=NPODS)
    wan = rows[-1]["wan_bytes"]
    if abs(wan - analytic) > 0.01 * analytic:
        raise AssertionError(f"train: WAN payload {wan} B/pod/step vs wan_bytes_per_step {analytic}")
    modelled = modelled_wan_s()
    if param_bytes != FULL_GRAD_BYTES or rows[-1]["wan_s_est"] != modelled["hier_int8"]:
        raise AssertionError(f"train: wan_s_est {rows[-1]['wan_s_est']} for {param_bytes} B, "
                             f"expected {modelled['hier_int8']} for {FULL_GRAD_BYTES} B")
    if result["last_checkpoint"] != STEPS or trainer.store.steps() != [STEPS]:
        raise AssertionError(f"train: checkpoints {trainer.store.steps()}, expected the final one, {STEPS}")
    ckpt = {"step": STEPS, "bytes_on_disk": trainer.store.nbytes(STEPS),
            "snapshot_ms": trainer.ckpt.snapshot_s * 1e3, "write_s": trainer.ckpt.write_s}
    timed = [r["step_s"] * 1e3 for r in rows[WARMUP:]]
    step_ms = statistics.median(timed)
    opt = trainer.tc.opt
    del trainer
    shutil.rmtree(directory)

    emit({
        "phase": "train", "arch": cfg.name, "dtype": cfg.dtype, "params": param_bytes // 4,
        "leaves": n_leaves, "pods": NPODS, "strategy": "hier_int8",
        "global_batch": B_TRAIN, "seq_len": SEQ_TRAIN, "steps": STEPS, "warmup_steps_untimed": WARMUP,
        "adamw": {"lr": opt.lr, "warmup_steps": opt.warmup_steps, "total_steps": opt.total_steps,
                  "b1": opt.b1, "b2": opt.b2, "weight_decay": opt.weight_decay, "clip_norm": opt.clip_norm},
        "step_ms_median": step_ms, "step_ms": timed,
        "tokens_per_s": B_TRAIN * SEQ_TRAIN / (step_ms / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "grad_norm_last": rows[-1]["grad_norm"], "peak_memory_bytes": peak,
        "wan_bytes_per_pod_step": wan, "wan_bytes_per_step_analytic": analytic,
        "wan_s_est": rows[-1]["wan_s_est"], "wan_s_est_by_strategy": modelled,
        "wan_s_est_is": "GeoFabric(num_pods=2).sync_cost(...).amortized_seconds: the emulated fabric's numpy "
                        "cost model, not a measurement",
        "sync_efficiency": result["sync_efficiency"], "checkpoint": ckpt,
        "launches_main_path": launches, "launches_per_step": per_step, "fwd_routes_main_path": routes,
        "bwd_routes_main_path": bwd_routes,
        "card_vs_cpu": card_vs_cpu_step(torch, cfg, "hier_int8"),
    })
    return launches, losses, step_ms


def phase_train_strategy(torch, strategy):
    """``ps`` or ``local_sgd`` at full width: 2 pods, 16 x 1024, 12 steps
    (2 untimed); local_sgd keeps H = 8, so step 7 is its outer step."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.distributed import wan_bytes_per_step
    from repro_torch.models import init_params
    from repro_torch.optim import DilocoConfig
    from repro_torch.tree import tree_leaves

    cfg = get_config("distilgpt2-82m")
    label = f"train_{strategy}"
    directory = ckpt_dir(label)
    trainer, result, launches, routes, bwd_routes, peak = train_main_path(torch, strategy, directory)
    rows = result["metrics"]
    n_leaves = len(tree_leaves(trainer.params))
    per_step = check_train_launches(label, cfg, launches, routes, bwd_routes, n_leaves, STEPS, quant=False)
    losses = falling_losses(label, rows)
    param_bytes = sum(t.numel() * 4 for t in tree_leaves(init_params(cfg, device="meta")))
    wan = [r["wan_bytes"] for r in rows]
    sync_every = DilocoConfig().sync_every
    if strategy == "ps":
        analytic = wan_bytes_per_step(param_bytes, "ps", npods=NPODS)
        expected_wan = None if all(abs(w - analytic) <= 0.01 * analytic for w in wan) else analytic
    else:  # a ring all-reduce of the float32 deltas on the outer step, nothing on the others
        analytic = 2 * (NPODS - 1) * param_bytes // NPODS
        want = [analytic if (i + 1) % sync_every == 0 else 0 for i in range(STEPS)]
        expected_wan = None if wan == want else want
    if expected_wan is not None:
        raise AssertionError(f"{label}: WAN bytes per pod per step {wan}, expected {expected_wan}")
    modelled = modelled_wan_s()
    if rows[-1]["wan_s_est"] != modelled[strategy]:
        raise AssertionError(f"{label}: wan_s_est {rows[-1]['wan_s_est']}, expected {modelled[strategy]}")
    timed = [r["step_s"] * 1e3 for r in rows[WARMUP:]]
    step_ms = statistics.median(timed)
    ckpt = {"step": STEPS, "bytes_on_disk": trainer.store.nbytes(STEPS),
            "snapshot_ms": trainer.ckpt.snapshot_s * 1e3, "write_s": trainer.ckpt.write_s}
    more = {}
    if strategy == "local_sgd":
        inner = [r["step_s"] * 1e3 for r in rows[WARMUP:] if r["wan_bytes"] == 0]
        more = {"sync_every": sync_every, "outer_steps": [r["step"] for r in rows if r["wan_bytes"]],
                "inner_step_ms_median": statistics.median(inner),
                "outer_step_ms": [r["step_s"] * 1e3 for r in rows if r["wan_bytes"]]}
    del trainer
    shutil.rmtree(directory)
    emit({
        "phase": label, "arch": cfg.name, "dtype": cfg.dtype, "params": param_bytes // 4, "pods": NPODS,
        "strategy": strategy, "global_batch": B_TRAIN, "seq_len": SEQ_TRAIN, "steps": STEPS,
        "warmup_steps_untimed": WARMUP, "step_ms_median": step_ms, "step_ms": timed,
        "tokens_per_s": B_TRAIN * SEQ_TRAIN / (step_ms / 1e3), **more,
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "grad_norm_last": rows[-1]["grad_norm"], "peak_memory_bytes": peak,
        "wan_bytes_per_pod_step": wan, "wan_bytes_analytic": analytic,
        "wan_s_est": rows[-1]["wan_s_est"], "sync_efficiency": result["sync_efficiency"], "checkpoint": ckpt,
        "launches_main_path": launches, "launches_per_step": per_step, "fwd_routes_main_path": routes,
        "bwd_routes_main_path": bwd_routes,
        "card_vs_cpu": card_vs_cpu_step(torch, cfg, strategy),
    })
    return launches


# train_scenario's event script: a BFD-detected flap of one WAN link and a
# brownout of the DC pair's fiber, each lifted later
SCENARIO_LINK = ("d1s1", "d2s1")


def scenario_events():
    from repro_torch.scenario import ScenarioEvent

    return (
        ScenarioEvent(kind="fail_link", at_step=3, link=SCENARIO_LINK),
        ScenarioEvent(kind="degrade_pair", at_step=4, pair=(1, 2), bandwidth_fraction=0.25, extra_delay_ms=10.0),
        ScenarioEvent(kind="restore_link", at_step=6, link=SCENARIO_LINK),
        ScenarioEvent(kind="restore_degradation", at_step=8, pair=(1, 2)),
    )


def phase_train_scenario(torch, train_losses, train_step_ms):
    """The scenario path: train_geo's spec (2 DCs of 2 workers, hier_int8,
    12 steps, jitter off) with its event script replayed at step
    boundaries, through GeoTrainer at full width with the train phase's
    TrainerConfig.  The events touch the modelled fabric only, so the
    losses must equal the train phase's."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.examples.train_geo import geo_scenario
    from repro_torch.scenario import get_scenario, run_scenario
    from repro_torch.tree import tree_leaves

    cfg = get_config("distilgpt2-82m")
    spec = geo_scenario("hier_int8", STEPS, pods=NPODS, events=scenario_events())
    directory = ckpt_dir("train_scenario")
    trainer, result, launches, routes, bwd_routes, peak = train_main_path(
        torch, "hier_int8", directory, scenario=spec)
    rows = result["metrics"]
    n_leaves = len(tree_leaves(trainer.params))
    per_step = check_train_launches("train_scenario", cfg, launches, routes, bwd_routes, n_leaves, STEPS,
                                    quant=True)
    losses = [r["loss"] for r in rows]
    if len(losses) != len(train_losses) or any(abs(a - b) > 1e-6 * abs(b) for a, b in zip(losses, train_losses)):
        raise AssertionError(f"train_scenario: losses {losses} vs train's {train_losses}, rtol 1e-6")
    if rows[-1]["wan_s_est"] != MODELLED_WAN_S["hier_int8"]:
        raise AssertionError(f"train_scenario: wan_s_est {rows[-1]['wan_s_est']}, "
                             f"expected {MODELLED_WAN_S['hier_int8']}")
    recoveries = result["scenario_recoveries"]
    if [r["mechanism"] for r in recoveries] != ["bfd"] or result["scenario_evpn_resyncs"] != 2:
        raise AssertionError(f"train_scenario: recoveries {recoveries}, "
                             f"{result['scenario_evpn_resyncs']} EVPN resyncs; expected one bfd and 2")
    if not trainer.geo.fabric.link_up(*SCENARIO_LINK):
        raise AssertionError(f"train_scenario: link {SCENARIO_LINK} is down at the end")
    timed = [r["step_s"] * 1e3 for r in rows[WARMUP:]]
    step_ms = statistics.median(timed)
    event_s = list(trainer.event_s)
    del trainer
    shutil.rmtree(directory)
    emit({
        "phase": "train_scenario", "arch": cfg.name, "dtype": cfg.dtype, "pods": NPODS,
        "scenario": spec.to_dict(), "global_batch": B_TRAIN, "seq_len": SEQ_TRAIN, "steps": STEPS,
        "warmup_steps_untimed": WARMUP, "step_ms_median": step_ms, "step_ms": timed,
        "train_step_ms_median_same_run": train_step_ms,
        "losses": losses, "losses_equal_train_bitwise": losses == list(train_losses),
        "wan_s_est": rows[-1]["wan_s_est"], "scenario_recoveries": recoveries,
        "scenario_evpn_resyncs": result["scenario_evpn_resyncs"], "link_up_at_end": True,
        "event_host_s": event_s, "wan_phases": result["wan_phases"],
        "peak_memory_bytes": peak, "launches_main_path": launches, "launches_per_step": per_step,
        "fwd_routes_main_path": routes, "bwd_routes_main_path": bwd_routes,
    })
    # The paper's Fig. 14 step with this card's compute: modelled by the
    # simulator, not measured.
    fig14 = {name: run_scenario(get_scenario(name, compute_seconds=step_ms / 1e3)).mean_step_seconds
             for name in ("fig14_allreduce", "fig14_ps")}
    emit({"phase": "train_scenario", "modelled_not_measured": True,
          "fig14_step_s_with_this_card_compute": fig14, "compute_seconds": step_ms / 1e3})
    return launches


def phase_serve_geo(torch):
    """serving_under_flap on the host, held to the JAX package's metrics;
    then the peak step's first eight trace requests materialised on the
    card by ``request_batch`` and prefilled at full width (ragged lengths
    through the flash forward), each held to its prefill on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.examples.serve_geo import peak_requests
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.models import init_params, prefill
    from repro_torch.scenario import get_scenario, run_scenario
    from repro_torch.serving import request_batch
    from repro_torch.tree import tree_map

    spec = get_scenario("serving_under_flap")
    t0 = time.perf_counter()
    result = run_scenario(spec)
    scenario_s = time.perf_counter() - t0
    metrics = result.metrics()
    got = {k: metrics[k] for k in SERVING_UNDER_FLAP}
    if any(abs(got[k] - want) > 1e-12 * abs(want) for k, want in SERVING_UNDER_FLAP.items()):
        raise AssertionError(f"serve_geo: metrics {got}, expected {SERVING_UNDER_FLAP}")
    peak, requests = peak_requests(spec, result)
    requests = requests[: len(PEAK_TOKENS)]
    if (peak.step, tuple(r.tokens for r in requests)) != (PEAK_STEP, PEAK_TOKENS):
        raise AssertionError(f"serve_geo: peak step {peak.step} with prompts {[r.tokens for r in requests]}")

    cfg = get_config("distilgpt2-82m")
    params = init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batches = [request_batch(cfg, r, device="cuda") for r in requests]

    def run():
        rows, outs = [], []
        for req, batch in zip(requests, batches):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            logits, _ = prefill(params, batch, cfg, max_len=req.tokens + 8)
            end.record()
            torch.cuda.synchronize()
            rows.append({"rid": req.rid, "tokens": req.tokens, "host_ms": (time.perf_counter() - t0) * 1e3,
                         "event_ms": start.elapsed_time(end),
                         "ok": tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all())})
            outs.append(logits)
        return rows, outs

    run()  # warm-up: cuBLAS handles and allocator pools for each length
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    rows, outs = run()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    want = cfg.num_layers * len(requests)
    if launches != {"flash_attention_fwd": want} or routes != {"wgmma": want}:
        raise AssertionError(f"serve_geo: launches {launches}, routes {routes}; expected {want} on wgmma")
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"serve_geo: logits not finite or of the wrong shape: {rows}")

    # Every length the path ran (45 and 58 are shorter than one flash tile,
    # 520 spans several), the main path's own logits against the CPU's.
    cpu_params = tree_map(lambda t: t.cpu(), params)
    diffs = []
    for req, batch, g_logits in zip(requests, batches, outs):
        c_logits, _ = prefill(cpu_params, tree_map(lambda t: t.cpu(), batch), cfg, max_len=req.tokens + 8)
        err, share = _logit_diff(g_logits, c_logits)
        diffs.append({"rid": req.rid, "tokens": req.tokens, "max_abs_err": err, "share_of_tol": share})
    if not all(d["share_of_tol"] <= 1 for d in diffs):
        raise AssertionError(f"serve_geo: card vs CPU logits outside rtol=atol={SERVE_TOL}: {diffs}")
    del params, cpu_params
    emit({
        "phase": "serve_geo", "scenario": spec.name, "scenario_host_s": scenario_s,
        "metrics": got, "metrics_expected": SERVING_UNDER_FLAP, "peak_step": peak.step,
        "arch": cfg.name, "dtype": cfg.dtype, "prefills": rows,
        "event_ms_is": "CUDA event pair around one prefill call (the device's clock; host gaps included)",
        "launches_main_path": launches, "fwd_routes_main_path": routes,
        "flash_fwd_per_prefill": cfg.num_layers,
        "card_vs_cpu": diffs, "card_vs_cpu_worst_share_of_tol": max(d["share_of_tol"] for d in diffs),
        "card_vs_cpu_tol": SERVE_TOL,
    })
    return launches


def phase_checkpoint(torch):
    """hier_int8 at full width: 4 steps checkpointed every 2 (with pod1
    silenced from step 1 on: the drill), then a new trainer restores step 2
    from a copy of the directory and runs steps 2-3.  Every kernel on the
    path is deterministic, so the resumed losses must equal the
    uninterrupted ones (rtol 1e-6; bit equality expected and reported)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.runtime import GeoTrainer
    from repro_torch.tree import tree_leaves

    cfg = get_config("distilgpt2-82m")
    steps, every = 4, 2
    first = ckpt_dir("checkpoint_first")
    trainer, result, launches, routes, bwd_routes, peak = train_main_path(
        torch, "hier_int8", first, steps=steps, inject_failure_at=1, checkpoint_every=every)
    rows = result["metrics"]
    check_train_launches("checkpoint", cfg, launches, routes, bwd_routes, len(tree_leaves(trainer.params)),
                         steps, quant=True)
    falling_losses("checkpoint", rows)
    detect_mult = trainer.heartbeats.workers["pod1"].session.detect_mult
    drills = [(d["step"], d["dead"]) for d in result["recovery_drills"]]
    if drills != [(detect_mult, ["pod1"])]:
        raise AssertionError(f"checkpoint: drills {drills}, expected pod1 dead at step {detect_mult}")
    if trainer.store.steps() != [every, steps]:
        raise AssertionError(f"checkpoint: steps on disk {trainer.store.steps()}, expected {[every, steps]}")
    save = {"step": steps, "snapshot_s": trainer.ckpt.snapshot_s, "write_s": trainer.ckpt.write_s,
            "bytes_on_disk": trainer.store.nbytes(steps)}
    tc = trainer.tc
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    second = ckpt_dir("checkpoint_second")
    second.mkdir(parents=True)
    shutil.copytree(first / f"step_{every:08d}", second / f"step_{every:08d}")
    shutil.copy(first / f"step_{every:08d}.COMMITTED", second)
    resumed = GeoTrainer(cfg, device="cuda", checkpoint_dir=str(second), trainer_cfg=tc)
    like = resumed.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, meta = resumed.store.restore(every, like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del like, restored
    again = resumed.run()
    want = [r["loss"] for r in rows[every:]]
    got = [r["loss"] for r in again["metrics"]]
    if [r["step"] for r in again["metrics"]] != list(range(every, steps)) or meta != {"data_step": every}:
        raise AssertionError(f"checkpoint: resumed steps {[r['step'] for r in again['metrics']]}, metadata {meta}")
    if any(abs(a - b) > 1e-6 * abs(b) for a, b in zip(got, want)):
        raise AssertionError(f"checkpoint: resumed losses {got} vs uninterrupted {want}, rtol 1e-6")
    del resumed
    shutil.rmtree(first)
    shutil.rmtree(second)
    emit({
        "phase": "checkpoint", "arch": cfg.name, "strategy": "hier_int8", "pods": NPODS,
        "global_batch": B_TRAIN, "seq_len": SEQ_TRAIN, "steps": steps, "checkpoint_every": every,
        "losses_uninterrupted": [r["loss"] for r in rows],
        "losses_resumed_from_step_2": got, "resumed_bit_equal": got == want,
        "resumed_max_abs_diff": max(abs(a - b) for a, b in zip(got, want)),
        "save": save, "restore_s": restore_s, "restored_step": every,
        "drill": result["recovery_drills"][0], "detect_mult": detect_mult,
        "peak_memory_bytes": peak, "launches_main_path": launches,
        "fwd_routes_main_path": routes, "bwd_routes_main_path": bwd_routes,
    })
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    import repro_torch  # noqa: F401  (fails where the checkout's sources are absent)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_env(torch)
    phase_build()
    fwd = phase_kernels(torch)
    bwd = phase_kernels_bwd(torch)
    wan, wan_step = phase_kernels_wan(torch)
    wkv = phase_kernels_wkv(torch)
    serve = phase_serve(torch)
    train, train_losses, train_step_ms = phase_train(torch)
    trains = {}
    for strategy in ("ps", "local_sgd"):
        gc.collect()
        torch.cuda.empty_cache()
        trains[strategy] = phase_train_strategy(torch, strategy)
    gc.collect()
    torch.cuda.empty_cache()
    scenario = phase_train_scenario(torch, train_losses, train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    serve_geo = phase_serve_geo(torch)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = phase_checkpoint(torch)
    gc.collect()  # the train phases' ~16 GB go before rwkv6-7b's ~31 GB
    torch.cuda.empty_cache()
    rwkv, rwkv_per_step = phase_serve_rwkv(torch)

    def entry(name, source, replaces, check, **more):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train.get(name, 0), "launches_per_train_step": train.get(name, 0) // STEPS,
            "max_abs_err": check["max_abs_err"], "tol": check["tol"], "ms": check["ms"],
            "call_ms": check["call_ms"], "ms_is": MS_IS,
            "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"], "bound_by": check["bound_by"],
            "library_ms": check["library_ms"], "library_call_ms": check.get("library_call_ms"),
            "launches_train_ps": trains["ps"].get(name, 0), "launches_train_local_sgd": trains["local_sgd"].get(name, 0),
            "launches_checkpoint": ckpt.get(name, 0), "launches_train_scenario": scenario.get(name, 0),
            "launches_serve_geo": serve_geo.get(name, 0), **more,
        }

    wan_err = {
        "max_abs_err": float(max(c["int8_max_abs_diff"] for c in wan)),
        "tol": "|dq| <= 1 on < 1e-3 of lanes; scales rtol 1e-6",
        "bound_by": "bytes", "library_ms": None,
    }
    emit({"kernels": [
        entry("flash_attention_fwd", "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
              "src/repro/kernels/flash_attention/kernel.py:110", fwd[0],
              launches_serve_prefill=serve.get("flash_attention_fwd", 0), fwd_route=fwd[0]["fwd_route"],
              tflops=fwd[0]["tflops"], shapes=fwd),
        entry("flash_attention_bwd", "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
              "none: the JAX package trains through autodiff of dense attention (no Pallas backward)",
              bwd[0], library_is=bwd[0]["library_is"], library_bwd_ms=bwd[0]["library_bwd_ms"],
              bwd_route=bwd[0]["bwd_route"], shapes=bwd),
        entry("wan_quant", "src/repro_torch/kernels/wan_quant/csrc/wan_quant.cu",
              "src/repro/kernels/wan_quant/kernel.py:44",
              dict(wan_err, ms=wan_step["quant_ms"], call_ms=wan_step["quant_call_ms"],
                   plain_ms=wan_step["quant_plain_ms"], bound_ms=wan_step["bound_ms"]),
              ms_is="all 19 leaves of one train step (2 pods stacked)",
              library_why="no single PyTorch call computes per-block absmax int8", shapes=wan),
        entry("wan_dequant", "src/repro_torch/kernels/wan_quant/csrc/wan_quant.cu",
              "src/repro/kernels/wan_quant/kernel.py:73",
              dict(wan_err, max_abs_err=max(c["dequant_max_abs_err"] for c in wan), tol=0.0,
                   ms=wan_step["dequant_ms"], call_ms=wan_step["dequant_call_ms"],
                   plain_ms=wan_step["dequant_plain_ms"], bound_ms=wan_step["bound_ms"]),
              ms_is="all 19 leaves of one train step (2 pods stacked)",
              library_why="no single PyTorch call computes q * scale per 256-lane block"),
        dict(entry("wkv6_fwd", "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv6.cu",
                   "src/repro/kernels/rwkv6_wkv/kernel.py:78", wkv[0],
                   library_why="no single PyTorch call computes the WKV6 recurrence", shapes=wkv),
             launches=rwkv["wkv6_fwd"], launches_per_prefill=rwkv_per_step,
             launches_per_decode_step=rwkv_per_step, launches_per_train_step=0),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
