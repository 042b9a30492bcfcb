#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each printing one JSON line on stdout:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions.
2. ``build``: every kernel of the port compiled from this checkout's sources
   (one ``nvcc`` per source, all started together).
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes and the variants below, with times: the flash
   forward and backward, and the WAN int8 quantiser and dequantiser.
4. ``serve``: the serving path, distilgpt2-82m at full width (random
   weights from a seed): prefill of 8 x 1024 tokens, then 32 greedy decode
   steps, with the kernel launch counts of that run; then the card against
   the CPU on a [1, 256] prompt (prefill and 4 decode steps).
5. ``train``: the training path, distilgpt2-82m at full width on 2 emulated
   pods with the ``hier_int8`` WAN sync, global batch 16 x 1024, through
   ``GeoTrainer``: 2 warm-up steps and 10 timed, with the kernel launch
   counts of that run; then one ``hier_int8`` step at global batch 2 x 128
   on the card against the CPU (loss, gradient norm, every synced leaf).

Then the ``{"kernels": [...]}`` summary, the card's name and power limit as
``nvidia-smi`` prints them, and, last, ``{"ok": true, "device": ...}``.
Any failure raises: the script exits non-zero and prints no result.  It
also fails without a card, and where the port's sources are absent.
"""

from __future__ import annotations

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

# (label, B, S, H, KVH, hd, dtype, window, softcap); the first is the path's shape
FLASH_CASES = [
    ("path", 8, 1024, 12, 12, 64, "bfloat16", None, None),
    ("ragged_s1000", 8, 1000, 12, 12, 64, "bfloat16", None, None),
    ("gqa_h8_kvh2_hd128", 8, 1024, 8, 2, 128, "bfloat16", None, None),
    ("window256", 8, 1024, 12, 12, 64, "bfloat16", 256, None),
    ("softcap30", 8, 1024, 12, 12, 64, "bfloat16", None, 30.0),
    ("f32", 8, 1024, 12, 12, 64, "float32", None, None),
]
# (label, B, S, H, KVH, hd, dtype, window, softcap); the first is the train path's shape
FLASH_BWD_CASES = [
    ("path", 8, 1024, 12, 12, 64, "bfloat16", None, None),
    ("window256", 8, 1024, 12, 12, 64, "bfloat16", 256, None),
    ("softcap30", 8, 1024, 12, 12, 64, "bfloat16", None, 30.0),
    ("gqa_h8_kvh2_hd128", 8, 1024, 8, 2, 128, "bfloat16", None, None),
    ("f32", 8, 1024, 12, 12, 64, "float32", None, None),
]
# (label, rows, cols): the stacked 2-pod largest leaves and a ragged one
WAN_CASES = [
    ("embed_2x50257x768", 2 * 50257, 768),
    ("w_up_2x6x768x3072", 2 * 6 * 768, 3072),
    ("ragged_24x300", 24, 300),
]
B_SERVE, PROMPT, GEN = 8, 1024, 32
NPODS, B_TRAIN, SEQ_TRAIN, STEPS, WARMUP = 2, 16, 1024, 12, 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event-timed calls after ``warmup`` calls."""
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


def flash_bound(b, s, h, kvh, hd, dtype, window):
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * s * h * hd + 2 * b * s * kvh * hd) * itemsize  # q, o; k, v
    flops = 4 * b * h * hd * attention_pairs(s, s, True, window)  # q.k and p.v
    return bound(nbytes, flops, dtype)


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


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, (_, log) in report.items()
    }
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "compiled": {n: sec for n, (sec, _) in report.items()}, "ptxas": ptxas,
    })


def phase_kernels(torch):
    """The flash forward's checks (the serving path's shape first)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for label, b, s, h, kvh, hd, dtype, window, cap in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dt)
        kw = dict(causal=True, window=window, logit_softcap=cap)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        out = flash_attention(q, k, v, **kw)
        plain = flash_attention_ref(qh, kh, vh, **kw)[0].transpose(1, 2)
        torch.cuda.synchronize()
        diff = (out.float() - plain.float()).abs()
        err, tol = diff.max().item(), TOL[dtype]
        # assert_allclose's form with rtol = atol = tol, as the tests hold it
        if not bool((diff <= tol + tol * plain.float().abs()).all()):
            raise AssertionError(f"flash_attention_fwd {label}: max_abs_err {err}, rtol=atol={tol}")
        library_ms = None
        if window is None and cap is None:  # the same function as one PyTorch call
            qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, enable_gqa=h != kvh))
        bound_ms, bound_by = flash_bound(b, s, h, kvh, hd, dtype, window)
        checks.append({
            "label": label, "shape": {"B": b, "S": s, "H": h, "KVH": kvh, "hd": hd},
            "dtype": dtype, "window": window, "softcap": cap,
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: flash_attention_ref(qh, kh, vh, **kw)),
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        })
    emit({"phase": "kernels", "kernel": "flash_attention_fwd", "checks": checks})
    return checks


def phase_kernels_bwd(torch):
    """The flash backward against the plain backward on the same inputs
    (the kernel forward's output and lse), at the train path's shape first."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    checks = []
    for label, b, s, h, kvh, hd, dtype, window, cap in FLASH_BWD_CASES:
        dt = getattr(torch, dtype)
        q, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dt) for _ in range(2))
        kw = dict(causal=True, window=window, logit_softcap=cap)
        out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
        heads = [t.transpose(1, 2) for t in (q, k, v, out, do)]
        grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        plain = flash_attention_bwd_ref(*heads[:4], lse, heads[4], **kw)
        torch.cuda.synchronize()
        tol, errs = TOL[dtype], {}
        for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
            want = want.transpose(1, 2).float()
            diff = (got.float() - want).abs()
            errs[name] = diff.max().item()
            if not bool((diff <= tol + tol * want.abs()).all()):
                raise AssertionError(f"flash_attention_bwd {label} {name}: max_abs_err {errs[name]}, rtol=atol={tol}")
        library_ms = None
        if window is None and cap is None:  # sdpa's forward plus its backward: one pair
            qc, kc, vc = (t.detach().contiguous().requires_grad_(True) for t in heads[:3])
            doc = heads[4].contiguous()

            def library():
                o = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=h != kvh)
                torch.autograd.grad(o, (qc, kc, vc), doc)

            library_ms = time_ms(library)
        bound_ms, bound_by = flash_bwd_bound(b, s, h, kvh, hd, dtype, window)
        checks.append({
            "label": label, "shape": {"B": b, "S": s, "H": h, "KVH": kvh, "hd": hd},
            "dtype": dtype, "window": window, "softcap": cap,
            "max_abs_err": max(errs.values()), "max_abs_err_dq_dk_dv": errs, "tol": tol,
            "ms": time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw)),
            "plain_ms": time_ms(lambda: flash_attention_bwd_ref(*heads[:4], lse, heads[4], **kw), runs=5),
            "library_ms": library_ms, "library_is": "scaled_dot_product_attention forward + backward",
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
            "quant_ms": time_ms(lambda: wan_quant(x)), "quant_plain_ms": time_ms(lambda: wan_quant_ref(x)),
            "dequant_ms": time_ms(lambda: wan_dequant(q, s, cols)),
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
    step = {
        "leaves": len(mats), "values": sum(m.numel() for m in mats), "bytes": step_bytes,
        "quant_ms": time_ms(lambda: [wan_quant(m) for m in mats], runs=10),
        "quant_plain_ms": time_ms(lambda: [wan_quant_ref(m) for m in mats], runs=5),
        "dequant_ms": time_ms(lambda: [wan_dequant(q, s, m.shape[1]) for m, (q, s) in zip(mats, packed)], runs=10),
        "dequant_plain_ms": time_ms(
            lambda: [wan_dequant_ref(q, s, m.shape[1]) for m, (q, s) in zip(mats, packed)], runs=5),
        "bound_ms": bound(step_bytes, 0, "float32")[0], "bound_by": "bytes",
    }
    emit({"phase": "kernels", "kernel": "wan_quant+wan_dequant", "checks": checks, "train_step": step})
    del mats, packed
    return checks, step


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_map

    cfg = get_config("distilgpt2-82m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, device="cuda")
    batch = synthetic_prompt_batch(cfg, gen, B_SERVE, PROMPT)
    max_len = PROMPT + GEN

    def run():
        """The main path: prefill, then greedy decode; returns times and logits checks."""
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, cfg, max_len=max_len)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        after_prefill = dict(LAUNCHES)
        shape_ok = tuple(logits.shape) == (B_SERVE, cfg.vocab_size)
        finite &= torch.isfinite(logits).all()
        tokens = logits.argmax(-1)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(GEN)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(GEN)]
        t0 = time.perf_counter()
        for i in range(GEN):
            starts[i].record()
            logits, cache = decode_step(params, tokens, cache, cfg, PROMPT + i)
            ends[i].record()
            finite &= torch.isfinite(logits).all()
            tokens = logits.argmax(-1)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        step_ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
        return t_prefill, after_prefill, t_decode, step_ms, shape_ok and bool(finite), tokens

    run()  # warm-up: cuBLAS handles, allocator pools, kernel library load
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t_prefill, after_prefill, t_decode, step_ms, ok, tokens = run()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
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
    if not all(ok for _, ok in diffs):
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
        "launches_main_path": launches,
        "card_vs_cpu_max_abs_err": [d for d, _ in diffs], "card_vs_cpu_tol": SERVE_TOL,
        "last_tokens": tokens.tolist(),
    })
    return launches


def _logit_diff(card, cpu):
    """(max |card - cpu|, whether |card - cpu| <= tol + tol * |cpu| everywhere)."""
    a, b = card.float().cpu(), cpu.float()
    d = (a - b).abs()
    return d.max().item(), bool((d <= SERVE_TOL + SERVE_TOL * b.abs()).all())


def phase_train(torch):
    """The training path: GeoTrainer at full width, 2 pods, hier_int8."""
    from repro_torch.configs import get_config
    from repro_torch.data import loader_for_model
    from repro_torch.distributed import pod_grads, sync_grads, wan_bytes_per_step
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.runtime import GeoTrainer, TrainerConfig
    from repro_torch.tree import tree_items, tree_leaves, tree_map

    cfg = get_config("distilgpt2-82m")
    opt = AdamWConfig(lr=1e-3, warmup_steps=WARMUP, total_steps=STEPS)
    trainer = GeoTrainer(cfg, device="cuda", trainer_cfg=TrainerConfig(
        seq_len=SEQ_TRAIN, global_batch=B_TRAIN, steps=STEPS, strategy="hier_int8",
        npods=NPODS, log_every=STEPS, seed=0, opt=opt,
    ))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    result = trainer.run()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rows = result["metrics"]
    n_leaves = len(tree_leaves(trainer.params))
    per_step = {"flash_attention_fwd": NPODS * cfg.num_layers, "flash_attention_bwd": NPODS * cfg.num_layers,
                "wan_quant": n_leaves, "wan_dequant": n_leaves}
    expected = {k: STEPS * n for k, n in per_step.items()}
    if launches != expected:
        raise AssertionError(f"train: launches {launches} over {STEPS} steps, expected {expected}")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss not finite or not falling: {losses}")
    param_bytes = sum(t.numel() * 4 for t in tree_leaves(trainer.params))
    analytic = wan_bytes_per_step(param_bytes, "hier_int8", npods=NPODS)
    wan = rows[-1]["wan_bytes"]
    if abs(wan - analytic) > 0.01 * analytic:
        raise AssertionError(f"train: WAN payload {wan} B/pod/step vs wan_bytes_per_step {analytic}")
    timed = [r["step_s"] * 1e3 for r in rows[WARMUP:]]
    step_ms = statistics.median(timed)
    del trainer

    # The card against the CPU: one hier_int8 step's loss, synced leaves and
    # their norm at full width, global batch 2 x 128, from the same weights.
    params = init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    batch = loader_for_model(cfg, seq_len=128, global_batch=NPODS, seed=1).next_batch()
    sides = {}
    for name, p in (("card", params), ("cpu", tree_map(lambda t: t.cpu(), params))):
        dev = "cuda" if name == "card" else "cpu"
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        ef = tree_map(lambda t: torch.zeros((NPODS, *t.shape), device=dev), p)
        loss, _, grads = pod_grads(p, b, cfg, NPODS)
        synced, _, _ = sync_grads(grads, ef, strategy="hier_int8")
        sides[name] = (loss.item(), global_norm(synced).item(), tree_map(lambda t: t.float().cpu(), synced))
        del grads, synced
    (g_loss, g_norm, g_synced), (c_loss, c_norm, c_synced) = sides["card"], sides["cpu"]
    leaf_err = {
        path: ((g - c).norm() / c.norm().clamp_min(1e-30)).item()
        for (path, g), (_, c) in zip(tree_items(g_synced), tree_items(c_synced))
    }
    if (abs(g_loss - c_loss) > TRAIN_TOL * abs(c_loss) or abs(g_norm - c_norm) > TRAIN_TOL * abs(c_norm)
            or max(leaf_err.values()) > TRAIN_TOL):
        raise AssertionError(
            f"train: card vs CPU loss {g_loss} / {c_loss}, grad_norm {g_norm} / {c_norm}, "
            f"leaf relative errors {leaf_err}, tolerance {TRAIN_TOL}"
        )
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
        "launches_main_path": launches, "launches_per_step": per_step,
        "card_vs_cpu": {"batch": [NPODS, 128], "loss": [g_loss, c_loss], "grad_norm": [g_norm, c_norm],
                        "leaf_rel_err_max": max(leaf_err.values()), "tol": TRAIN_TOL},
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
    serve = phase_serve(torch)
    train = phase_train(torch)

    def entry(name, source, replaces, check, **more):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train.get(name, 0), "launches_per_train_step": train.get(name, 0) // STEPS,
            "max_abs_err": check["max_abs_err"], "tol": check["tol"], "ms": check["ms"],
            "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"], "bound_by": check["bound_by"],
            "library_ms": check["library_ms"], **more,
        }

    wan_err = {
        "max_abs_err": float(max(c["int8_max_abs_diff"] for c in wan)),
        "tol": "|dq| <= 1 on < 1e-3 of lanes; scales rtol 1e-6",
        "bound_by": "bytes", "library_ms": None,
    }
    emit({"kernels": [
        entry("flash_attention_fwd", "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
              "src/repro/kernels/flash_attention/kernel.py:110", fwd[0],
              launches_serve_prefill=serve.get("flash_attention_fwd", 0), shapes=fwd),
        entry("flash_attention_bwd", "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
              "none: the JAX package trains through autodiff of dense attention (no Pallas backward)",
              bwd[0], library_is=bwd[0]["library_is"], shapes=bwd),
        entry("wan_quant", "src/repro_torch/kernels/wan_quant/csrc/wan_quant.cu",
              "src/repro/kernels/wan_quant/kernel.py:44",
              dict(wan_err, ms=wan_step["quant_ms"], plain_ms=wan_step["quant_plain_ms"],
                   bound_ms=wan_step["bound_ms"]),
              ms_is="all 19 leaves of one train step (2 pods stacked)",
              library_why="no single PyTorch call computes per-block absmax int8", shapes=wan),
        entry("wan_dequant", "src/repro_torch/kernels/wan_quant/csrc/wan_quant.cu",
              "src/repro/kernels/wan_quant/kernel.py:73",
              dict(wan_err, max_abs_err=max(c["dequant_max_abs_err"] for c in wan), tol=0.0,
                   ms=wan_step["dequant_ms"], plain_ms=wan_step["dequant_plain_ms"],
                   bound_ms=wan_step["bound_ms"]),
              ms_is="all 19 leaves of one train step (2 pods stacked)",
              library_why="no single PyTorch call computes q * scale per 256-lane block"),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
