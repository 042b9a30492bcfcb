#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each printing one JSON line on stdout:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions.
2. ``build``: every kernel of the port compiled from this checkout's sources.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the serving path's shape and the variants below, with times.
4. ``serve``: the main path, distilgpt2-82m at full width (random weights
   from a seed): prefill of 8 x 1024 tokens, then 32 greedy decode steps,
   with the kernel launch counts of that run; then the card against the
   CPU on a [1, 256] prompt (prefill and 4 decode steps).

Then the ``{"kernels": [...]}`` summary, the card's name and power limit as
``nvidia-smi`` prints them, and, last, ``{"ok": true, "device": ...}``.
Any failure raises: the script exits non-zero and prints no result.  It
also fails without a card, and where the port's sources are absent.
"""

from __future__ import annotations

import json
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

# (label, B, S, H, KVH, hd, dtype, window, softcap); the first is the path's shape
FLASH_CASES = [
    ("path", 8, 1024, 12, 12, 64, "bfloat16", None, None),
    ("ragged_s1000", 8, 1000, 12, 12, 64, "bfloat16", None, None),
    ("gqa_h8_kvh2_hd128", 8, 1024, 8, 2, 128, "bfloat16", None, None),
    ("window256", 8, 1024, 12, 12, 64, "bfloat16", 256, None),
    ("softcap30", 8, 1024, 12, 12, 64, "bfloat16", None, 30.0),
    ("f32", 8, 1024, 12, 12, 64, "float32", None, None),
]
B_SERVE, PROMPT, GEN = 8, 1024, 32


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


def flash_bound(b, s, h, kvh, hd, dtype, window):
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * s * h * hd + 2 * b * s * kvh * hd) * itemsize  # q, o; k, v
    flops = 4 * b * h * hd * attention_pairs(s, s, True, window)  # q.k and p.v
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
        plain = flash_attention_ref(qh, kh, vh, **kw).transpose(1, 2)
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
    emit({"phase": "kernels", "checks": checks})
    return checks


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.models import decode_step, init_params, prefill

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
    cpu_params = _tree_cpu(params)
    small = synthetic_prompt_batch(cfg, gen, 1, 256)
    g_logits, g_cache = prefill(params, small, cfg, max_len=260)
    c_logits, c_cache = prefill(cpu_params, _tree_cpu(small), cfg, max_len=260)
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


def _tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_cpu(v) for v in tree]
    return tree.cpu()


def _logit_diff(card, cpu):
    """(max |card - cpu|, whether |card - cpu| <= tol + tol * |cpu| everywhere)."""
    a, b = card.float().cpu(), cpu.float()
    d = (a - b).abs()
    return d.max().item(), bool((d <= SERVE_TOL + SERVE_TOL * b.abs()).all())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    import repro_torch  # noqa: F401  (fails where the checkout's sources are absent)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_env(torch)
    phase_build()
    checks = phase_kernels(torch)
    launches = phase_serve(torch)
    path = checks[0]
    emit({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:110",
        "launches": launches.get("flash_attention_fwd", 0),
        "launches_per_prefill": launches.get("flash_attention_fwd", 0),
        "max_abs_err": path["max_abs_err"],
        "tol": path["tol"],
        "ms": path["ms"],
        "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"],
        "library_ms": path["library_ms"],
        "shapes": checks,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
