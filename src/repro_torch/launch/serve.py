"""Serving launcher: batched prefill + greedy decode on one device.

``python -m repro_torch.launch.serve --arch <id> --prompt-len 64 --gen 32``

The port of ``repro.launch.serve``: batched synthetic prompts through
``prefill`` then greedy ``decode_step`` tokens, with per-phase timing.
Runs on the card (``--device cuda``, the default) or, when asked, on the
CPU through the plain PyTorch path.  ``--profile`` (card only) runs both
phases once more under ``torch.profiler`` and prints, per phase, the
device's busy share of the wall time and the ops by device time.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="distilgpt2-82m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.batches import decode_step_input, synthetic_prompt_batch
    from repro_torch.models import decode_step, init_params, prefill

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        raise ValueError("--profile traces the card: use --device cuda")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=device)
    max_len = args.prompt_len + args.gen

    batch = synthetic_prompt_batch(cfg, gen, args.batch, args.prompt_len)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cfg, max_len=max_len)
    sync()
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill:.3f}s")

    tokens = torch.argmax(logits, dim=-1)
    generated = [tokens]
    t0 = time.perf_counter()
    for i in range(args.gen):
        step_in = decode_step_input(cfg, gen, tokens, args.batch)
        logits, cache = decode_step(params, step_in, cache, cfg, args.prompt_len + i)
        tokens = torch.argmax(logits, dim=-1)
        generated.append(tokens)
    sync()
    t_decode = time.perf_counter() - t0
    toks_per_s = args.batch * args.gen / t_decode
    print(f"decode: {args.gen} steps in {t_decode:.3f}s ({toks_per_s:.1f} tok/s)")
    out = torch.stack(generated, dim=1)
    print(f"sample[0]: {out[0].tolist()}")

    if args.profile:
        # decode re-runs against the filled cache: the same work per step
        _profile("prefill", lambda: prefill(params, batch, cfg, max_len=max_len), device)
        _profile(f"decode x{args.gen}", lambda: [
            decode_step(params, tokens, cache, cfg, args.prompt_len + i) for i in range(args.gen)
        ], device)


def _profile(label, fn, device, rows: int = 12) -> None:
    """One run of ``fn`` under torch.profiler: busy share and top ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(
        f"profile {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} device events"
    )
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=rows))


if __name__ == "__main__":
    main()
