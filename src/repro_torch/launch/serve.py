"""Serving launcher: batched prefill + greedy decode on one device.

``python -m repro_torch.launch.serve --arch <id> --prompt-len 64 --gen 32``

The port of ``repro.launch.serve``: batched synthetic prompts through
``prefill`` then greedy ``decode_step`` tokens, with per-phase timing.
Runs on the card (``--device cuda``, the default) or, when asked, on the
CPU through the plain PyTorch path.  ``--profile`` (card only) runs both
phases once more under ``torch.profiler`` and prints, per phase, the
device's busy share of the wall time and the ops by device time.
``--mesh group --data D --model M`` serves on ``D x M`` ranks of one gloo
group (one pod): parameters, batch and caches placed by the sharding
rules, the batch's rows over ``data``, heads over ``model``
(:func:`repro_torch.distributed.make_prefill_step`).
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
    ap.add_argument("--mesh", default="host", choices=["host", "group"],
                    help="host: one process; group: --data x --model ranks over gloo")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    args = ap.parse_args(argv)
    if args.mesh == "group":
        _serve_group(args)
        return

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.batches import decode_step_input, synthetic_prompt_batch
    from repro_torch.launch.profiling import profile_run
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
        profile_run("prefill", lambda: prefill(params, batch, cfg, max_len=max_len), device)
        profile_run(f"decode x{args.gen}", lambda: [
            decode_step(params, tokens, cache, cfg, args.prompt_len + i) for i in range(args.gen)
        ], device)


def group_rank(rank: int, args):
    """One rank of ``--mesh group``: prefill and greedy decode on the (data, model) mesh."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed import make_decode_step, make_prefill_step
    from repro_torch.launch.batches import decode_step_input, synthetic_prompt_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params

    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    mesh = make_host_mesh(pods=1, data=args.data, model=args.model, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=args.device)
    batch = synthetic_prompt_batch(cfg, gen, args.batch, args.prompt_len)
    prefill_step, _ = make_prefill_step(cfg, mesh, device=args.device)
    decode, _ = make_decode_step(cfg, mesh, device=args.device)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, batch, max_len=args.prompt_len + args.gen)
    lan = prefill_step.lan.lan_bytes
    t_prefill = time.perf_counter() - t0
    tokens = torch.argmax(logits, dim=-1)
    generated = [tokens]
    t0 = time.perf_counter()
    for i in range(args.gen):
        logits, cache = decode(params, decode_step_input(cfg, gen, tokens, args.batch), cache, args.prompt_len + i)
        tokens = torch.argmax(logits, dim=-1)
        generated.append(tokens)
    return {"prefill_s": t_prefill, "decode_s": time.perf_counter() - t0, "prefill_lan_bytes": lan,
            "tokens": torch.stack(generated, dim=1).cpu()}


def _serve_group(args) -> None:
    from repro_torch.device import resolve_device
    from repro_torch.distributed import spawn

    ranks = spawn(group_rank, args.data * args.model, args, device=resolve_device(args.device))
    r0 = ranks[0]
    print(f"prefill: {args.batch}x{args.prompt_len} in {r0['prefill_s']:.3f}s on {args.data} x {args.model} ranks "
          f"({r0['prefill_lan_bytes']} LAN bytes handed by rank 0)")
    print(f"decode: {args.gen} steps in {r0['decode_s']:.3f}s ({args.batch * args.gen / r0['decode_s']:.1f} tok/s)")
    print(f"sample[0]: {r0['tokens'][0].tolist()}")


if __name__ == "__main__":
    main()
