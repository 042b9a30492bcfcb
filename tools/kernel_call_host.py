#!/usr/bin/env python3
"""The host's cost of each kernel wrapper's call, on the card, checkout against checkout.

    python3 tools/kernel_call_host.py                               # this checkout
    python3 tools/kernel_call_host.py build/parent . . build/parent # several, in turns

For each checkout, in the order given, a new process takes that checkout's
``src/`` first on the path, builds its kernels into its build directory
and calls each kernel's public wrapper at a main path's shape: the flash
forward and backward at ``train``'s (8 x 1024, 12 heads of 64, bf16),
``wan_quant`` / ``wan_dequant`` on one ``[768, 3072]`` float32 leaf, and
the decode steps' calls, where the host binds: ``wkv6`` at T = 1 (rwkv6-7b,
4 rows, 64 heads of 64, the state updated in place) and ``rglru_scan`` at
T = 1 (recurrentgemma-9b, 4 rows of 4096).  Per wrapper it prints the
median of 25 event pairs around one call (``call_ms``, as ``chip_smoke.py``
reports it) and the host microseconds a call over 200 calls in a row with
one synchronisation at the end (``host_us``: the wrapper, its checks and
the dispatcher; the device runs behind unless its time exceeds the
host's).  One JSON line a checkout.  Two versions are compared inside one
call and in turns (parent, change, change, parent), as the card and its
host differ between calls.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALLS = 200


def measure() -> dict:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_wkv import wkv6
    from repro_torch.kernels.wan_quant import wan_dequant, wan_quant

    _build.build()
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    q, k, v = (rand(8, 1024, 12, 64) for _ in range(3))
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    do = rand(8, 1024, 12, 64)
    leaf = rand(768, 3072, dtype=torch.float32, scale=1e-3)
    packed = wan_quant(leaf)
    r, kk, vv = (rand(4, 1, 64, 64, scale=0.5) for _ in range(3))
    w = torch.sigmoid(rand(4, 1, 64, 64, dtype=torch.float32))
    u, state = rand(64, 64, dtype=torch.float32, scale=0.1), rand(4, 64, 64, 64, dtype=torch.float32, scale=0.1)
    x, rg, ig = rand(4, 1, 4096), torch.sigmoid(rand(4, 1, 4096)), torch.sigmoid(rand(4, 1, 4096))
    lam, h0 = rand(4096, dtype=torch.float32), rand(4, 4096, dtype=torch.float32)
    calls = {
        "flash_attention_fwd": lambda: flash_attention_fwd(q, k, v),
        "flash_attention_bwd": lambda: flash_attention_bwd(q, k, v, o, lse, do),
        "wan_quant": lambda: wan_quant(leaf),
        "wan_dequant": lambda: wan_dequant(*packed, leaf.shape[1]),
        "wkv6_fwd_decode": lambda: wkv6(r, kk, vv, w, u, state, state_out=state),
        "rglru_scan_decode": lambda: rglru_scan(x, rg, ig, lam, h0),
    }
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            pairs = []
            for _ in range(25):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                pairs.append(a.elapsed_time(b))
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            out[name] = {"call_ms": statistics.median(pairs), "host_us": host / CALLS * 1e6}
    return out


# the checkout's src/ first, this file's measure() (a parent checkout may not have it)
CHILD = ("import sys; sys.path[:0] = ['src', {here!r}]; import json, kernel_call_host; "
         "print(json.dumps(kernel_call_host.measure()))")


def main(trees) -> int:
    rc = 0
    for tree in trees:
        child = CHILD.format(here=str(Path(__file__).resolve().parent))
        proc = subprocess.run([sys.executable, "-c", child], cwd=tree, capture_output=True, text=True, timeout=900)
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        print(json.dumps({"tree": tree, "rc": proc.returncode, **(lines[-1] if lines else {})}), flush=True)
        if proc.returncode:
            rc = 1
            print(proc.stderr[-4000:], file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["."]))
