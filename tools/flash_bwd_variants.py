#!/usr/bin/env python3
"""Time variants of ``flash_bwd.cu``'s hd-256 dK/dV kernel, on the card.

    PYTHONPATH=src python3 tools/flash_bwd_variants.py regs_24_240 regs_32_232 early_release

Each argument names a diagnostic build (``VARIANTS``), a text edit of this
checkout's source that is timed and never shipped:
``regs_P_C`` gives the producer warpgroup P and the consumers C registers
after ``setmaxnreg`` (the shipped split is 40 / 232; 128 P + 256 C may not
pass the launch's 384 x 168); ``early_release`` frees each ring stage as
soon as the tile's dV / dK product is done, instead of after the next
tile's S^T / dP^T, so the producer may load one tile sooner.  The shipped
source and each variant are built into ``build/flash_bwd_variants/`` (all
``nvcc`` runs started together); ptxas's spill line for the hd-256 dK/dV
instances is printed, then the hd-256 bf16 cases of ``chip_smoke.py``'s
FLASH_BWD_CASES run through the wrapper with each build in turns (shipped,
the variants, then in reverse), timed as ``chip_smoke.py`` times a kernel.
One JSON line a build and a (case, build) run: ms, the largest difference
from the shipped build's gradients, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd  # noqa: E402

SOURCE = _build.SOURCES["flash_bwd"]
OUT = ROOT / "build" / "flash_bwd_variants"
SPLIT = "constexpr int kProducerRegs256 = 40, kConsumerRegs256 = 232;"
EARLY = ("""        hopper::wgmma_commit();
        pending = stage;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(fa);
    if (pending >= 0) release(pending);

    // Every consumer of the cluster""", """        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::fence_regs(fa);
        release(stage);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(fa);
    if (pending >= 0) release(pending);

    // Every consumer of the cluster""")


def edits(name: str):
    m = re.fullmatch(r"regs_(\d+)_(\d+)", name)
    if m:
        return [(SPLIT, f"constexpr int kProducerRegs256 = {m[1]}, kConsumerRegs256 = {m[2]};")]
    if name == "early_release":
        return [EARLY]
    raise SystemExit(f"unknown variant {name}: regs_P_C or early_release")


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name in ["shipped", *argv]:
        body = src
        for old, new in ([] if name == "shipped" else edits(name)):
            if old not in body:
                raise RuntimeError(f"{name}: {SOURCE} has no '{old[:60]}'")
            body = body.replace(old, new)
        (OUT / f"{name}.cu").write_text(body)
        # its header resolves from the original source's directory
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent), "-o", str(OUT / f"{name}.so"),
               str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({"build": name, "failed": log[-2000:]}), flush=True)
            return 1
        entries = chip_smoke.ptxas_entries(log.splitlines(), "flash_bwd_dkdv_wgmmaILi256E")
        print(json.dumps({"build": name, "dkdv_hd256_ptxas": entries}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    order = list(libs) + list(libs)[::-1]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, b, s, h, kvh, hd, dtype, window, cap, route in chip_smoke.FLASH_BWD_CASES:
        if hd != 256 or route != "wgmma":
            continue
        q, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn((b, s, kvh, hd), generator=gen, device="cuda").bfloat16() for _ in range(2))
        kw = dict(causal=True, window=window, logit_softcap=cap)
        out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
        shipped = None
        for name in order:
            _build._loaded["flash_bwd"] = libs[name]  # the wrapper launches this build
            grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
            shipped = grads if shipped is None else shipped
            diff = max((x.float() - y.float()).abs().max().item() for x, y in zip(grads, shipped))
            ms = chip_smoke.device_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw))
            print(json.dumps({"case": label, "build": name, "ms": ms, "max_abs_diff_vs_shipped": diff,
                              "nvidia_smi": smi}), flush=True)
        del q, k, v, do, out, lse, shipped, grads
    _build._loaded.pop("flash_bwd", None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
