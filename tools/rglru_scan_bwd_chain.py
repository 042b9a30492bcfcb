#!/usr/bin/env python3
"""Time what the carry chain costs ``rglru_scan_bwd.cu``, on the card.

    PYTHONPATH=src python3 tools/rglru_scan_bwd_chain.py

Builds, from this checkout's source, the shipped kernel and a diagnostic
build that does not wait for the next chunk's carry (each chunk then takes
whatever is in the scratch: its results are wrong, and it is never
shipped), into ``build/rglru_scan_bwd_chain/``, both ``nvcc`` runs
started together.  Each runs through the wrapper (``ops.rglru_scan_bwd``)
at train_recurrentgemma's per-pod 1 x 4096 x 4096 bf16 and at 4 x 4096,
timed as ``chip_smoke.py`` times a kernel, the two builds in turns
(shipped, nowait, nowait, shipped).  One JSON line a run: ms, the bytes
bound and the card's name.  The difference is the chain's cost: 64 hops
of a carry through L2 at T 4096.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd  # noqa: E402

SOURCE = _build.SOURCES["rglru_scan_bwd"]
OUT = ROOT / "build" / "rglru_scan_bwd_chain"
WAIT = "} while (x == kUnset || y == kUnset);"
SHAPES = ((1, 4096, 4096), (4, 4096, 4096))


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    if WAIT not in src:
        raise RuntimeError(f"{SOURCE} has no '{WAIT}'")
    procs = {}
    for name, body in (("shipped", src), ("nowait", src.replace(WAIT, "} while (false);"))):
        cu = OUT / f"{name}.cu"
        cu.write_text(body)
        # its headers resolve from the original source's directory
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent), "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({"build": name, "failed": log[-2000:]}), flush=True)
            return 1
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(6)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for b, t, dr in SHAPES:
        x, r, i, lam, h0 = chip_smoke.rglru_inputs(torch, gen, b, t, dr, "bfloat16", None)
        dy = torch.randn((b, t, dr), generator=gen, device="cuda").to(x.dtype)
        dh_last = torch.randn((b, dr), generator=gen, device="cuda")
        _, _, states = rglru_scan_fwd(x, r, i, lam, h0)
        for name in ("shipped", "nowait", "nowait", "shipped"):
            _build._loaded["rglru_scan_bwd"] = libs[name]  # the wrapper launches this build
            ms = chip_smoke.device_ms(lambda: rglru_scan_bwd(x, r, i, lam, h0, dy, dh_last, states=states))
            print(json.dumps({"build": name, "shape": [b, t, dr], "ms": ms,
                              "bound_ms": chip_smoke.rglru_bwd_bound(b, t, dr, "bfloat16")[0],
                              "nvidia_smi": smi}), flush=True)
        del x, r, i, lam, h0, dy, dh_last, states
    _build._loaded.pop("rglru_scan_bwd", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
