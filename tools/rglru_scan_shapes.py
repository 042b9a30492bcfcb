#!/usr/bin/env python3
"""Time ``rglru_scan.cu`` at other block shapes, on the card.

    PYTHONPATH=src python3 tools/rglru_scan_shapes.py 8,8,4 16,8,2 8,8,4,nowait

Each argument is ``segment,warps,blocks[,edit...]``: the kernel's ``kSeg``
(steps a warp walks), ``kWarps`` (warps a block; the chunk is their
product) and ``kBlocks`` (the blocks an SM the registers are sized for).
Edits make a diagnostic build that computes something else, to see what a
phase costs: ``nowait`` drops the wait on the previous chunk's flag (the
chunk starts are then wrong), ``cheap`` replaces the two ``expf`` and the
``sqrtf`` of a step's coefficients with a multiply.  Each variant is
built from this checkout's source into ``build/rglru_scan_shapes/`` (all
``nvcc`` runs started together), run twice at recurrentgemma-9b's prefill
shape (4 x 4096 x 4096 bf16) against ``rglru_scan_ref``, and timed as
``chip_smoke.py`` times a kernel.  One JSON line a variant: ms, the error
of h and h_last, whether two calls gave equal bits, and ptxas's registers
and spills.
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
from repro_torch.kernels.rglru_scan import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import SLICE  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu"
OUT = ROOT / "build" / "rglru_scan_shapes"
SHAPE = (4, 4096, 4096)
EDITS = {
    "nowait": [("while (ld_acquire(ready) == 0) __nanosleep(32);", ";")],
    "cheap": [("*a = expf(log_a);", "*a = log_a;"),
              ("sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f))", "(1.f - log_a)")],
}


def variant_source(seg: int, warps: int, blocks: int, edits) -> str:
    src = SOURCE.read_text()
    for old, new in [("constexpr int kSeg = ", f"constexpr int kSeg = {seg};  //"),
                     ("constexpr int kWarps = ", f"constexpr int kWarps = {warps};  //"),
                     ("constexpr int kBlocks = ", f"constexpr int kBlocks = {blocks};  //")]:
        if old not in src:
            raise RuntimeError(f"{SOURCE} has no '{old}'")
        src = src.replace(old, new, 1)
    for edit in edits:
        for old, new in EDITS[edit]:
            if old not in src:
                raise RuntimeError(f"edit {edit}: {SOURCE} has no '{old}'")
            src = src.replace(old, new)
    return src


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    builds = {}
    for arg in argv:
        seg, warps, blocks, *edits = arg.split(",")
        name = arg.replace(",", "_")
        (OUT / f"{name}.cu").write_text(variant_source(int(seg), int(warps), int(blocks), edits))
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds[arg] = (proc, name, int(seg) * int(warps))
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, t, dr = SHAPE
    x = torch.randn(SHAPE, generator=gen, device="cuda").bfloat16()
    r = torch.sigmoid(torch.randn(SHAPE, generator=gen, device="cuda")).bfloat16()
    i = torch.sigmoid(torch.randn(SHAPE, generator=gen, device="cuda")).bfloat16()
    lam = torch.logit(torch.linspace(0.9, 0.999, dr, device="cuda") ** (1 / 8))
    h0 = torch.randn((b, dr), generator=gen, device="cuda")
    plain, plain_last = rglru_scan_ref(x, r, i, lam, h0)
    flat = [s for a in (x, r, i) for s in a.stride()[:2]]
    strides = (ctypes.c_longlong * 6)(*flat)
    rc = 0
    for arg, (proc, name, chunk) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({"variant": arg, "build_failed": log[-2000:]}), flush=True)
            rc = 1
            continue
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).repro_rglru_scan
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        nc = -(-t // chunk)

        def call():  # as ops._launch allocates: outputs, scratch, zeroed flags and ticket
            h = torch.empty(SHAPE, dtype=x.dtype, device="cuda")
            last = torch.empty((b, dr), device="cuda")
            state = torch.empty((b, nc, dr), device="cuda")
            flags = torch.zeros(nc * b * -(-dr // SLICE) + 1, dtype=torch.int32, device="cuda")
            err = fn(x.device.index, 1, x.data_ptr(), r.data_ptr(), i.data_ptr(), ctypes.addressof(strides),
                     lam.data_ptr(), h0.data_ptr(), h.data_ptr(), last.data_ptr(), state.data_ptr(),
                     flags.data_ptr(), b, t, dr, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{arg}: CUDA error {err}")
            return h, last

        h, last = call()
        again, again_last = call()
        torch.cuda.synchronize()
        print(json.dumps({
            "variant": arg, "chunk": chunk, "ms": chip_smoke.device_ms(call),
            "bound_ms": chip_smoke.rglru_bound(b, t, dr, "bfloat16")[0],
            "max_abs_err_h": (h.float() - plain.float()).abs().max().item(),
            "max_abs_err_h_last": (last - plain_last).abs().max().item(),
            "two_calls_equal": torch.equal(h, again) and torch.equal(last, again_last),
            "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln],
            "device": torch.cuda.get_device_name(0),
        }), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
