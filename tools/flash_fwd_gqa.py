#!/usr/bin/env python3
"""Time the hd-128 GQA flash forward and backward at mixtral's and arctic's
shapes, on the card.

    PYTHONPATH=src python3 tools/flash_fwd_gqa.py
    python3 tools/flash_fwd_gqa.py --trees build/parent . . build/parent

With no ``--trees`` it times this checkout's kernels; with ``--trees`` it
runs itself once for each directory in turn, in a new process that imports
that checkout's ``src/`` and ``chip_smoke.py`` and builds its kernels into
that checkout's build directory (parent, change, change, parent: cards and
their power limits differ between calls).

Every time is ``chip_smoke.device_ms`` (calls captured in one CUDA graph),
bf16, causal, head_dim 128, one JSON line each with the card's name and
power limit:

* ``fwd_groups``: the forward at mixtral's prefill shape (4 x 4096, 48
  heads) with 48, 8 and 1 kv heads (G 1, 6, 48): the same FLOPs, from no
  K/V tile shared to a row's K/V that fits in L2;
* ``fwd_window``: mixtral's forward (48 over 8) with ``window=4096`` and
  with none, on the same inputs (a window of S cuts no pair);
* ``fwd_case``: mixtral 4 x 4096 (48 over 8, window 4096), arctic 4 x 4096
  (56 over 8), the mesh serving shard 2 x 4096 (24 over 4, window 4096),
  each beside ``scaled_dot_product_attention(is_causal=True,
  enable_gqa=True)`` on the same inputs;
* ``fwd_order``: mixtral's forward timed first, then right after the
  banded-mask ``scaled_dot_product_attention`` on the same inputs (4.85 ms
  a call on the H100) with no warm-up of its own (``warm_ms=0``, the
  helper before it warmed) and with ``chip_smoke.WARM_MS``: whether a
  reading depends on the call timed before it;
* ``bwd_case``: the backward at 1 x 4096 with 48 over 8 (window 4096 and
  none), 48 over 48 and 48 over 1, and the mesh training shard (1 x 4096,
  24 over 4, window 4096): the whole call, and its D, dK/dV and dQ
  kernels from ``chip_smoke.parts_ms`` (torch.profiler, so these come
  last).

Where the checkout's backward splits at head_dim 128, each backward case
is also timed at every cluster size it accepts there (``"kv_cluster"`` in
the line; ``null`` is the size the wrapper picks itself; ``--no-sizes``
times that one alone).  ``--only fwd`` or
``--only bwd`` times one side; ``--fwd-variants NAME ...`` also times the
forward of diagnostic builds of this checkout's ``flash_fwd.cu``
(``FWD_VARIANTS``; ``a+b`` applies both edits), text edits built beside the
shipped source into ``build/flash_fwd_gqa/`` (all ``nvcc`` runs started
together) and never shipped, each in place of the shipped build in turn.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()

# (label, B, S, H, KVH, window)
FWD_GROUPS = [("g1_h48_kvh48", 4, 4096, 48, 48, None), ("g6_h48_kvh8", 4, 4096, 48, 8, None),
              ("g48_h48_kvh1", 4, 4096, 48, 1, None)]
FWD_CASES = [("mixtral_gqa6_w4096", 4, 4096, 48, 8, 4096), ("arctic_gqa7", 4, 4096, 56, 8, None),
             ("mixtral_mesh_serve_h24_kvh4_w4096", 2, 4096, 24, 4, 4096)]
BWD_CASES = [("mixtral_train_gqa6_w4096", 1, 4096, 48, 8, 4096), ("mixtral_train_gqa6", 1, 4096, 48, 8, None),
             ("g1_h48_kvh48", 1, 4096, 48, 48, None), ("g48_h48_kvh1", 1, 4096, 48, 1, None),
             ("mixtral_mesh_train_h24_kvh4_w4096", 1, 4096, 24, 4, 4096)]
HD = 128
_QBUFS = "static constexpr int kQBufs = HD == 256 ? 1 : 2;"
_STAGES = "static constexpr int kStages = HD == 64 ? 4 : 2;"
_KN = "static constexpr int kN = HD == 256 ? 64 : 128;"
# name -> [(text, replacement)] in flash_fwd.cu: the diagnostic forward builds
# (head_dim 64 and 256 keep their tiling in each)
_TILES = "    uint32_t pa[kN / 16][4];\n    int tiles = 0;\n"
_PV_LAST = "      issue_pv(sV);\n      hopper::wgmma_wait<0>();\n      hopper::fence_regs(o);\n"
_END = "        hopper::mbar_arrive(bar_empty_q + 8 * qb);\n      }\n    }\n  }\n"
_RESCALE = ("      auto rescale_pack = [&]() {\n#pragma unroll\n        for (int j = 0; j < NO / 4; ++j) {\n"
            "          o[4 * j + 0] *= alpha[0];\n          o[4 * j + 1] *= alpha[0];\n"
            "          o[4 * j + 2] *= alpha[1];\n          o[4 * j + 3] *= alpha[1];\n        }\n")
FWD_VARIANTS = {
    # at head_dim 128 the two consumers issue their products in turns (named
    # barriers 5 + consumer), so that one's softmax runs under the other's
    # products; consumer 0 takes the first turn
    "pingpong": [
        (_TILES, "    uint32_t pa[kN / 16][4];\n"
                 "    auto turn_begin = [&]() { if (HD == 128) hopper::named_barrier_sync(5 + c, 256); };\n"
                 "    auto turn_end = [&]() { if (HD == 128) hopper::named_barrier_arrive(6 - c, 256); };\n"
                 "    if (c == 1) turn_end();\n    int tiles = 0;\n"),
        ("      issue_qk(wait_k(it.kt_beg));\n",
         "      const uint32_t sK0 = wait_k(it.kt_beg);\n      turn_begin();\n      issue_qk(sK0);\n      turn_end();\n"),
        ("        issue_qk(sK);\n", "        turn_begin();\n        issue_qk(sK);\n"),
        ("        issue_pv(sV);\n        hopper::wgmma_wait<1>();",
         "        issue_pv(sV);\n        turn_end();\n        hopper::wgmma_wait<1>();"),
        (_PV_LAST, "      turn_begin();\n" + _PV_LAST.replace("issue_pv(sV);\n", "issue_pv(sV);\n      turn_end();\n")),
        (_END, _END[:-4] + "    if (c == 0) turn_begin();  // consumer 1's last turn_end\n  }\n"),
    ],
    # at head_dim 128 O is rescaled by the last tile's alpha under the next
    # tile's Q K^T, not before it is issued
    "rescale_early": [
        (_RESCALE, _RESCALE.replace("      auto rescale_pack = [&]() {\n", "      auto rescale_o = [&]() {\n")
         + "      };\n      auto rescale_pack = [&]() {\n        if (HD != 128) rescale_o();\n"),
        ("        issue_qk(sK);\n", "        issue_qk(sK);\n        if (HD == 128) {\n          rescale_o();\n"
                                   "          hopper::fence_regs(o);\n          hopper::wgmma_fence();\n        }\n"),
        ("      const uint32_t sV = wait_v(it.kt_end - 1);\n",
         "      const uint32_t sV = wait_v(it.kt_end - 1);\n      if (HD == 128) rescale_o();\n"),
    ],
    # clock counters in the consumers (repro_flash_fwd_clocks): cycles a
    # warpgroup spends in each phase of a tile, summed over the launch
    "clocks": [
        ("    int tiles = 0;\n    for (int i = 0; item_index(i) < n_items; ++i) {\n",
         "    uint32_t clk[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "    int tiles = 0;\n    for (int i = 0; item_index(i) < n_items; ++i) {\n"
         "      const uint32_t c_item = clock();\n"),
        ("      for (int kt = it.kt_beg + 1; kt < it.kt_end; ++kt) {\n"
         "        const uint32_t sK = wait_k(kt);\n        const uint32_t sV = wait_v(kt - 1);\n",
         "      for (int kt = it.kt_beg + 1; kt < it.kt_end; ++kt) {\n        uint32_t c0 = clock();\n"
         "        const uint32_t sK = wait_k(kt);\n        const uint32_t sV = wait_v(kt - 1);\n"
         "        uint32_t c1 = clock();\n        clk[0] += c1 - c0;\n"),
        ("        issue_pv(sV);\n        hopper::wgmma_wait<1>();  // Q K^T(kt) has landed; P V(kt - 1) may still run\n"
         "        hopper::fence_regs(s);\n",
         "        issue_pv(sV);\n        c0 = clock();\n        clk[1] += c0 - c1;\n"
         "        hopper::wgmma_wait<1>();  // Q K^T(kt) has landed; P V(kt - 1) may still run\n"
         "        hopper::fence_regs(s);\n        c1 = clock();\n        clk[2] += c1 - c0;\n"),
        ("        softmax(kt);\n        hopper::wgmma_wait<0>();\n        hopper::fence_regs(o);\n",
         "        softmax(kt);\n        hopper::fence_regs(s);\n        c0 = clock();\n        clk[3] += c0 - c1;\n"
         "        hopper::wgmma_wait<0>();\n        hopper::fence_regs(o);\n        c1 = clock();\n"
         "        clk[4] += c1 - c0;\n"),
        ("        rescale_pack();\n      }\n      // The last tile's P V.\n",
         "        rescale_pack();\n        hopper::fence_regs(o);\n        clk[5] += clock() - c1;\n        ++clk[6];\n"
         "      }\n      // The last tile's P V.\n"),
        ("        hopper::mbar_arrive(bar_empty_q + 8 * qb);\n      }\n    }\n",
         "        hopper::mbar_arrive(bar_empty_q + 8 * qb);\n      }\n      clk[7] += clock() - c_item;\n    }\n"
         "    if (threadIdx.x % 128 == 0)\n"
         "      for (int j = 0; j < 8; ++j) atomicAdd(&g_fwd_clocks[8 * c + j], static_cast<unsigned long long>(clk[j]));\n"),
        ("const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }\n",
         "const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }\n\n"
         "int repro_flash_fwd_clocks(unsigned long long* out) {\n"
         "  cudaError_t e = cudaMemcpyFromSymbol(out, g_fwd_clocks, sizeof(g_fwd_clocks));\n"
         "  unsigned long long zero[16] = {};\n"
         "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_fwd_clocks, zero, sizeof(zero));\n"
         "  return static_cast<int>(e);\n}\n"),
        ("namespace {\n\nconstexpr int kBlockM = 64;",
         "__device__ unsigned long long g_fwd_clocks[16];  // [consumer][phase]\n\nnamespace {\n\nconstexpr int kBlockM = 64;"),
    ],
    # at head_dim 128: one query buffer, a K/V ring of 3 (224 KB)
    "q1_s3": [(_QBUFS, "static constexpr int kQBufs = HD == 64 ? 2 : 1;"),
              (_STAGES, "static constexpr int kStages = HD == 64 ? 4 : HD == 128 ? 3 : 2;")],
    # at head_dim 128: 64-key K/V tiles in a ring of 4 or 5
    "kn64_s4": [(_KN, "static constexpr int kN = HD == 64 ? 128 : 64;"),
                (_STAGES, "static constexpr int kStages = HD == 256 ? 2 : 4;")],
    "kn64_s5": [(_KN, "static constexpr int kN = HD == 64 ? 128 : 64;"),
                (_STAGES, "static constexpr int kStages = HD == 256 ? 2 : HD == 128 ? 5 : 4;")],
}


def start_variant(_build, name):
    """Start nvcc on diagnostic build ``name`` (its edits applied to this
    checkout's flash_fwd.cu, built with the shipped flags beside its header)
    -> (process, library path)."""
    source = _build.SOURCES["flash_fwd"]
    text = source.read_text()
    for part in name.split("+"):
        for old, new in FWD_VARIANTS[part]:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {source} holds '{old}' {text.count(old)} times, not once")
            text = text.replace(old, new)
    out = _build.BUILD_DIR.parent / "flash_fwd_gqa"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(source.parent), "-o", str(out / f"{name}.so"),
           str(out / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out / f"{name}.so"


def load_variant(proc, path):
    import ctypes

    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {path}:\n{log[-3000:]}")
    lib = ctypes.CDLL(str(path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


def one_tree(src: Path, only=None, fwd_variants=(), sizes=True) -> int:
    root = src.parent
    sys.path[:0] = [str(src), str(root)]
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    started = {name: start_variant(_build, name) for name in fwd_variants}
    report = _build.build(["flash_fwd", "flash_bwd"])
    builds = {None: _build.load("flash_fwd")}
    tree = str(root)
    fwd_variant = None

    def emit(obj):
        print(json.dumps({"tree": tree, "fwd_variant": fwd_variant, **obj, "nvidia_smi": smi}), flush=True)

    emit({"build_s": {n: s for n, (s, _) in report.items()}})
    for name, (proc, path) in started.items():
        builds[name], log = load_variant(proc, path)
        emit({"variant_ptxas": chip_smoke.ptxas_entries(log.splitlines(), "flash_fwd_wgmmaILi128E"), "variant": name,
              "serialised": [ln for ln in log.splitlines() if any(k in ln for k in chip_smoke.PTXAS_KEEP[2:5])]})
    bwd_sizes = _sizes(ops) if sizes else lambda groups: []
    gen = torch.Generator(device="cuda").manual_seed(3)

    def inputs(b, s, h, kvh):
        q = torch.randn((b, s, h, HD), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((b, s, kvh, HD), generator=gen, device="cuda").bfloat16() for _ in range(2))
        return q, k, v

    def timed(fn):
        """device ms, or the error of a launch the card refused (a cluster that does not fit)"""
        try:
            return chip_smoke.device_ms(fn)
        except RuntimeError as e:
            return f"refused: {e}"

    for fwd_variant, lib in builds.items() if only != "bwd" else []:
        _build._loaded["flash_fwd"] = lib  # the wrapper launches this build
        for label, b, s, h, kvh, window in FWD_GROUPS:
            q, k, v = inputs(b, s, h, kvh)
            emit({"kind": "fwd_groups", "label": label, "G": h // kvh,
                  "ms": timed(lambda: flash_attention_fwd(q, k, v, window=window))})
            del q, k, v
        q, k, v = inputs(4, 4096, 48, 8)
        for window in (4096, None):
            emit({"kind": "fwd_window", "label": "mixtral_h48_kvh8", "window": window,
                  "ms": timed(lambda: flash_attention_fwd(q, k, v, window=window))})
        qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = torch.ones((4096, 4096), dtype=torch.bool, device="cuda").tril()  # window 4096 = S: causal

        def kernel():
            return flash_attention_fwd(q, k, v, window=4096)

        def banded():
            return F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask, enable_gqa=True)

        order = {"first": chip_smoke.device_ms(kernel)}
        order["banded_sdpa"] = chip_smoke.device_ms(banded)
        order["after_banded_warm_0"] = chip_smoke.device_ms(kernel, warm_ms=0)
        chip_smoke.device_ms(banded)
        order["after_banded_warm"] = chip_smoke.device_ms(kernel)
        emit({"kind": "fwd_order", "label": "mixtral_gqa6_w4096", "ms": order, "warm_ms": chip_smoke.WARM_MS})
        del q, k, v, qc, kc, vc, mask
        for label, b, s, h, kvh, window in FWD_CASES:
            q, k, v = inputs(b, s, h, kvh)
            qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = chip_smoke.device_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                                               enable_gqa=True))
            plain = ops.flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), window=window)[0]
            err = (flash_attention_fwd(q, k, v, window=window).transpose(1, 2).float() - plain.float()).abs().max()
            bound_ms, bound_by = chip_smoke.flash_bound(b, s, h, kvh, HD, "bfloat16", window)
            emit({"kind": "fwd_case", "label": label, "ms": timed(lambda: flash_attention_fwd(q, k, v, window=window)),
                  "sdpa_is_causal_ms": sdpa, "bound_ms": bound_ms, "bound_by": bound_by,
                  "max_abs_err_vs_plain": err.item()})
            if hasattr(lib, "repro_flash_fwd_clocks"):  # the "clocks" build: one launch's phase cycles
                import ctypes

                clocks = (ctypes.c_ulonglong * 16)()
                lib.repro_flash_fwd_clocks.argtypes = [ctypes.c_void_p]
                lib.repro_flash_fwd_clocks(ctypes.addressof(clocks))  # zeroes them
                flash_attention_fwd(q, k, v, window=window)
                torch.cuda.synchronize()
                if lib.repro_flash_fwd_clocks(ctypes.addressof(clocks)):
                    raise RuntimeError("repro_flash_fwd_clocks failed")
                names = ("wait_kv", "issue", "wait_qk", "softmax", "wait_pv", "rescale_pack", "tiles", "item")
                emit({"kind": "fwd_clocks", "label": label, "clocks_is": "cycles summed over the launch's CTAs, "
                      "one warpgroup each, in the tiles after an item's first (tiles: their count; item: whole "
                      "items, epilogue and first tile included)",
                      "consumer": [dict(zip(names, clocks[8 * c:8 * c + 8])) for c in range(2)]})
            del q, k, v, qc, kc, vc, plain
    fwd_variant = None
    _build._loaded["flash_fwd"] = builds[None]
    bwd_cases = BWD_CASES if only != "fwd" else []
    for label, b, s, h, kvh, window in bwd_cases:
        q, k, v = inputs(b, s, h, kvh)
        do = torch.randn((b, s, h, HD), generator=gen, device="cuda").bfloat16()
        out, lse = flash_attention_fwd(q, k, v, window=window, with_lse=True)
        bound_ms, bound_by = chip_smoke.flash_bwd_bound(b, s, h, kvh, HD, "bfloat16", window)
        for size in [None, *bwd_sizes(h // kvh)]:
            kw = {} if size is None else {"kv_cluster": size}
            ms = timed(lambda: flash_attention_bwd(q, k, v, out, lse, do, window=window, **kw))
            emit({"kind": "bwd_case", "label": label, "kv_cluster": size, "ms": ms, "bound_ms": bound_ms,
                  "bound_by": bound_by})
        del q, k, v, do, out, lse
    for label, b, s, h, kvh, window in bwd_cases:  # the profiler moves the device times after it: last
        q, k, v = inputs(b, s, h, kvh)
        do = torch.randn((b, s, h, HD), generator=gen, device="cuda").bfloat16()
        out, lse = flash_attention_fwd(q, k, v, window=window, with_lse=True)
        for size in [None, *bwd_sizes(h // kvh)]:
            kw = {} if size is None else {"kv_cluster": size}
            parts = chip_smoke.parts_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, window=window, **kw),
                                        chip_smoke.FLASH_BWD_PARTS)
            emit({"kind": "bwd_parts", "label": label, "kv_cluster": size, "parts_ms": parts,
                  "parts_ms_is": chip_smoke.PARTS_MS_IS})
        del q, k, v, do, out, lse
    return 0


def _sizes(ops):
    """groups -> the cluster sizes the checkout's backward takes at head_dim
    128 for that many query heads a kv head (none where it splits at head_dim
    256 alone)."""
    allowed = getattr(ops, "KV_CLUSTER_SIZES", {}).get(HD, ())
    return lambda groups: [s for s in allowed if groups % s == 0]


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--trees", nargs="+", help="checkouts to time in turn, each in its own process")
    parser.add_argument("--only", choices=("fwd", "bwd"), help="time the forward or the backward alone")
    parser.add_argument("--fwd-variants", nargs="+", default=[], help="diagnostic forward builds (FWD_VARIANTS)")
    parser.add_argument("--no-sizes", action="store_true", help="time the cluster size the wrapper picks alone")
    parser.add_argument("--src", help=argparse.SUPPRESS)  # the child's: a checkout's src/ directory
    args = parser.parse_args(argv)
    for name in args.fwd_variants:
        if any(part not in FWD_VARIANTS for part in name.split("+")):
            parser.error(f"unknown variant {name}: {sorted(FWD_VARIANTS)}")
    more = ((["--only", args.only] if args.only else []) + (["--no-sizes"] if args.no_sizes else [])
            + (["--fwd-variants", *args.fwd_variants] if args.fwd_variants else []))
    if args.trees:
        rc = 0
        for tree in args.trees:
            src = Path(tree).resolve() / "src"
            proc = subprocess.run([sys.executable, str(HERE), "--src", str(src), *more], timeout=1800)
            rc = rc or proc.returncode
        return rc
    return one_tree(Path(args.src).resolve() if args.src else HERE.parents[1] / "src", args.only,
                    args.fwd_variants, not args.no_sizes)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
