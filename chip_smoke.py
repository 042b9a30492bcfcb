#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each printing one JSON line on stdout:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions.
2. ``build``: every kernel of the port compiled from this checkout's sources
   (one ``nvcc`` per source, all started together), with ptxas's
   registers and spills; the hd-256 ``wgmma`` flash instances, forward
   and backward, must not spill (the float32 ones at 256 and
   ``rglru_scan_bwd``'s are listed).
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes and the variants below, with times: the flash
   forward and backward, the WAN int8 quantiser and dequantiser, the RWKV6
   WKV recurrence and its backward (``wkv6_bwd``: dr, dk, dv, dw, du and
   dstate0 against ``wkv6_bwd_ref`` and ``wkv6_bwd_chunked_ref`` at N 8,
   16, 32, 64, 128, bf16 and float32, T from 1 to 4096 across the 16-step
   sub-chunk and the 256-step chunk, w at 1e-30, at a denormal and at 0,
   each launch on the route ``bwd_route`` names; ``wkv6`` under grad
   against autograd through ``wkv6_ref``; timed at 4 x 4096 and 2 x 4096,
   with the forward's serving instance and its training instance, which
   also saves the state every 256 steps); the flash forward at head_dim
   256 on ``wgmma`` (recurrentgemma-9b's local attention: 4 x 4096, 16
   heads over 1 kv head, window 2048, with ``sdpa`` timed beside it twice,
   with the banded mask and unwindowed; a ragged and an unwindowed shape);
   and the RG-LRU scan (``rglru_scan``, one launch, h and h_last against
   ``rglru_scan_ref``) at the recurrentgemma-9b prefill's 4 x 4096 x 4096
   and decode step's shapes, T one past a chunk and one past a multiple of
   it, float32, and extreme gates, two calls bit-equal; its backward
   (``rglru_scan_bwd``: dx, dr, di, dlam and dh0 against
   ``rglru_scan_bwd_chunked_ref`` from the forward kernel's chunk states,
   cotangents on h and h_last) at train_recurrentgemma's 1 x 4096 x 4096,
   4 x 4096 x 4096 and the forward's shapes, two calls bit-equal; the
   flash backward at head_dim 256 (``wgmma``) at train_recurrentgemma's
   1 x 4096 (16 heads over 1, window 2048; ``sdpa`` forward + backward
   beside it with the banded mask and unwindowed), a ragged and an
   unwindowed shape, and the float32 forward and backward at 256; the
   MoE archs' attention at head_dim 128 on ``wgmma``: the forward at 4 x
   4096 with mixtral-8x22b's 48 heads over 8 (window 4096) and
   arctic-480b's 56 over 8 (groups of 7), the backward at train_mixtral's
   1 x 4096, each with ``sdpa`` beside it; ``wan_quant`` / ``wan_dequant``
   also on train_mixtral's stacked 2-pod expert gradient (98,304 x 16,384);
   and the shards a mesh_models rank hands them: ``rglru_scan`` at 2 x
   4096 x 2048 and 2 x 4096 x 1024 (its backward at the latter), the flash
   forward at hd 256 with 8 and 4 query heads over 1 (2 x 4096) and at hd
   128 with 24 over 4 (2 x 4096 serving on (data 2, model 2), 1 x 4096
   training there), the backward at the training two.
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
   s); then one whole ``hier_int8`` step at global batch 2 x 128 on the
   card against the CPU (loss, gradient norm, every first-moment leaf, which
   is the synced gradient scaled, and every parameter leaf it writes back).
   ``train_ps`` and ``train_local_sgd``: the same run under the parameter
   server and under local SGD with the DiLoCo outer step (H = 8: step 7 is
   the outer step), each with its WAN bytes held to their analytic values,
   12 + 12 flash launches a step on ``wgmma`` and no ``wan_quant``, and its
   own step on the card against the CPU (for local_sgd an outer step).
   ``train_group``: the pod axis as a process group: 2 ranks on the card,
   one gloo group, each running ``GeoTrainer`` on a ``"pod"`` DeviceMesh
   at full width with its 8 x 1024 rows of the global batch: ``hier_int8``
   for the ``train`` phase's 12 steps, ``allreduce``, ``hier`` and ``ps``
   for 3, ``local_sgd`` for 8 (its outer step at step 7), the WAN
   strategies as real collectives.  Each rank's losses must equal the
   one-process losses bit for bit (``train``, ``train_ps``,
   ``train_local_sgd``, and 3-step one-process runs of ``allreduce`` and
   ``hier`` made in this phase), every flash launch take ``wgmma``
   (``wan_quant`` and ``wan_dequant`` 19 a step a rank under
   ``hier_int8``), parameters and state stay on the card, and the bytes
   the ranks handed to the collectives give each strategy's analytic WAN
   bytes on every step.  Per rank: the losses, step and collective
   milliseconds, counted bytes, launches and routes.
   ``train_mesh``: intra-pod placement: 4 ranks on the card over gloo,
   GeoTrainer at full width on the 16 x 1024 global batch over a
   ``(pod 2, data 2)`` mesh (``hier_int8`` 6 steps, ``allreduce`` 3: FSDP
   over data, the WAN strategy over pod on each rank's pieces) and a
   ``(data 2, model 2)`` mesh (FSDP, tensor and sequence parallelism, 3
   steps; the last step reduce-scatters onto the rank's ``[8, 512, 768]``
   and all-reduces no ``[8, 1024, 768]`` activation).
   Losses fall and agree with the one-process runs of the same rows and
   weights (first step rtol 1e-3, later 5e-3), the WAN bytes summed over a
   pod's ranks equal the analytic ones, every flash launch is on
   ``wgmma`` (the rank's rows and, over model, its 6 heads), ``wan_quant``
   / ``wan_dequant`` run once a non-empty piece; per rank the median step,
   WAN and LAN host seconds and bytes, launches and peak memory.
   ``serve_mesh``: ``(data 2, model 2)``, 4 ranks, the serve phase's
   weights and 8 x 1024 prompts: prefill and 4 decode steps fed the
   one-process run's greedy tokens, held to it at rtol = atol = 5e-2, the
   greedy tokens equal but on near-ties (the one-process top two within
   the tolerance), 6 flash launches a rank on ``wgmma``.
   ``train_scenario``: the scenario path, a ``repro_torch.scenario.Scenario``
   (``repro_torch.examples.train_geo``'s spec: 2 DCs, ``hier_int8``, 12
   steps) whose event script (a BFD-detected link flap at steps 3-6, a
   brownout of the DC pair at steps 4-8) is replayed at step boundaries,
   through ``GeoTrainer(scenario=...)``, whose pod count the spec gives,
   with the ``train`` phase's configuration: its losses must equal
   ``train``'s (rtol 1e-6), with one
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
   ``serve_recurrentgemma``: recurrentgemma-9b at full width and depth
   (38 layers: 26 RG-LRU, 12 local attention at head_dim 256; 9.4 B
   parameters, random weights from a seed): prefill of 4 x 4096 tokens,
   then 32 greedy decode steps, with 26 ``rglru_scan`` and 12
   ``flash_attention_fwd`` (``wgmma``) launches a prefill and 26
   ``rglru_scan`` a decode step; the LRU state, conv tail and rolling
   window cache carried from a 4096-token prefill through one decode step
   against a 4097-token prefill, at 3, 12, 24 and all 38 layers (the
   first groups of the same weights); then one group (3 layers) at full
   width, its window cut to 128, on the card against the CPU on a
   [1, 256] prompt (prefill and 4 decode steps): in relative norm against
   the CPU bf16 run, and elementwise against the CPU float32 run at no
   more than 1.5 x the CPU bf16 run's own distance from it; and that
   cut's state carry (256 tokens and a decode step against 257) on the
   card, on the CPU in bf16 and on the CPU in float32, where it must be
   within 1e-4.
7. ``train_rwkv``: rwkv6-7b at full width (d_model 4096, 64 heads of 64,
   d_ff 14336, vocab 65536), its depth cut to 4 of 32 layers (1.41 B
   parameters), through ``GeoTrainer``: 2 pods, ``hier_int8``, global
   batch 4 x 4096, bf16 compute, float32 parameters, AdamW, 2 untimed and
   4 timed steps, no checkpoint written.  Losses finite and falling; per
   step 8 ``wkv6_fwd`` and 8 ``wkv6_bwd`` launches (pods x layers: the
   rematerialised forward replays the first one's WKV outputs; every
   ``wkv6_bwd`` launch on bf16's ``tf32`` route) and a
   ``wan_quant`` / ``wan_dequant`` a leaf; WAN bytes a pod a step within 1%
   of ``wan_bytes_per_step``.  Then one step of a 2-layer cut on one
   768-token sequence (three 256-step chunks) on the card against the CPU:
   the loss and each leaf's gradient (relative norm) at 5e-2, or at 1.5 x
   the CPU bf16 gradient's own distance from the card's float32 one where
   bf16 resolves a leaf no better (the bonus u).
   ``train_recurrentgemma``: recurrentgemma-9b at full width (d_model =
   d_rnn 4096, 16 heads of 256 over 1, window 2048, GeGLU d_ff 12288,
   vocab 256,000), its depth cut to one group (recurrent, recurrent, local
   attention; 1.71 B parameters in 37 leaves), through ``GeoTrainer``: 2
   pods, ``hier_int8``, global batch 2 x 4096, bf16 compute, float32
   parameters, AdamW, ``remat="full"``, 2 untimed and 4 timed steps, no
   checkpoint written, the step built with ``donate=True`` (parameters,
   moments and error feedback updated in their own storage: a second copy
   does not fit).  Losses finite and falling; per step 8
   ``rglru_scan`` and 4 ``rglru_scan_bwd`` launches, 4 flash forward and 2
   backward (pods x layers; the rematerialised forward launches each
   forward kernel again), every flash backward on ``wgmma``, and a
   ``wan_quant`` / ``wan_dequant`` a leaf; WAN bytes a pod a step within 1%
   of ``wan_bytes_per_step``.  Then one step of the cut, its window cut to
   128, on one 256-token sequence (four 64-step scan chunks) on the card in
   bf16 and in float32 (the f32 flash routes at 256) against the CPU in
   bf16: the loss and each leaf's gradient (relative norm) at 5e-2, or at
   1.5 x the CPU bf16 gradient's own distance from the card's float32 one.
   ``serve_mixtral``: mixtral-8x22b at full width (d_model 6144, 48 heads
   of 128 over 8, window 4096, 8 SwiGLU experts of d_ff 16384 top-2,
   capacity factor 1.25, vocab 32768, bf16 parameters; 30.45 B parameters),
   its depth cut to 12 of 56 layers: a prefill of 4 x 4096 tokens (the
   einsum dispatch over 32 groups of 512, capacity 160 an expert), then 32
   greedy decode steps past the window; 12 flash launches a prefill, all
   on ``wgmma``, none in decode; the choices each layer's capacity dropped;
   then one layer at full width computing in float32 on the card against
   the CPU on a [1, 128] prompt (prefill and 4 decode steps): every token's
   expert choices (apart only at near-ties) and the logits where they
   agree, at 1e-4.  ``train_mixtral``: one of 56 layers at full width
   (2.91 B parameters), 2 pods ``hier_int8``, 2 x 4096, ``remat="full"``,
   AdamW, the donating step, 2 untimed and 4 timed steps: losses falling,
   the aux loss above 0 each step, 4 + 2 flash launches a step on
   ``wgmma`` and a ``wan_quant`` / ``wan_dequant`` a leaf, WAN bytes
   within 1% of the analytic; then the same bf16 donating step at 2 x 128
   on the card against the CPU, the CPU routed by the card's expert
   choices (loss, aux, gradient norm, every first-moment and parameter
   leaf, each token's own choice apart only at a near-tie).  ``serve_arctic``:
   arctic-480b at full width (d_model 7168, 56 heads over 8, 128 experts
   of d_ff 4864 top-2 beside its dense FFN, vocab 32000; 27.68 B
   parameters), 2 of 35 layers, 4 x 4096 and 8 decode steps, the same
   numbers and checks as ``serve_mixtral``.  Training arctic-480b does not
   fit one card (a layer's float32 moments alone are 109 GB).
   ``mesh_recurrentgemma`` and ``mesh_mixtral`` (one 4-rank spawn on the
   card, gloo): recurrentgemma-9b's one group and mixtral-8x22b's 2 layers
   served on ``(data 2, model 2)`` (4 x 4096, 4 decode steps fed the
   one-process run's greedy tokens), its one group trained 3 ``allreduce``
   steps on ``(data 1, model 4)`` and mixtral's one layer on ``(data 2,
   model 2)`` (2 x 4096), the step donating (parameters and moments
   updated in their own storage: every local tensor's ``data_ptr`` the
   same after each step) and sequence parallel (the residual's sequence
   over model between blocks: each step reduce-scatters onto the rank's
   ``[B / data, S / model, D]`` and all-reduces no ``[B / data, S, D]``
   activation but the RG-LRU's gate products), bf16 compute, seed-0
   weights; each run held to a one-process run of the
   same weights and rows made first on the card (logits at SERVE_TOL,
   recurrentgemma-9b's in relative norm as ``serve_recurrentgemma`` holds
   them, greedy tokens equal but on near-ties; losses at MESH_LOSS_RTOL;
   parameters after the last step within MESH_PARAM_RTOL of the
   one-process change; mixtral's expert choices per router call and its
   aux, the mesh's training routed by the one-process choices).  Every
   RG-LRU scan and flash forward call is handed the rank's shard (rows over
   data, Dr and query heads over model), every flash launch is on
   ``wgmma``, and no LAN collective is handed the dispatched MoE
   activations.  Per rank: prefill, decode and step ms, peak GB, the card's
   least free memory over a training run, LAN bytes and calls (in
   training by kind: reduce-scatters, all-gathers, all-reduces), launches
   and routes.
8. ``quickstart``: ``repro_torch.examples.quickstart`` on the CPU, then on
   the card, each in a fresh checkpoint directory: the fabric, port and
   cost lines (numpy) equal, the card's 20 losses falling, 2 flash
   launches a step each way.
9. ``dryrun``: the dry run (``repro_torch.launch.dryrun``) against the card.
   (a) Its trace of ``train``'s step and of the recurrentgemma-9b and
   mixtral-8x22b prefills, on fake tensors at world 1: the predicted peak
   within DRYRUN_PEAK_BAND of the ``max_memory_allocated`` those phases
   measured, the counted FLOPs and bytes over their measured ms (TFLOP/s,
   share of the bf16 peak) and model FLOPs over counted FLOPs.  (b) Five
   production cells on fake 256- and 512-rank groups (DRYRUN_CELLS), each
   command in its own process beside (a), each record's summary printed;
   every cell ``ok``, the phase within DRYRUN_TIMEOUT_S.

Then the ``{"kernels": [...]}`` summary, the card's name and power limit as
``nvidia-smi`` prints them, and, last, ``{"ok": true, "device": ...}``.
A kernel's ``ms`` (and ``library_ms``) is its device time: ``GRAPH_CALLS``
calls captured in one CUDA graph, the replay timed with one event pair and
divided by the count, so the wrapper's host time is left out.  ``call_ms``
(and ``library_call_ms``) is the median of event pairs around single
Python calls, host included, as earlier runs reported ``ms``.  The flash
backward's ``library_ms`` is ``scaled_dot_product_attention``'s forward and
backward together, ``library_bwd_ms`` its backward alone (one forward
outside the graph, the backward captured on the forward's stream).  A
windowed forward's ``library_ms`` is ``scaled_dot_product_attention``
with a banded causal boolean mask, made once outside the timed calls;
a softcapped one has none.  Each
flash check, and every flash launch of the serve and train phases, is held
to the route ``fwd_route`` / ``bwd_route`` names.
Any failure raises: the script exits non-zero and prints no result.  It
also fails without a card, and where the port's sources are absent.
"""

from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path


ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The H100's data-sheet rates and every kernel's work: src/repro_torch/kernels/costs.py.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # kernel vs plain; rtol = atol
SERVE_TOL = 5e-2  # bf16 logits, card vs CPU: rounding points differ
TRAIN_TOL = 5e-2  # bf16 loss, grad norm, synced leaves (relative norm), card vs CPU
# card vs CPU after one step: each parameter leaf's distance at most
# UPDATE_TOL of the CPU's update, on the lanes it resolves: the two sides'
# first moments agree in sign and the bias-corrected one is RESOLVED_M x
# AdamW's eps or more.  There AdamW's first update, lr * g / (|g| + eps),
# is lr * sign(g) to within 1%; elsewhere a gradient's rounding flips its
# sign or, near eps, scales it.  The bar is TRAIN_TOL's: an update that is
# not written back stands 1 apart.
UPDATE_TOL, RESOLVED_M = TRAIN_TOL, 100

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
    # recurrentgemma-9b's local attention (hd 256, MQA, window 2048) at the
    # serve_recurrentgemma prefill's shape, a ragged one whose window cuts
    # mid-tile, and hd 256 with no window (sdpa beside it); float32 at 256
    # (the train_recurrentgemma float32 check's route)
    ("rg9b_hd256_mqa_w2048", 4, 4096, 16, 1, 256, "bfloat16", 2048, None, "wgmma"),
    ("rg9b_train_hd256_mqa_w2048", 1, 4096, 16, 1, 256, "bfloat16", 2048, None, "wgmma"),
    ("hd256_ragged_s300_w128", 1, 300, 16, 1, 256, "bfloat16", 128, None, "wgmma"),
    ("hd256_h4_kvh1", 2, 1024, 4, 1, 256, "bfloat16", None, None, "wgmma"),
    ("hd256_f32_w128", 1, 512, 4, 1, 256, "float32", 128, None, "f32"),
    # the MoE archs' attention at the serve_mixtral / serve_arctic prefill's
    # shape: mixtral 48 heads over 8 (groups of 6), window 4096; arctic 56
    # over 8 (groups of 7), no window
    ("mixtral_gqa6_w4096", 4, 4096, 48, 8, 128, "bfloat16", 4096, None, "wgmma"),
    ("arctic_gqa7", 4, 4096, 56, 8, 128, "bfloat16", None, None, "wgmma"),
    # one rank's shard in mesh_models: its 2 rows of the 4 x 4096 prefill
    # on (data 2, model 2); its training rows, recurrentgemma-9b's 2 x 4096
    # on (data 1, model 4), mixtral-8x22b's 1 x 4096 on (data 2, model 2)
    ("rg9b_mesh_serve_hd256_h8_kvh1_w2048", 2, 4096, 8, 1, 256, "bfloat16", 2048, None, "wgmma"),
    ("rg9b_mesh_train_hd256_h4_kvh1_w2048", 2, 4096, 4, 1, 256, "bfloat16", 2048, None, "wgmma"),
    ("mixtral_mesh_serve_h24_kvh4_w4096", 2, 4096, 24, 4, 128, "bfloat16", 4096, None, "wgmma"),
    ("mixtral_mesh_train_h24_kvh4_w4096", 1, 4096, 24, 4, 128, "bfloat16", 4096, None, "wgmma"),
]
# windowed cases where sdpa is also timed unwindowed (is_causal=True) on the
# same inputs: more pairs than the window keeps, but no S x S mask to read
SDPA_UNWINDOWED_TOO = ("rg9b_hd256_mqa_w2048", "rg9b_train_hd256_mqa_w2048")
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
    # recurrentgemma-9b's local attention at the train_recurrentgemma pod's
    # shape (1 x 4096, 16 heads over 1, window 2048), a ragged one whose
    # window cuts mid-tile, hd 256 unwindowed, and float32 at 256
    ("rg9b_train_hd256_mqa_w2048", 1, 4096, 16, 1, 256, "bfloat16", 2048, None, "wgmma"),
    ("hd256_ragged_s300_w128", 1, 300, 16, 1, 256, "bfloat16", 128, None, "wgmma"),
    ("hd256_h4_kvh1", 2, 1024, 4, 1, 256, "bfloat16", None, None, "wgmma"),
    ("hd256_f32_w128", 1, 512, 4, 1, 256, "float32", 128, None, "f32"),
    # mixtral-8x22b's attention at the train_mixtral pod's shape (one
    # 4096-token row, 48 heads over 8, window 4096)
    ("mixtral_train_gqa6_w4096", 1, 4096, 48, 8, 128, "bfloat16", 4096, None, "wgmma"),
    # one rank's shard of mesh_models' training: recurrentgemma-9b's on
    # (data 1, model 4), mixtral-8x22b's on (data 2, model 2)
    ("rg9b_mesh_train_hd256_h4_kvh1_w2048", 2, 4096, 4, 1, 256, "bfloat16", 2048, None, "wgmma"),
    ("mixtral_mesh_train_h24_kvh4_w4096", 1, 4096, 24, 4, 128, "bfloat16", 4096, None, "wgmma"),
]
# head dims the wrappers zero-pad to 16 (each such launch also moves PADDED_LAUNCHES)
PADDED_HDS = (8, 12)
# (label, rows, cols): the stacked 2-pod largest leaves and a ragged one
WAN_CASES = [
    ("embed_2x50257x768", 2 * 50257, 768),
    ("w_up_2x6x768x3072", 2 * 6 * 768, 3072),
    ("ragged_24x300", 24, 300),
    # train_mixtral's stacked 2-pod expert gradient [2, 1, 8, 6144, 16384]
    # (805,306,368 values a pod)
    ("mixtral_w_up_2x1x8x6144x16384", 2 * 8 * 6144, 16384),
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
# (label, B, T, H, N, r/k/v dtype, w dtype, small w): the backward at the
# rwkv6-7b 4 x 4096 shape and train_rwkv's per-pod 2 x 4096 (both timed),
# then T across the kernel's 16-step sub-chunk and the 256-step chunk (1,
# 17, 256 + 5, 3 x 256) at N 16, 64, 128 in bf16 and float32; w set to
# 1e-30, to a float32 denormal or to exactly 0 on a quarter of the lanes
# ("1e-30", "denormal", "zero"), or to 0 on every lane for steps 16-20 and
# 256-271 ("zero_run": a run of w == 0 that starts a sub-chunk and a chunk),
# at T that straddle the sub-chunk and the chunk (256 + 17, 2 x 256 + 15,
# 4 x 256 + 16)
WKV_BWD_CASES = [
    ("path_4x4096", 4, 4096, 64, 64, "bfloat16", "float32", None),
    ("train_pod_2x4096", 2, 4096, 64, 64, "bfloat16", "float32", None),
    ("t1_n64", 2, 1, 64, 64, "bfloat16", "float32", None),
    ("t17_n16_f32", 2, 17, 16, 16, "float32", "float32", None),
    ("t261_n128", 1, 261, 32, 128, "bfloat16", "float32", None),
    ("t261_n64_f32", 2, 261, 64, 64, "float32", "float32", None),
    ("t768_n16_w_bf16", 2, 768, 16, 16, "bfloat16", "bfloat16", None),
    ("t768_n128_f32", 1, 768, 32, 128, "float32", "float32", None),
    ("w_to_1e-30_t300_n64", 2, 300, 16, 64, "bfloat16", "float32", "1e-30"),
    ("w_zero_t273_n64", 2, 273, 16, 64, "bfloat16", "float32", "zero"),
    ("w_zero_t273_n64_f32", 2, 273, 16, 64, "float32", "float32", "zero"),
    ("w_denormal_t527_n32", 2, 527, 16, 32, "bfloat16", "float32", "denormal"),
    ("w_denormal_t527_n64_f32", 1, 527, 16, 64, "float32", "float32", "denormal"),
    ("w_zero_run_t1040_n8_w_bf16", 2, 1040, 8, 8, "bfloat16", "bfloat16", "zero_run"),
    ("w_zero_run_t1040_n64_f32", 1, 1040, 8, 64, "float32", "float32", "zero_run"),
]
WKV_SMALL_W = {"1e-30": 1e-30, "denormal": 1e-40, "zero": 0.0}
# (label, B, T, Dr, dtype, gates): the recurrentgemma-9b prefill's shape
# (non-zero h0), train_recurrentgemma's per-pod row, its decode step, T one
# past a multiple of the kernel's 64-step chunk and one past one chunk, two
# float32 shapes, and extreme gates: r = 0 everywhere (a = 1, beta at the
# 1e-6 clamp), r = 1 with lam = 10 (a = sigmoid(10)^8) and lam = -10 (a
# near 0)
RGLRU_TRAIN_POD = ("train_pod_1x4096", 1, 4096, 4096, "bfloat16", None)
RGLRU_MESH_TRAIN = ("mesh_train_2x4096x1024", 2, 4096, 1024, "bfloat16", None)
RGLRU_CASES = [
    ("path_prefill", 4, 4096, 4096, "bfloat16", None),
    RGLRU_TRAIN_POD,
    ("path_decode_t1", 4, 1, 4096, "bfloat16", None),
    ("ragged_t4097", 1, 4097, 4096, "bfloat16", None),
    ("t65_one_chunk_plus_1", 4, 65, 4096, "bfloat16", None),
    ("f32_t300_dr64", 2, 300, 64, "float32", None),
    ("f32_t37_dr72", 3, 37, 72, "float32", None),
    ("r_zero_t300", 2, 300, 4096, "bfloat16", "r_zero"),
    ("r_one_lam10_t300", 2, 300, 4096, "bfloat16", "r_one_lam10"),
    ("lam_minus10_t300", 2, 300, 4096, "bfloat16", "lam_minus10"),
    # one rank's channels in mesh_models: 2 rows x Dr / 2 serving on (data
    # 2, model 2), 2 rows x Dr / 4 training on (data 1, model 4)
    ("mesh_serve_2x4096x2048", 2, 4096, 2048, "bfloat16", None),
    RGLRU_MESH_TRAIN,
]
RGLRU_LAST_TOL = 1e-4  # h_last is float32 on both sides
# (label, B, T, Dr, dtype, gates): the RG-LRU backward at train_recurrentgemma's
# per-pod 1 x 4096 x 4096, at 4 x 4096 x 4096 and at a mesh_models
# training rank's 2 x 4096 x 1024 (all three timed), then the forward's
# edge shapes; cotangents on h and h_last
RGLRU_BWD_CASES = ([RGLRU_TRAIN_POD, RGLRU_CASES[0], RGLRU_MESH_TRAIN]
                   + [c for c in RGLRU_CASES[1:] if c not in (RGLRU_TRAIN_POD, RGLRU_MESH_TRAIN)])
RGLRU_BWD_TIMED = 3  # the first cases, their plain version timed too
RGLRU_DLAM_TOL = 1e-3  # dlam: a float32 sum over B x T in another order
WKV_BWD_TIMED = 2  # the first cases, timed
# train_rwkv: rwkv6-7b at full width, depth cut from 32 layers
RWKV_TRAIN_LAYERS, B_RWKV_TRAIN, SEQ_RWKV_TRAIN, RWKV_TRAIN_STEPS = 4, 4, 4096, 6
RWKV_CHECK_LAYERS, RWKV_CHECK_SEQ = 2, 768  # card against CPU: 3 chunks of 256
B_SERVE, PROMPT, GEN = 8, 1024, 32
B_RWKV, PROMPT_RWKV, GEN_RWKV = 4, 4096, 32
RWKV_PARAMS, RWKV_LEAVES = 7_534_682_112, 27  # jax.eval_shape of init_params
B_RG, PROMPT_RG, GEN_RG = 4, 4096, 32
RG_PARAMS, RG_LEAVES = 9_396_195_328, 63  # jax.eval_shape of init_params
# launches a recurrentgemma-9b prefill / decode step: 12 groups x 2 + 2 recurrent, 12 local attention
RG_SCANS, RG_FLASH = 26, 12
RG_CHECK_WINDOW, RG_CHECK_PROMPT = 128, 256  # card against CPU: one group, the window cut so the prompt crosses it
RG_CHECK_F32_RATIO = 1.5  # card's share of SERVE_TOL from the CPU float32 run, over the CPU bf16 run's own
RG_CARRY_GROUPS = (1, 4, 8)  # the state carry also at the first 3, 12 and 24 layers
# train_recurrentgemma: full width, depth cut to one group (recurrent,
# recurrent, local attention); one 4096-token row a pod
RG_TRAIN_LAYERS, B_RG_TRAIN, SEQ_RG_TRAIN, RG_TRAIN_STEPS = 3, 2, 4096, 6
RG_TRAIN_PARAMS, RG_TRAIN_LEAVES = 1_705_062_400, 37  # launch/shapes.py::params_specs of the cut
RG_TRAIN_CHECK_SEQ = 256  # card against CPU: one sequence, four 64-step chunks, past RG_CHECK_WINDOW
NPODS, B_TRAIN, SEQ_TRAIN, STEPS, WARMUP = 2, 16, 1024, 12, 2
# The MoE archs at full width, their depth cut: phase -> (arch, layers,
# parameters, leaves), the counts launch/shapes.py::params_specs of the cut
MOE_CUTS = {
    "serve_mixtral": ("mixtral-8x22b", 12, 30_451_390_464, 13),
    "train_mixtral": ("mixtral-8x22b", 1, 2_906_720_256, 13),
    "serve_arctic": ("arctic-480b", 2, 27_681_131_520, 16),
}
B_MOE, PROMPT_MOE = 4, 4096
GEN_MOE = {"serve_mixtral": 32, "serve_arctic": 8}  # decode steps: mixtral's cross its 4096 window
MOE_CHECK_PROMPT, MOE_CHECK_STEPS = 128, 4  # card against CPU: one layer in float32, prefill and decode steps
# The dry run (src/repro_torch/launch/dryrun.py): each path's predicted peak
# must lie within this band of its measured one; the production cells, each
# in its own process, with the mesh it runs on
DRYRUN_PEAK_BAND = (0.8, 1.25)
DRYRUN_CELLS = [("olmo-1b", "train_4k", "both"), ("recurrentgemma-9b", "long_500k", "single"),
                ("mixtral-8x22b", "prefill_32k", "single"), ("rwkv6-7b", "decode_32k", "multi")]
DRYRUN_TIMEOUT_S = 180  # the whole phase
MEASURED = {}  # path -> the peak bytes and ms its phase measured, for the dry run's phase
# card and CPU may route a token apart only where its router_gap is below
# this: in float32 (serving's check) and in bf16 (train_mixtral's step)
MOE_NEAR_TIE, MOE_NEAR_TIE_BF16 = 1e-4, 2e-3
B_MIXTRAL_TRAIN, SEQ_MIXTRAL_TRAIN, MIXTRAL_TRAIN_STEPS = 2, 4096, 6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


GRAPH_CALLS = 20  # calls captured in one CUDA graph for a device time
# device ms of its own replays a graph runs before it is timed: a reading
# must not depend on what ran before it (a heavier call's clocks)
WARM_MS = 200.0
MS_IS = ("device time: calls captured in one CUDA graph, replayed for WARM_MS of its own device time, then "
         "each replay timed with one event pair, / calls")


def device_ms(fn, calls: int = GRAPH_CALLS, replays: int = 5, stream=None, warm_ms: float = WARM_MS) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph
    (after warm-up calls on a side stream), replayed until ``warm_ms`` of
    its own device time has passed (at least once), then the median replay
    of ``replays``, each timed with one event pair, divided by ``calls``.
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

    def replay_ms():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    warm = replay_ms()
    while warm < warm_ms:
        warm += replay_ms()
    times = [replay_ms() / calls for _ in range(replays)]
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


# the flash backward's launches, as the profiler names their kernels
FLASH_BWD_PARTS = {"D": "delta_kernel", "dK_dV": "flash_bwd_dkdv", "dQ": "flash_bwd_dq"}
PARTS_MS_IS = ("device time of each part's kernel a call: torch.profiler's CUDA kernel events over "
               "PARTS_CALLS calls, by name, in the last phase (a profiler session raises later device "
               "times by 1-2%)")
PARTS_CALLS = 5


def parts_ms(fn, parts, calls: int = PARTS_CALLS):
    """{part: device ms a call} of the kernels ``fn`` launches whose names
    hold each of ``parts``' substrings, from torch.profiler's CUDA events
    over ``calls`` calls (after one warm call); a part with no event is
    "not measured" (the profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for part, key in parts.items():
        us = [e.time_range.elapsed_us() for e in kernels if key in e.name]
        out[part] = sum(us) / 1e3 / calls if us else "not measured"
    return out


def _costs():
    from repro_torch.kernels import costs

    return costs


def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Query-key pairs the mask keeps: the work this input needs."""
    return _costs().attention_pairs(sq, sk, causal, window)


def bound(nbytes, flops, dtype):
    """(least ms the card could take, "bytes" or "operations")."""
    return _costs().bound({dtype: flops}, nbytes)


def flash_flops(b, s, h, hd, window):
    return _costs().flash_fwd(b, s, s, h, h, hd, "bfloat16", window)[0]["bfloat16"]


def flash_bound(b, s, h, kvh, hd, dtype, window):
    return _costs().bound(*_costs().flash_fwd(b, s, s, h, kvh, hd, dtype, window))


def flash_bwd_bound(b, s, h, kvh, hd, dtype, window):
    return _costs().bound(*_costs().flash_bwd(b, s, s, h, kvh, hd, dtype, window))


def wan_bytes(rows, cols):
    """Bytes quantisation (or dequantisation) of a [rows, cols] float32
    matrix moves: the float32 values, the padded int8 and the scales."""
    return _costs().wan_quant(rows, cols)[1]


def wkv_bound(b, t, h, n, rkv_dtype, w_dtype):
    return _costs().bound(*_costs().wkv6_fwd(b, t, h, n, rkv_dtype, w_dtype))


def wkv_bwd_bound(b, t, h, n, rkv_dtype, w_dtype, chunk):
    """-> (bound_ms, bound_by, figures).  The bytes are the floor: the
    operations' time is below them at the timed shapes.  The earlier scalar
    kernel's bound (0.9616 ms at 4 x 4096) stands beside it in ``figures``:
    no floor once the tensor cores take the products."""
    costs = _costs()
    flops, nbytes = costs.wkv6_bwd(b, t, h, n, rkv_dtype, w_dtype, chunk)
    t_bytes, t_ops = nbytes / costs.HBM_BYTES_PER_S, costs.ops_seconds(flops)
    figures = {
        "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3, "floor": "bytes" if t_bytes >= t_ops else "operations",
        "f32_recurrence_ops_ms": costs.wkv6_scalar_recurrence_flops(b, t, h, n) / costs.PEAK_FLOPS["float32"] * 1e3,
        "f32_recurrence_ops_ms_is": "the scalar kernel's bound: 15 N^2 float32 operations a (b, t, h) of the "
                                    "step-by-step recurrence on the CUDA cores; no floor once the tensor cores "
                                    "take the products",
    }
    return max(t_bytes, t_ops) * 1e3, figures["floor"], figures


def rglru_bound(b, t, dr, dtype):
    return _costs().bound(*_costs().rglru_scan(b, t, dr, dtype))


def rglru_bwd_bound(b, t, dr, dtype):
    return _costs().bound(*_costs().rglru_scan_bwd(b, t, dr, dtype))


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


# the hd-256 wgmma flash instances' mangled names hold this (forward), and
# the backward's (dK/dV and dQ, each softcap off and on); the float32
# instances at 256 (forward, dK/dV, dQ)
HD256_ENTRY = "flash_fwd_wgmmaILi256E"
HD256_BWD_ENTRY = "_wgmmaILi256E"
F32_HD256_ENTRY = "f32ILi256E"


def ptxas_entries(lines, pattern):
    """Registers, stack and spill bytes of each entry function (ptxas -v)
    whose mangled name holds ``pattern``."""
    out, cur = [], None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"entry": m.group(1)} if pattern in m.group(1) else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if any(k in ln for k in PTXAS_KEEP)]
        for name, (_, log) in report.items()
    }
    serialised = [ln for lines in ptxas.values() for ln in lines if any(k in ln for k in PTXAS_KEEP[2:5])]
    hd256 = ptxas_entries(ptxas["flash_fwd"], HD256_ENTRY) if "flash_fwd" in ptxas else None
    hd256_bwd = ptxas_entries(ptxas["flash_bwd"], HD256_BWD_ENTRY) if "flash_bwd" in ptxas else None
    f32_hd256 = [e for n in ("flash_fwd", "flash_bwd") if n in ptxas for e in ptxas_entries(ptxas[n], F32_HD256_ENTRY)]
    rglru_bwd = ptxas_entries(ptxas["rglru_scan_bwd"], "") if "rglru_scan_bwd" in ptxas else None
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "compiled": {n: sec for n, (sec, _) in report.items()}, "ptxas": ptxas,
        "wgmma_serialised": serialised, "flash_fwd_wgmma_hd256": hd256, "flash_bwd_wgmma_hd256": hd256_bwd,
        "flash_f32_hd256": f32_hd256, "rglru_scan_bwd": rglru_bwd,
    })
    for name, entries, count in (("forward", hd256, 2), ("backward (dK/dV, dQ)", hd256_bwd, 4)):
        if entries is not None and (len(entries) != count or any(
                e.get("spill_stores", 1) or e.get("spill_loads", 1) or e.get("stack", 1) for e in entries)):
            raise AssertionError(f"build: the hd-256 wgmma flash {name} instances (softcap off, on) spill or are "
                                 f"missing: {entries}")


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
        library_ms = library_call_ms = library_err = library_is = None
        more = {}
        if cap is None:  # the same function as one PyTorch call
            qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
            mask, library_is = None, "scaled_dot_product_attention(is_causal=True)"
            if window is not None:  # key j kept for query i where 0 <= i - j < window
                pos = torch.arange(s, device="cuda")
                back = pos[:, None] - pos[None, :]
                mask = (back >= 0) & (back < window)
            if window is not None and window < s:
                library_is = "scaled_dot_product_attention(attn_mask=banded causal bool [S, S])"
            elif window is not None:  # a window of S or more cuts no pair: is_causal is the same function
                library_is += f" (window {window} >= S cuts no pair: the same function)"
                banded = lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask,  # noqa: E731
                                                                enable_gqa=h != kvh)
                more |= {"library_banded_ms": device_ms(banded),
                        "library_banded_is": "scaled_dot_product_attention(attn_mask=banded causal bool [S, S])"}

            def library():
                if mask is None or window >= s:
                    return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=h != kvh)
                return F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask, enable_gqa=h != kvh)

            lib = library().transpose(1, 2).float()
            library_err = (lib - plain.float()).abs().max().item()
            if not bool(((lib - plain.float()).abs() <= tol + tol * plain.float().abs()).all()):
                raise AssertionError(f"flash_attention_fwd {label}: {library_is} is not the same function: "
                                     f"max_abs_err {library_err}, rtol=atol={tol}")
            del lib
            library_ms, library_call_ms = device_ms(library), time_ms(library)
            if window is not None and window < s:
                library_is += (f": all S x S pairs, {s * s / attention_pairs(s, s, True, window):.2f}x "
                               "the pairs the window keeps")
        if label in SDPA_UNWINDOWED_TOO:  # a second reading: sdpa's causal kernel, no window
            qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
            more |= {
                "library_unwindowed_ms": device_ms(
                    lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=h != kvh)),
                "library_unwindowed_is": (
                    "scaled_dot_product_attention(is_causal=True), no window: a different function on the same "
                    f"inputs, {attention_pairs(s, s, True, None) / attention_pairs(s, s, True, window):.2f}x the "
                    "pairs the window keeps"),
            }
            del qc, kc, vc
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
            "library_is": library_is, "library_max_abs_err": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by, **more,
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
    from repro_torch.kernels.flash_attention.ops import CLUSTER_LAUNCHES, PADDED_LAUNCHES

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
        CLUSTER_LAUNCHES.clear()
        grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        took = {r: n - routes.get(r, 0) for r, n in BWD_ROUTE_LAUNCHES.items() if n != routes.get(r, 0)}
        if took != {route: 1}:
            raise AssertionError(f"flash_attention_bwd {label}: launched on routes {took}, expected {route}")
        kv_cluster = launched_cluster(CLUSTER_LAUNCHES, f"flash_attention_bwd {label}",
                                      bwd_cluster(torch, b, s, h, kvh, hd, dtype))
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
        library_is, more = "scaled_dot_product_attention forward + backward", {}
        if cap is None:  # sdpa's forward plus its backward: one pair
            qc, kc, vc = (t.detach().contiguous().requires_grad_(True) for t in heads[:3])
            doc = heads[4].contiguous()
            mask = None
            if window is not None:  # key j kept for query i where 0 <= i - j < window
                pos = torch.arange(s, device="cuda")
                back = pos[:, None] - pos[None, :]
                mask = (back >= 0) & (back < window)
                if window < s:
                    library_is += (f" with attn_mask=banded causal bool [S, S]: all S x S pairs, "
                                   f"{s * s / attention_pairs(s, s, True, window):.2f}x the pairs the window keeps")
                else:  # a window of S or more cuts no pair: is_causal is the same function
                    library_is += f" with is_causal=True (window {window} >= S cuts no pair: the same function)"

            def sdpa(unwindowed=False):
                if mask is None or unwindowed or window >= s:
                    return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=h != kvh)
                return F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask, enable_gqa=h != kvh)

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
            if mask is not None and window >= s:  # the banded mask beside it, as before
                banded = lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask,  # noqa: E731
                                                                enable_gqa=h != kvh)
                more |= {"library_banded_ms": device_ms(lambda: torch.autograd.grad(banded(), (qc, kc, vc), doc)),
                        "library_banded_is": "scaled_dot_product_attention forward + backward with "
                                             "attn_mask=banded causal bool [S, S]"}
            if label in SDPA_UNWINDOWED_TOO:  # a second reading: sdpa's causal kernels, no window
                more |= {
                    "library_unwindowed_ms": device_ms(lambda: torch.autograd.grad(sdpa(True), (qc, kc, vc), doc)),
                    "library_unwindowed_is": (
                        "scaled_dot_product_attention(is_causal=True) forward + backward, no window: a different "
                        f"function on the same inputs, {attention_pairs(s, s, True, None) / attention_pairs(s, s, True, window):.2f}x"
                        " the pairs the window keeps"),
                }
            del qc, kc, vc, doc, mask
        bound_ms, bound_by = flash_bwd_bound(b, s, h, kvh, hd, dtype, window)

        def kernel():
            return flash_attention_bwd(q, k, v, out, lse, do, **kw)

        more["kv_cluster"] = kv_cluster
        if hd in (128, 256) and route == "wgmma":  # the dK/dV items' heads split over a cluster
            again = kernel()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(grads, again)):
                raise AssertionError(f"flash_attention_bwd {label}: two calls on the same inputs differ")
            more["two_calls_equal"] = True
            del again
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
            "library_is": library_is if cap is None else "none: no PyTorch call takes a softcap",
            "library_bwd_ms": library_bwd_ms,
            "library_bwd_is": "scaled_dot_product_attention backward alone (device time)",
            "bound_ms": bound_ms, "bound_by": bound_by, **more,
        })
        del q, k, v, do, out, lse, heads, grads, plain
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "checks": checks})
    return checks


def bwd_cluster(torch, b, s, h, kvh, hd, dtype):
    """The cluster size the wrapper should give the dK/dV kernel of this
    backward on this card (ops.bwd_cluster)."""
    from repro_torch.kernels.flash_attention.ops import bwd_cluster as size

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return size(getattr(torch, dtype), b, h, kvh, s, hd, sms)


def launched_cluster(counts, what, expected):
    """The dK/dV kernel's cluster size of the one backward launched since
    ``counts`` (ops.CLUSTER_LAUNCHES) was cleared, as the op counted it;
    raises unless that is one launch at ``expected``."""
    if dict(counts) != {expected: 1}:
        raise AssertionError(f"{what}: launches by cluster size {dict(counts)}, expected one at {expected}")
    (size,) = counts
    return size


def phase_flash_bwd_parts(torch):
    """The hd-256 and the hd-128 GQA bf16 flash backward cases' D, dK/dV
    and dQ launches timed apart, and the dK/dV kernel's cluster size; run
    last, since the profiler moves the device times that follow it."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import CLUSTER_LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for label, b, s, h, kvh, hd, dtype, window, cap, route in FLASH_BWD_CASES:
        if route != "wgmma" or not (hd == 256 or (hd == 128 and s >= 4096)):
            continue
        q, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn((b, s, kvh, hd), generator=gen, device="cuda").bfloat16() for _ in range(2))
        kw = dict(causal=True, window=window, logit_softcap=cap)
        out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
        CLUSTER_LAUNCHES.clear()
        flash_attention_bwd(q, k, v, out, lse, do, **kw)
        kv_cluster = launched_cluster(CLUSTER_LAUNCHES, f"flash_bwd_parts {label}",
                                      bwd_cluster(torch, b, s, h, kvh, hd, dtype))
        cases.append({
            "label": label, "kv_cluster": kv_cluster,
            "parts_ms": parts_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw), FLASH_BWD_PARTS),
        })
        del q, k, v, do, out, lse
    emit({"phase": "flash_bwd_parts", "parts_ms_is": PARTS_MS_IS, "cases": cases})
    return cases


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


def phase_kernels_wkv_bwd(torch):
    """wkv6_bwd from the forward kernel's saved states against wkv6_bwd_ref
    (step by step) and wkv6_bwd_chunked_ref (the kernel's algorithm in plain
    float32) from the plain forward's (dr, dk, dv, dw, du, dstate0, with a
    nonzero state0 and dstate), twice for equal bits, finite with w at
    1e-30, at a denormal and at 0, on the route bwd_route names; the saved
    states against the plain ones; wkv6 under grad against autograd through
    wkv6_ref; times at the two path shapes, with the forward's serving and
    training instances beside them."""
    from repro_torch.kernels.rwkv6_wkv import (GRAD_CHUNK, WKV_BWD_ROUTE_LAUNCHES, bwd_route, wkv6, wkv6_bwd,
                                               wkv6_bwd_chunked_ref, wkv6_bwd_ref, wkv6_fwd, wkv6_ref)

    gen = torch.Generator(device="cuda").manual_seed(4)

    def draw(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    names = ("dr", "dk", "dv", "dw", "du", "dstate0")
    checks = []
    for i, (label, b, t, h, n, rkv_dtype, w_dtype, small_w) in enumerate(WKV_BWD_CASES):
        r, k, v = (draw((b, t, h, n), 0.5).to(getattr(torch, rkv_dtype)) for _ in range(3))
        w = torch.sigmoid(draw((b, t, h, n), 1.0, 2.0))
        if small_w == "zero_run":
            w[:, 16:21] = 0.0
            w[:, 256:272] = 0.0
        elif small_w:
            lanes = torch.rand(w.shape, generator=gen, device="cuda") < 0.25
            w = torch.where(lanes, torch.full_like(w, WKV_SMALL_W[small_w]), w)
        w = w.to(getattr(torch, w_dtype))
        u, s0 = draw((h, n), 0.1), draw((b, h, n, n), 0.1)
        dout, dstate = draw((b, t, h, n)), draw((b, h, n, n), 0.5)
        bounds = torch.empty((b, -(-t // GRAD_CHUNK), h, n, n), device="cuda")
        final = torch.empty_like(s0)
        wkv6_fwd(r, k, v, w, u, s0, final, bounds=bounds, chunk=GRAD_CHUNK)
        _, plain_final, plain_bounds = wkv6_ref(r, k, v, w, u, s0, chunk=GRAD_CHUNK)
        routes, route = dict(WKV_BWD_ROUTE_LAUNCHES), bwd_route(r.dtype, n)
        got = wkv6_bwd(r, k, v, w, u, bounds, dout, dstate, GRAD_CHUNK)
        again = wkv6_bwd(r, k, v, w, u, bounds, dout, dstate, GRAD_CHUNK)
        took = {x: c - routes.get(x, 0) for x, c in WKV_BWD_ROUTE_LAUNCHES.items() if c != routes.get(x, 0)}
        if took != {route: 2}:
            raise AssertionError(f"wkv6_bwd {label}: launched on routes {took}, expected {route}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = wkv6_bwd_ref(r, k, v, w, u, plain_bounds, dout, dstate, GRAD_CHUNK)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        want_chunked = wkv6_bwd_chunked_ref(r, k, v, w, u, plain_bounds, dout, dstate, GRAD_CHUNK)
        tol, errs, errs_chunked = WKV_TOL[rkv_dtype], {}, {}
        pairs = ([(nm, g, p, errs) for nm, g, p in zip(names, got, want)]
                 + [(nm, g, p, errs_chunked) for nm, g, p in zip(names, got, want_chunked)]
                 + [("bounds", bounds, plain_bounds, errs), ("final", final, plain_final, errs)])
        for name, g, p, into in pairs:
            diff = (g.float() - p.float()).abs()
            into[name] = diff.max().item()
            if g.dtype != p.dtype or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"wkv6_bwd {label} {name}: dtype {g.dtype} vs {p.dtype}, or not finite")
            if not bool((diff <= tol + tol * p.float().abs()).all()):
                ref = "wkv6_bwd_chunked_ref" if into is errs_chunked else "wkv6_bwd_ref"
                raise AssertionError(f"wkv6_bwd {label} {name} vs {ref}: max_abs_err {into[name]}, rtol=atol={tol}")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"wkv6_bwd {label}: two calls on the same inputs differ")
        row = {
            "label": label, "shape": {"B": b, "T": t, "H": h, "N": n, "chunk": GRAD_CHUNK}, "rkv_dtype": rkv_dtype,
            "w_dtype": w_dtype, "small_w": small_w, "route": route, "two_calls_equal": True,
            "max_abs_err": max(errs[nm] for nm in names), "max_abs_err_by_output": errs,
            "max_abs_err_vs_chunked_ref": errs_chunked, "tol": tol,
        }
        if i < WKV_BWD_TIMED:
            def kernel():
                return wkv6_bwd(r, k, v, w, u, bounds, dout, dstate, GRAD_CHUNK)

            bound_ms, bound_by, bound_figures = wkv_bwd_bound(b, t, h, n, rkv_dtype, w_dtype, GRAD_CHUNK)
            row.update({
                "ms": device_ms(kernel, calls=3, replays=3), "call_ms": time_ms(kernel, runs=5, warmup=1),
                "plain_ms": plain_ms,
                "plain_ms_is": "one call of wkv6_bwd_ref at this shape (the check's), host clock around it",
                "bound_ms": bound_ms, "bound_by": bound_by, "bound_figures": bound_figures, "library_ms": None,
                "fwd_serving_instance_ms": device_ms(lambda: wkv6_fwd(r, k, v, w, u, s0, final)),
                "fwd_training_instance_ms": device_ms(
                    lambda: wkv6_fwd(r, k, v, w, u, s0, final, bounds=bounds, chunk=GRAD_CHUNK)),
            })
        checks.append(row)
        del r, k, v, w, u, s0, dout, dstate, bounds, final, got, again, want, want_chunked, plain_bounds, plain_final
    torch.cuda.empty_cache()

    # wkv6 under grad (both kernels) against autograd through the plain loop
    b, t, h, n = 2, 300, 4, 64
    xs = [draw((b, t, h, n), 0.5), draw((b, t, h, n), 0.5), draw((b, t, h, n), 0.5),
          torch.sigmoid(draw((b, t, h, n), 1.0, 2.0)), draw((h, n), 0.1), draw((b, h, n, n), 0.1)]
    xs = [x.requires_grad_(True) for x in xs]
    dout, dstate = draw((b, t, h, n)), draw((b, h, n, n), 0.5)
    out, fin = wkv6(*xs)
    got = torch.autograd.grad((out * dout).sum() + (fin * dstate).sum(), xs)
    pout, pfin = wkv6_ref(*xs)
    want = torch.autograd.grad((pout * dout).sum() + (pfin * dstate).sum(), xs)
    auto = {name: (g - p).abs().max().item() for name, g, p in zip(("r", "k", "v", "w", "u", "state0"), got, want)}
    tol = WKV_TOL["float32"]
    if not all(bool(((g - p).abs() <= tol + tol * p.abs()).all()) for g, p in zip(got, want)):
        raise AssertionError(f"wkv6 under grad vs autograd through wkv6_ref: {auto}, rtol=atol={tol}")
    emit({"phase": "kernels", "kernel": "wkv6_bwd", "routes": {c["label"]: c["route"] for c in checks}, "checks": checks,
          "vs_autograd_through_wkv6_ref": {"shape": [b, t, h, n], "dtype": "float32", "max_abs_err": auto,
                                           "tol": tol}})
    return checks


def rglru_inputs(torch, gen, b, t, dr, dtype, gates):
    """x, r, i [B, T, Dr] in ``dtype``, lam [Dr] and h0 [B, Dr] float32 on
    the card: the gates in (0, 1), lam the JAX init's logits jittered, or
    the extreme gates RGLRU_CASES name."""
    def draw(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dt = getattr(torch, dtype)
    x = draw((b, t, dr)).to(dt)
    r = torch.sigmoid(draw((b, t, dr))).to(dt)
    i = torch.sigmoid(draw((b, t, dr))).to(dt)
    # the JAX init's logits of a^(1/8) over (0.9, 0.999), jittered
    lam = torch.logit(torch.linspace(0.9, 0.999, dr, device="cuda") ** (1 / 8)) + 0.1 * draw((dr,))
    if gates == "r_zero":
        r = torch.zeros_like(r)
    elif gates == "r_one_lam10":
        r, lam = torch.ones_like(r), torch.full_like(lam, 10.0)
    elif gates == "lam_minus10":
        lam = torch.full_like(lam, -10.0)
    return x, r, i, lam, draw((b, dr))


def phase_kernels_rglru(torch):
    """rglru_scan against its plain version at the recurrentgemma-9b prefill
    and decode shapes and the variants; two calls must give equal bits."""
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    checks = []
    for label, b, t, dr, dtype, gates in RGLRU_CASES:
        x, r, i, lam, h0 = rglru_inputs(torch, gen, b, t, dr, dtype, gates)
        plain_h, plain_last = rglru_scan_ref(x, r, i, lam, h0)
        h, last = rglru_scan(x, r, i, lam, h0)
        again, again_last = rglru_scan(x, r, i, lam, h0)
        torch.cuda.synchronize()
        if not (torch.equal(h, again) and torch.equal(last, again_last)):
            raise AssertionError(f"rglru_scan {label}: two calls on the same inputs differ")
        errs = {}
        for name, got, want, tol in (("h", h.float(), plain_h.float(), TOL[dtype]),
                                     ("h_last", last, plain_last, RGLRU_LAST_TOL)):
            diff = (got - want).abs()
            errs[name] = diff.max().item()
            if not (torch.isfinite(got).all() and bool((diff <= tol + tol * want.abs()).all())):
                raise AssertionError(f"rglru_scan {label} {name}: max_abs_err {errs[name]}, rtol=atol={tol}")
        bound_ms, bound_by = rglru_bound(b, t, dr, dtype)
        slow = t >= 1000  # the plain loop launches a few kernels a step

        def kernel():
            return rglru_scan(x, r, i, lam, h0)

        checks.append({
            "label": label, "shape": {"B": b, "T": t, "Dr": dr}, "dtype": dtype, "gates": gates,
            "two_calls_equal": True,
            "max_abs_err": max(errs.values()), "max_abs_err_h_h_last": errs,
            "tol": TOL[dtype], "tol_h_last": RGLRU_LAST_TOL,
            "ms": device_ms(kernel), "call_ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: rglru_scan_ref(x, r, i, lam, h0), runs=3 if slow else 25,
                                warmup=1 if slow else 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_why": "no single PyTorch call computes the RG-LRU recurrence",
        })
        del x, r, i, lam, h0, h, last, again, again_last, plain_h, plain_last
    emit({"phase": "kernels", "kernel": "rglru_scan", "checks": checks})
    return checks


def phase_kernels_rglru_bwd(torch):
    """rglru_scan_bwd against rglru_scan_bwd_chunked_ref (its algorithm in
    plain torch) on the same inputs and the forward kernel's chunk states,
    at train_recurrentgemma's per-pod shape, 4 x 4096 x 4096 and the
    forward's edge shapes, with cotangents on h and h_last; two calls must
    give equal bits."""
    from repro_torch.kernels.rglru_scan import (rglru_scan_bwd, rglru_scan_bwd_chunked_ref, rglru_scan_bwd_ref,
                                                rglru_scan_fwd)

    gen = torch.Generator(device="cuda").manual_seed(6)
    checks = []
    for n, (label, b, t, dr, dtype, gates) in enumerate(RGLRU_BWD_CASES):
        x, r, i, lam, h0 = rglru_inputs(torch, gen, b, t, dr, dtype, gates)
        dy = torch.randn((b, t, dr), generator=gen, device="cuda").to(x.dtype)
        dh_last = torch.randn((b, dr), generator=gen, device="cuda")
        _, _, states = rglru_scan_fwd(x, r, i, lam, h0)

        def kernel():
            return rglru_scan_bwd(x, r, i, lam, h0, dy, dh_last, states=states)

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            raise AssertionError(f"rglru_scan_bwd {label}: two calls on the same inputs differ")
        want = rglru_scan_bwd_chunked_ref(x, r, i, lam, h0, dy, dh_last)
        errs, tols = {}, dict(dx=TOL[dtype], dr=TOL[dtype], di=TOL[dtype], dlam=RGLRU_DLAM_TOL, dh0=RGLRU_LAST_TOL)
        for name, a, w in zip(tols, got, want):
            diff = (a.float() - w.float()).abs()
            errs[name] = diff.max().item()
            if not (a.dtype == w.dtype and torch.isfinite(a).all()
                    and bool((diff <= tols[name] + tols[name] * w.float().abs()).all())):
                raise AssertionError(f"rglru_scan_bwd {label} {name}: max_abs_err {errs[name]}, "
                                     f"rtol=atol={tols[name]}, dtypes {a.dtype} / {w.dtype}")
        del got, again, want
        bound_ms, bound_by = rglru_bwd_bound(b, t, dr, dtype)
        timed = n < RGLRU_BWD_TIMED
        checks.append({
            "label": label, "shape": {"B": b, "T": t, "Dr": dr}, "dtype": dtype, "gates": gates,
            "cotangents": "h and h_last", "two_calls_equal": True,
            "max_abs_err": errs["dx"] if dtype == "bfloat16" else max(errs.values()), "max_abs_err_by_output": errs,
            "tol": TOL[dtype], "tol_by_output": tols,
            "vs": "rglru_scan_bwd_chunked_ref (the kernel's algorithm in plain torch), same inputs and chunk states",
            "ms": device_ms(kernel), "call_ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: rglru_scan_bwd_ref(x, r, i, lam, h0, dy, dh_last), runs=1, warmup=0)
            if timed else None,
            "plain_ms_is": "rglru_scan_bwd_ref: the reverse recurrence step by step, one call" if timed
            else "not timed at this shape",
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_why": "no single PyTorch call computes the RG-LRU recurrence's gradient",
        })
        del x, r, i, lam, h0, dy, dh_last, states
    emit({"phase": "kernels", "kernel": "rglru_scan_bwd", "checks": checks})
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


def phase_serve_recurrentgemma(torch):
    """recurrentgemma-9b at full width and depth: the serving path through
    the RG-LRU scan kernel and the flash forward at head_dim 256."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("recurrentgemma-9b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params, n_leaves = sum(t.numel() for t in leaves), len(leaves)
    del leaves
    if (n_params, n_leaves) != (RG_PARAMS, RG_LEAVES):
        raise AssertionError(f"serve_recurrentgemma: {n_params} parameters in {n_leaves} leaves, "
                             f"expected {RG_PARAMS} in {RG_LEAVES}")
    # one token more than the prompt: the state-carry check decodes it
    tokens = synthetic_prompt_batch(cfg, gen, B_RG, PROMPT_RG + 1)["tokens"]
    batch = {"tokens": tokens[:, :PROMPT_RG]}
    max_len = PROMPT_RG + GEN_RG

    def run():
        return serve_run(torch, params, batch, cfg, prompt=PROMPT_RG, gen=GEN_RG, max_len=max_len)

    run()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    res = run()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not res["ok"]:
        raise AssertionError("serve_recurrentgemma: logits not finite or of the wrong shape")
    counts = [res["after_prefill"]] + res["after_steps"]
    got = [(c.get("rglru_scan", 0), c.get("flash_attention_fwd", 0)) for c in counts]
    expected = [(RG_SCANS * (1 + i), RG_FLASH) for i in range(GEN_RG + 1)]
    if got != expected or set(launches) != {"rglru_scan", "flash_attention_fwd"} or routes != {"wgmma": RG_FLASH}:
        raise AssertionError(f"serve_recurrentgemma: (rglru_scan, flash) launches {got} after prefill and each "
                             f"decode step, expected {expected}; all launches {launches}, flash routes {routes}")
    prefill_ms_median = time_ms(lambda: prefill(params, batch, cfg, max_len=max_len), runs=3, warmup=0)
    MEASURED["serve_recurrentgemma"] = {"peak_bytes": peak, "ms": prefill_ms_median, "ms_is": "median prefill ms",
                                        "cfg": cfg, "batch": B_RG, "seq_len": PROMPT_RG, "max_len": max_len}

    # The state carried through decode (the LRU state, the conv tail and the
    # rolling window cache): prefill of T then one decode step against a
    # prefill of T + 1, at full depth and at the first groups' depths (the
    # same weights), to show how the bf16 difference grows with depth.
    carry_by_layers = {}
    for groups in RG_CARRY_GROUPS + (None,):
        depth = cfg if groups is None else dataclasses.replace(cfg, num_layers=groups * len(cfg.pattern))
        depth_params = params if groups is None else {
            **{k: v for k, v in params.items() if k not in ("groups", "remainder")},
            "groups": tree_map(lambda t, n=groups: t[:n], params["groups"]),
        }
        carry_by_layers[depth.num_layers] = state_carry(depth_params, tokens, depth)
    carry_err = carry_by_layers[cfg.num_layers]
    if not all(e <= SERVE_TOL for e in carry_by_layers.values()):
        raise AssertionError(f"serve_recurrentgemma: state carry relative norm error by layers {carry_by_layers} "
                             f"above {SERVE_TOL}")
    del params, depth_params
    gc.collect()
    torch.cuda.empty_cache()

    # The card against the CPU (plain path): one group (recurrent,
    # recurrent, local) at full width, the window cut to 128 so that the
    # [1, 256] prompt crosses it on both sides.  bf16 at this width is
    # coarser than SERVE_TOL's elementwise bar even between the CPU's own
    # bf16 and float32 runs, so the card is held to the CPU bf16 run in
    # relative norm, and elementwise to the CPU float32 run at no more than
    # RG_CHECK_F32_RATIO x the CPU bf16 run's own share of the bar.
    cut = dataclasses.replace(cfg, num_layers=3, local_window=RG_CHECK_WINDOW)
    params = init_params(cut, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    cut_params = sum(t.numel() for t in tree_leaves(params))
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cut32 = dataclasses.replace(cut, dtype="float32")
    small = synthetic_prompt_batch(cut, gen, 1, RG_CHECK_PROMPT)
    cpu_small = tree_map(lambda t: t.cpu(), small)
    n = RG_CHECK_PROMPT + 4
    g_logits, g_cache = prefill(params, small, cut, max_len=n)
    t0 = time.perf_counter()
    c_logits, c_cache = prefill(cpu_params, cpu_small, cut, max_len=n)
    f_logits, f_cache = prefill(cpu_params, cpu_small, cut32, max_len=n)
    rows = []

    def compare():
        card, c16, c32 = g_logits.float().cpu(), c_logits.float(), f_logits.float()
        rows.append({
            "vs_cpu_bf16": _logit_diff(card, c16),
            "vs_cpu_bf16_rel_norm": ((card - c16).norm() / c16.norm()).item(),
            "vs_cpu_f32": _logit_diff(card, c32), "cpu_bf16_vs_cpu_f32": _logit_diff(c16, c32),
        })

    compare()
    carried = {}
    for i in range(4):
        nxt = g_logits.argmax(-1)
        g_logits, g_cache = decode_step(params, nxt, g_cache, cut, RG_CHECK_PROMPT + i)
        c_logits, c_cache = decode_step(cpu_params, nxt.cpu(), c_cache, cut, RG_CHECK_PROMPT + i)
        f_logits, f_cache = decode_step(cpu_params, nxt.cpu(), f_cache, cut32, RG_CHECK_PROMPT + i)
        compare()
        if i == 0:  # the cut's state carry: the first decode step against a prefill one token longer
            longer = torch.cat([small["tokens"], nxt[:, None]], 1)
            carried = {"card_bf16": (g_logits, params, longer, cut),
                       "cpu_bf16": (c_logits, cpu_params, longer.cpu(), cut),
                       "cpu_f32": (f_logits, cpu_params, longer.cpu(), cut32)}
    cut_carry = {}
    for key, (logits, ps, longer, c) in carried.items():
        whole = prefill(ps, {"tokens": longer}, c, max_len=n)[0]
        cut_carry[key] = ((logits.float() - whole.float()).norm() / whole.float().norm()).item()
    del carried
    cpu_s = time.perf_counter() - t0
    if not (cut_carry["card_bf16"] <= SERVE_TOL and cut_carry["cpu_f32"] <= TOL["float32"]):
        raise AssertionError(f"serve_recurrentgemma: the 3-layer cut's state carry {cut_carry}: card bf16 above "
                             f"{SERVE_TOL} or CPU float32 above {TOL['float32']}")
    bad = [i for i, row in enumerate(rows)
           if not (row["vs_cpu_bf16_rel_norm"] <= SERVE_TOL
                   and row["vs_cpu_f32"][1] <= RG_CHECK_F32_RATIO * row["cpu_bf16_vs_cpu_f32"][1])]
    if bad:
        raise AssertionError(f"serve_recurrentgemma: card vs CPU outside its bars at rows {bad} "
                             f"(prefill, then decode steps): {rows}")
    del params, cpu_params, g_cache, c_cache, f_cache

    step_ms = res["step_ms"]
    emit({
        "phase": "serve_recurrentgemma", "arch": cfg.name, "dtype": cfg.dtype, "params": n_params,
        "leaves": n_leaves, "layers": cfg.num_layers, "head_dim": cfg.head_dim, "local_window": cfg.local_window,
        "batch": B_RG, "prompt": PROMPT_RG, "gen": GEN_RG, "init_s": init_s,
        "prefill_ms": res["t_prefill"] * 1e3,
        "prefill_ms_median_of_3_more": prefill_ms_median,
        "prefill_tokens_per_s": B_RG * PROMPT_RG / res["t_prefill"],
        "decode_ms_per_step_mean": statistics.fmean(step_ms),
        "decode_ms_per_step_median": statistics.median(step_ms),
        "decode_tokens_per_s": B_RG * GEN_RG / res["t_decode"],
        "decode_s": res["t_decode"],
        "peak_memory_bytes": peak,
        "launches_main_path": launches, "fwd_routes_main_path": routes,
        "rglru_scan_per_prefill": RG_SCANS, "rglru_scan_per_decode_step": RG_SCANS,
        "flash_per_prefill": RG_FLASH, "flash_per_decode_step": 0,
        "state_carry_rel_err": carry_err, "state_carry_tol": SERVE_TOL,
        "state_carry_rel_err_by_layers": carry_by_layers,
        "card_vs_cpu": {"layers": cut.num_layers, "local_window": cut.local_window, "params": cut_params,
                        "prompt": [1, RG_CHECK_PROMPT], "decode_steps": 4, "tol": SERVE_TOL,
                        "f32_ratio_bar": RG_CHECK_F32_RATIO, "rows": rows,
                        "state_carry_rel_err": cut_carry, "state_carry_f32_tol": TOL["float32"], "cpu_s": cpu_s},
        "reduced": "none on the main path; the card-vs-CPU check cuts depth to 3 layers and local_window to "
                   f"{RG_CHECK_WINDOW}",
        "last_tokens": res["tokens"].tolist(),
    })
    return launches


def state_carry(params, tokens, cfg):
    """Relative norm of (a prefill of all tokens but the last, then one
    decode step of it) against (a prefill of all tokens): last logits."""
    from repro_torch.models import decode_step, prefill

    n = tokens.shape[1] - 1
    _, cache = prefill(params, {"tokens": tokens[:, :n]}, cfg, max_len=n + 1)
    carried, _ = decode_step(params, tokens[:, n], cache, cfg, n)
    del cache
    whole, _ = prefill(params, {"tokens": tokens}, cfg, max_len=n + 1)
    return ((carried.float() - whole.float()).norm() / whole.float().norm()).item()


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
    read just after; ``scenario`` (a spec of 2 DCs) goes to the trainer,
    whose pod count it then also gives.  Returns (trainer, result,
    launches, fwd routes, bwd routes, peak bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import BWD_ROUTE_LAUNCHES, ROUTE_LAUNCHES
    from repro_torch.runtime import GeoTrainer

    cfg = get_config("distilgpt2-82m")
    trainer = GeoTrainer(cfg, device="cuda", checkpoint_dir=str(directory), scenario=scenario,
                         trainer_cfg=train_config(strategy, steps, npods=NPODS, **tc_more))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    BWD_ROUTE_LAUNCHES.clear()
    result = trainer.run(inject_failure_at=inject_failure_at)
    launches, routes, bwd_routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES), dict(BWD_ROUTE_LAUNCHES)
    return trainer, result, launches, routes, bwd_routes, torch.cuda.max_memory_allocated()


def train_config(strategy, steps, **more):
    """The train phases' TrainerConfig: global 16 x 1024, AdamW warm-up 2 of STEPS."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainerConfig

    opt = AdamWConfig(lr=1e-3, warmup_steps=WARMUP, total_steps=STEPS)
    return TrainerConfig(seq_len=SEQ_TRAIN, global_batch=B_TRAIN, steps=steps, strategy=strategy,
                         log_every=steps, seed=0, opt=opt, **more)


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


def card_vs_cpu_step(torch, cfg, strategy, *, donate=False, opt=None):
    """One whole step at full width, global batch 2 x 128 (for local_sgd an
    outer step, sync_every 1), built with ``donate`` and ``opt`` (the train
    phases' AdamW by default), from the same weights on the card and on
    the CPU: its loss, aux and grad_norm at TRAIN_TOL
    and its WAN bytes exactly; its first moments, each leaf by its relative
    norm at TRAIN_TOL (after one step they are the synced gradients,
    clipped, times 1 - b1: the pod mean under hier_int8 and ps, each pod's
    own under local_sgd); and the parameters it writes back, each leaf on
    its resolved lanes (RESOLVED_M) within UPDATE_TOL of the CPU's update
    there.  The card's parameters and
    moments, and the start, stay on the card while the CPU steps, and are
    held to the CPU's a leaf at a time.  An MoE config's CPU run routes by
    the card's expert choices (``recorded_routing``), its own differing
    only at near-ties (MOE_NEAR_TIE_BF16): one token routed elsewhere moves
    its experts' gradients by more than TRAIN_TOL."""
    from repro_torch.data import loader_for_model
    from repro_torch.distributed import init_pod_params, init_train_state, make_train_step
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import init_params
    from repro_torch.optim import DilocoConfig
    from repro_torch.tree import tree_items, tree_map

    opt = opt or train_config(strategy, STEPS).opt  # lr 5e-4 at step 1: far above a weight's rounding
    params = init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    start = tree_map(lambda t: t.cpu(), params)
    batch = loader_for_model(cfg, seq_len=128, global_batch=NPODS, seed=1).next_batch()
    sides, routes, launches, seconds, kept = {}, {}, {}, {}, {}
    for name in ("card", "cpu"):
        dev = "cuda" if name == "card" else "cpu"
        p = params if name == "card" else start
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        step = make_train_step(cfg, npods=NPODS, strategy=strategy, opt_cfg=opt,
                               diloco_cfg=DilocoConfig(sync_every=1), device=dev, donate=donate)
        state = init_train_state(p, opt, strategy=strategy, npods=NPODS)
        take = None if name == "card" else [idx for idx, _ in routes["card"]]
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with recorded_routing(take=take) as calls:
            new, state, m = step(init_pod_params(p, strategy=strategy, npods=NPODS), state, b)
        sides[name] = (m["loss"].item(), m["grad_norm"].item(), m["aux"].item(), m["wan_bytes"])
        seconds[name] = time.perf_counter() - t0
        launches[name], routes[name] = dict(LAUNCHES), calls
        if strategy == "local_sgd":
            if not all(bool(torch.equal(t[0], t[1])) for _, t in tree_items(new)):
                raise AssertionError(f"{name}: the pods differ after the outer step")
            new = tree_map(lambda t: t[0], new)
        kept[name] = (new, state.adam.m)
        del p, new, state, step
        gc.collect()
        torch.cuda.empty_cache()
        if name == "card":  # the CPU steps on ``start`` itself
            old = tree_map(lambda t: t.cuda(), start)
    del params, start

    def errors(x, y, o, mx, my):
        """(first-moment error, parameter error over the update on the
        resolved lanes, share of lanes not resolved) of one leaf, on the
        card: x, o, mx the card's, y, my the CPU's."""
        y, my = y.cuda(), my.cuda()
        same = (mx.sign() == my.sign()) & (my.abs() >= RESOLVED_M * opt.eps * (1 - opt.b1))
        m_err = ((mx - my).norm() / my.norm().clamp_min(1e-30)).item()
        if same.dim() > y.dim():  # local_sgd: each pod's own moments
            same = same.all(0)
        apart = (x.float() - y).masked_fill_(~same, 0).norm()
        update = (y - o.float()).masked_fill_(~same, 0).norm()
        return m_err, (apart / update.clamp_min(1e-30)).item(), 1 - same.float().mean().item()

    (g_new, g_m), (c_new, c_m) = kept["card"], kept["cpu"]
    err = {path: errors(x, y, o, mx, my) for (path, x), (_, y), (_, o), (_, mx), (_, my)
           in zip(tree_items(g_new), tree_items(c_new), tree_items(old), tree_items(g_m), tree_items(c_m))}
    del kept, g_new, g_m, c_new, c_m, old
    gc.collect()
    torch.cuda.empty_cache()
    m_err, update_err = {k: e[0] for k, e in err.items()}, {k: e[1] for k, e in err.items()}
    g, c = sides["card"], sides["cpu"]
    pairs = {"loss": (g[0], c[0]), "grad_norm": (g[1], c[1]), "aux": (g[2], c[2])}
    flash = ("flash_attention_fwd", "flash_attention_bwd") + (("wan_quant", "wan_dequant")
                                                             if strategy == "hier_int8" else ())
    if launches["cpu"] or not all(launches["card"].get(k, 0) > 0 for k in flash):
        raise AssertionError(f"{strategy}: card vs CPU launches {launches}, expected {flash} on the card only")
    if (any(abs(a - b) > TRAIN_TOL * abs(b) for a, b in pairs.values()) or g[3] != c[3]
            or max(m_err.values()) > TRAIN_TOL or max(update_err.values()) > UPDATE_TOL):
        raise AssertionError(f"{strategy}: card vs CPU {pairs}, WAN bytes {g[3]} / {c[3]}, first-moment "
                             f"relative errors {m_err} (tolerance {TRAIN_TOL}), parameter errors over the "
                             f"update on resolved lanes {update_err} (tolerance {UPDATE_TOL})")
    out = {"batch": [NPODS, 128], "dtype": cfg.dtype, "param_dtype": cfg.param_dtype, "donate": donate,
           "lr": opt.lr, "warmup_steps": opt.warmup_steps, **{k: list(v) for k, v in pairs.items()},
           "wan_bytes": g[3], "m_rel_err_max": max(m_err.values()), "m_rel_err_worst": max(m_err, key=m_err.get),
           "update_rel_err_max": max(update_err.values()),
           "update_rel_err_worst": max(update_err, key=update_err.get),
           "lanes_unresolved_max": max(e[2] for e in err.values()), "tol": TRAIN_TOL, "update_tol": UPDATE_TOL,
           "card_launches": launches["card"], "card_s": seconds["card"], "cpu_s": seconds["cpu"]}
    if cfg.moe is not None:
        agree = routing_agreement(routes["card"], routes["cpu"], MOE_NEAR_TIE_BF16)
        out.update(router_calls=len(agree), tokens_routed=sum(int(a.numel()) for a in agree),
                   tokens_routed_alike=sum(int(a.sum()) for a in agree), near_tie_bar=MOE_NEAR_TIE_BF16)
    return out


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
    MEASURED["train"] = {"peak_bytes": peak, "ms": step_ms, "ms_is": "median step ms", "opt": opt}
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
    return launches, losses


# train_group: each strategy's steps on 2 ranks; hier_int8 runs the train
# phase's 12, ps 3 and local_sgd 8 (H = 8: step 7 is its outer step), each
# held to its one-process phase's first losses; allreduce and hier 3, held
# to a one-process run of 3 steps made in this phase
GROUP_STEPS = {"hier_int8": STEPS, "allreduce": 3, "hier": 3, "ps": 3, "local_sgd": 8}
GROUP_TIMEOUT_S = 420  # the whole spawn; a collective waits at most 60 s


def train_group_rank(rank, plan):
    """One pod's rank of train_group: GeoTrainer on the 2-rank pod mesh,
    each strategy with the counts zeroed just before its run and read just
    after.  Returns per strategy the rows, the launches and routes, the
    collectives' counts of the last step, the parameters' devices and the
    peak memory."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import BWD_ROUTE_LAUNCHES, ROUTE_LAUNCHES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import GeoTrainer
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("distilgpt2-82m")
    mesh = make_host_mesh(pods=NPODS, device="cuda")
    out = {"device": torch.cuda.get_device_name(torch.cuda.current_device()), "strategies": {}}
    for strategy, steps in plan:
        directory = ROOT / "build" / "chip_smoke_checkpoints" / f"train_group_{strategy}"
        trainer = GeoTrainer(cfg, mesh, device="cuda", checkpoint_dir=str(directory),
                             trainer_cfg=train_config(strategy, steps))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        ROUTE_LAUNCHES.clear()
        BWD_ROUTE_LAUNCHES.clear()
        result = trainer.run()
        group = trainer.step_fn.group
        out["strategies"][strategy] = {
            "rows": result["metrics"], "launches": dict(LAUNCHES), "routes": dict(ROUTE_LAUNCHES),
            "bwd_routes": dict(BWD_ROUTE_LAUNCHES), "last_step_handed": dict(group.handed),
            "last_step_calls": dict(group.calls), "last_step_seconds": dict(group.seconds),
            "devices": sorted({t.device.type for t in tree_leaves((trainer.params, trainer.state))}),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "last_checkpoint": result["last_checkpoint"],
            "sync_efficiency": result["sync_efficiency"],
        }
        del trainer
        torch.cuda.empty_cache()
        if rank == 0:
            shutil.rmtree(directory, ignore_errors=True)
    return out


def int8_payload_bytes(shapes) -> int:
    """One pod's hier_int8 payload: each leaf's rows of int8 lanes padded to
    256 and a float32 scale a 256-lane block (a 0-d leaf is one lane)."""
    total = 0
    for shp in shapes:
        cols = shp[-1] if shp else 1
        rows, blocks = math.prod(shp) // cols, -(-cols // 256)
        total += rows * blocks * (256 + 4)
    return total


def phase_train_group(torch, one_process_losses, train_step_ms):
    """The training path with the pod axis as a process group: 2 ranks
    share the card over gloo, each running GeoTrainer at full width on its
    8 x 1024 rows of the 16 x 1024 global batch; the WAN strategies run as
    collectives between them.  Every rank's losses must equal the
    one-process losses bit for bit, every flash launch take wgmma, every
    leaf's parameters live on the card, and the counted WAN bytes equal
    the strategy's analytic bytes on every step."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.distributed import spawn
    from repro_torch.models import init_params
    from repro_torch.optim import DilocoConfig
    from repro_torch.tree import tree_leaves

    cfg = get_config("distilgpt2-82m")
    sync_every = DilocoConfig().sync_every
    shapes = [tuple(t.shape) for t in tree_leaves(init_params(cfg, device="meta"))]
    values = sum(math.prod(shp) for shp in shapes)
    analytic = {
        "allreduce": 2 * (NPODS - 1) * 4 * values // NPODS, "hier": 2 * (NPODS - 1) * 4 * values // NPODS,
        "hier_int8": (NPODS - 1) * int8_payload_bytes(shapes), "ps": 2 * 4 * values,
        "local_sgd": 2 * (NPODS - 1) * 4 * values // NPODS,
    }
    want_losses = dict(one_process_losses)
    for strategy in ("allreduce", "hier"):  # one-process references of the same steps, made here
        directory = ckpt_dir(f"train_group_{strategy}_one_process")
        trainer, result, *_ = train_main_path(torch, strategy, directory, steps=GROUP_STEPS[strategy])
        want_losses[strategy] = [r["loss"] for r in result["metrics"]]
        del trainer
        shutil.rmtree(directory)
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(train_group_rank, NPODS, list(GROUP_STEPS.items()), device="cuda", join_timeout_s=GROUP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    summary = {}
    for strategy, steps in GROUP_STEPS.items():
        per_rank = []
        for r, rank in enumerate(ranks):
            got = rank["strategies"][strategy]
            rows = got["rows"]
            label = f"train_group {strategy} rank {r}"
            losses = [row["loss"] for row in rows]
            if losses != want_losses[strategy][:steps]:
                raise AssertionError(f"{label}: losses {losses} vs one-process {want_losses[strategy][:steps]}")
            if got["devices"] != ["cuda"]:
                raise AssertionError(f"{label}: parameters and state on {got['devices']}")
            per_step = {"flash_attention_fwd": cfg.num_layers, "flash_attention_bwd": cfg.num_layers}
            if strategy == "hier_int8":
                per_step.update(wan_quant=len(shapes), wan_dequant=len(shapes))
            expected = {k: steps * n for k, n in per_step.items()}
            if got["launches"] != expected or got["routes"] != {"wgmma": expected["flash_attention_fwd"]} \
                    or got["bwd_routes"] != {"wgmma": expected["flash_attention_bwd"]}:
                raise AssertionError(f"{label}: launches {got['launches']}, routes {got['routes']} / "
                                     f"{got['bwd_routes']}; expected {expected}, all on wgmma")
            wan = [row["wan_bytes"] for row in rows]
            if strategy == "local_sgd":
                want_wan = [analytic[strategy] if (i + 1) % sync_every == 0 else 0 for i in range(steps)]
            else:
                want_wan = [analytic[strategy]] * steps
            if wan != want_wan:
                raise AssertionError(f"{label}: counted WAN bytes {wan}, analytic {want_wan}")
            timed = rows[WARMUP:] if steps > WARMUP + 1 else rows[1:]
            per_rank.append({
                "losses": losses, "step_ms": [row["step_s"] * 1e3 for row in rows],
                "step_ms_median": statistics.median(row["step_s"] * 1e3 for row in timed),
                "collective_ms": [row["collective_s"] * 1e3 for row in rows],
                "collective_ms_median": statistics.median(row["collective_s"] * 1e3 for row in timed),
                "wan_bytes": wan, "launches": got["launches"], "fwd_routes": got["routes"],
                "bwd_routes": got["bwd_routes"], "last_step_handed_bytes": got["last_step_handed"],
                "last_step_collective_calls": got["last_step_calls"],
                "last_step_collective_s": got["last_step_seconds"],
                "peak_memory_bytes": got["peak_memory_bytes"], "device": rank["device"],
                "sync_efficiency": got["sync_efficiency"],
            })
        summary[strategy] = {"steps": steps, "analytic_wan_bytes": analytic[strategy],
                             "losses_equal_one_process_bitwise": True, "ranks": per_rank}
    emit({
        "phase": "train_group", "arch": cfg.name, "dtype": cfg.dtype, "ranks": NPODS, "backend": "gloo",
        "global_batch": B_TRAIN, "seq_len": SEQ_TRAIN, "rows_per_rank": B_TRAIN // NPODS,
        "warmup_steps_untimed": WARMUP, "spawn_s": spawn_s,
        "train_step_ms_median_one_process_same_run": train_step_ms,
        "step_ms_is": "each rank's host clock around its step, ending in torch.cuda.synchronize()",
        "collective_ms_is": "each rank's host seconds inside gloo's all_reduce/all_gather/broadcast, "
                            "the device synchronised before and after each",
        "strategies": summary,
    })
    return {s: [r["launches"] for r in v["ranks"]] for s, v in summary.items()}


# train_mesh: (pod, data, model) meshes of 4 ranks on the card, their
# strategies and steps.  Each run is held to a one-process run of the same
# rows, weights and steps: its losses at rtol MESH_LOSS_RTOL, and the
# parameters after its last step by the norm of their difference over the
# norm of the one-process run's change from the initial weights, at most
# MESH_PARAM_RTOL (bf16 sums over data ranks and tensor-parallel halves
# round apart, and AdamW's first steps are near sign(g), so a gradient near
# 0 may step the other way; a rank that trains on half its rows moves them
# by far more: tests/test_torch_mesh.py)
MESH_RANKS = 4
MESH_PLAN = [((2, 2, 1), ("pod", "data", "model"), "hier_int8", 6),
             ((2, 2, 1), ("pod", "data", "model"), "allreduce", 3),
             ((2, 2), ("data", "model"), "allreduce", 3)]
MESH_LOSS_RTOL = 1e-3
MESH_PARAM_RTOL = 0.1
MESH_TIMEOUT_S = 600


def mesh_reference_path(strategy, steps):
    return ROOT / "build" / "chip_smoke_checkpoints" / f"train_mesh_reference_{strategy}_{steps}.pt"


def param_distances(torch, cfg, params, reference):
    """(norm of ``params`` minus the seed-0 initial weights, norm of
    ``params`` minus ``reference``), over every leaf, in float64."""
    from repro_torch.models import init_params
    from repro_torch.tree import tree_items

    init = dict(tree_items(init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")))
    change = diff = 0.0
    for path, p in tree_items(params):
        p = p.double()
        change += float((p - init[path].double()).square().sum())
        diff += float((p - reference[path].to(p.device).double()).square().sum())
    return math.sqrt(change), math.sqrt(diff)


def sequence_parallel_calls(cfg, lan_shapes, data, model, batch, seq):
    """One training step's LAN calls on a ``(data, model)`` mesh against
    sequence parallelism -> (reduce-scatters onto the rank's residual
    ``[batch / data, seq / model, D]``, all-reduces of a whole-sequence
    ``[batch / data, seq, D]`` activation, the most of those allowed).  The
    residual's partial sums over ``model`` go to the sequence shards in
    reduce-scatters; only the RG-LRU's two gate products a recurrent layer
    a forward may be all-reduced inside the block, counted where d_rnn is
    d_model (``tests/test_torch_mesh_models.py`` holds the same)."""
    b, d = batch // data, cfg.d_model
    kinds = list(cfg.pattern) * cfg.num_groups + list(cfg.remainder)
    forwards = 2 if cfg.remat in ("full", "dots") else 1
    allowed = 2 * kinds.count("recurrent") * forwards if cfg.d_rnn == d else 0
    return (lan_shapes.get(("reduce_scatter_tensor", (model * b, seq // model, d)), 0),
            lan_shapes.get(("all_reduce", (b, seq, d)), 0), allowed)


def local_ptrs(tree):
    """The storage address of every leaf's local tensor (a DTensor's shard)."""
    from repro_torch.tree import tree_items

    return [(t.to_local() if hasattr(t, "to_local") else t).data_ptr() for _, t in tree_items(tree)]


def train_mesh_rank(rank, plan):
    """One rank of train_mesh: GeoTrainer on each mesh of ``plan``, the
    counts zeroed just before each run and read just after; then its
    parameters gathered and measured against the one-process run's."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.placement import full_tree
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import BWD_ROUTE_LAUNCHES, ROUTE_LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import GeoTrainer
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("distilgpt2-82m")
    out = []
    for shape, axes, strategy, steps in plan:
        mesh = make_mesh(shape, axes, device="cuda")
        directory = ROOT / "build" / "chip_smoke_checkpoints" / f"train_mesh_{len(out)}"
        trainer = GeoTrainer(cfg, mesh, device="cuda", checkpoint_dir=str(directory),
                             trainer_cfg=train_config(strategy, steps, checkpoint_every=10 ** 6))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        ROUTE_LAUNCHES.clear()
        BWD_ROUTE_LAUNCHES.clear()
        result = trainer.run()
        launches, routes, bwd_routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES), dict(BWD_ROUTE_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        local = [t.to_local() for t in tree_leaves(trainer.params)]
        lan = trainer.step_fn.lan
        with lan, lan.uncounted():
            whole = full_tree(trainer.params)
        reference = torch.load(mesh_reference_path(strategy, steps), map_location="cuda")
        change, diff = param_distances(torch, cfg, whole, reference)
        del whole, reference
        out.append({
            "rows": result["metrics"], "launches": launches, "routes": routes, "bwd_routes": bwd_routes,
            "peak_memory_bytes": peak, "param_change_norm": change, "param_diff_norm": diff,
            "devices": sorted({t.device.type for t in local}),
            "local_param_bytes": sum(t.numel() * t.element_size() for t in local),
            "coordinate": list(mesh.get_coordinate()),
            "lan_calls": dict(trainer.step_fn.lan.calls), "lan_bytes_by_kind": dict(trainer.step_fn.lan.handed),
            "lan_shapes": dict(trainer.step_fn.lan.shapes),
            "wan_calls": dict(trainer.step_fn.group.calls) if trainer.step_fn.group is not None else {},
        })
        del trainer
        torch.cuda.empty_cache()
        if rank == 0:
            shutil.rmtree(directory, ignore_errors=True)
    return {"device": torch.cuda.get_device_name(torch.cuda.current_device()), "runs": out}


def piece_rows(n0: int, splits) -> int:
    """Rows of a leaf's dim 0 on a rank whose WAN piece splits it over the
    pod's mesh dims in order, ``splits`` = [(size, rank's index)], as
    ``torch.chunk`` (DTensor's Shard) cuts each level."""
    rows = n0
    for size, idx in splits:
        per = -(-rows // size)
        rows = max(0, min(per, rows - per * idx))
    return rows


def phase_train_mesh(torch):
    """The training path with intra-pod placement: 4 ranks share the card
    over gloo, distilgpt2-82m at full width, global batch 16 x 1024, on a
    (pod 2, data 2) mesh (the paper's 2 DCs x 2 workers: FSDP over data,
    the WAN strategy over pod on each rank's pieces) and a (data 2, model
    2) mesh (FSDP, tensor and sequence parallelism, no WAN).  Losses fall and agree
    with one-process runs of the same rows, weights and steps made here,
    and so do the parameters after the last step; the WAN bytes summed
    over a pod's ranks equal the analytic value, every flash launch runs on
    the wgmma route on the rank's local heads, wan_quant and wan_dequant on
    its pieces."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.distributed import spawn
    from repro_torch.models import init_params
    from repro_torch.tree import tree_items, tree_leaves

    cfg = get_config("distilgpt2-82m")
    shapes = [tuple(t.shape) for t in tree_leaves(init_params(cfg, device="meta"))]
    values = sum(math.prod(shp) for shp in shapes)
    analytic = {"hier_int8": (NPODS - 1) * int8_payload_bytes(shapes), "allreduce": 2 * (NPODS - 1) * 4 * values // NPODS}
    references = {}  # (strategy, steps) -> (losses, norm of the parameters' change)
    for _, _, strategy, steps in MESH_PLAN:
        if (strategy, steps) in references:
            continue
        directory = ckpt_dir(f"train_mesh_{strategy}_{steps}_one_process")
        trainer, result, *_ = train_main_path(torch, strategy, directory, steps=steps)
        params = dict(tree_items(trainer.params))
        torch.save(params, mesh_reference_path(strategy, steps))
        change, _ = param_distances(torch, cfg, params, params)
        references[strategy, steps] = ([r["loss"] for r in result["metrics"]], change)
        del trainer, params
        shutil.rmtree(directory)
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(train_mesh_rank, MESH_RANKS, MESH_PLAN, device="cuda", join_timeout_s=MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    for strategy, steps in references:
        mesh_reference_path(strategy, steps).unlink()
    runs = []
    for i, (shape, axes, strategy, steps) in enumerate(MESH_PLAN):
        sizes = dict(zip(axes, shape))
        pods = sizes.get("pod", 1)
        want, want_change = references[strategy, steps]
        per_rank = []
        for r, rank in enumerate(ranks):
            got = rank["runs"][i]
            rows = got["rows"]
            label = f"train_mesh {sizes} {strategy} rank {r}"
            losses = falling_losses(label, rows)
            if len(losses) != len(want) or any(abs(a - b) > MESH_LOSS_RTOL * abs(b) for a, b in zip(losses, want)):
                raise AssertionError(f"{label}: losses {losses} vs one-process {want}, rtol {MESH_LOSS_RTOL}")
            param_rel = got["param_diff_norm"] / want_change
            if not param_rel <= MESH_PARAM_RTOL:
                raise AssertionError(f"{label}: parameters after the last step {got['param_diff_norm']} from the "
                                     f"one-process run's, {param_rel} of its change {want_change}; "
                                     f"at most {MESH_PARAM_RTOL}")
            if got["devices"] != ["cuda"]:
                raise AssertionError(f"{label}: parameters on {got['devices']}")
            wan = [row["wan_bytes"] for row in rows]
            want_wan = analytic[strategy] if pods > 1 else 0
            if any(abs(w - want_wan) > 0.01 * want_wan for w in wan) or (pods == 1 and any(wan)):
                raise AssertionError(f"{label}: WAN bytes a pod {wan}, analytic {want_wan}")
            coord = dict(zip(axes, got["coordinate"]))
            per_step = {"flash_attention_fwd": cfg.num_layers, "flash_attention_bwd": cfg.num_layers}
            if strategy == "hier_int8":
                # the rank's non-empty WAN pieces: dim 0 split over the pod's
                # ranks, a rank-0/1 leaf whole on the pod's first rank
                splits = [(sizes[a], coord[a]) for a in ("data", "model") if a in sizes]
                first = all(i == 0 for _, i in splits)
                pieces = sum(1 for shp in shapes
                             if (len(shp) >= 2 and piece_rows(shp[0], splits) > 0) or (len(shp) < 2 and first))
                per_step.update(wan_quant=pieces, wan_dequant=pieces)
            expected = {k: steps * v for k, v in per_step.items()}
            if got["launches"] != expected or got["routes"] != {"wgmma": expected["flash_attention_fwd"]} \
                    or got["bwd_routes"] != {"wgmma": expected["flash_attention_bwd"]}:
                raise AssertionError(f"{label}: launches {got['launches']}, routes {got['routes']} / "
                                     f"{got['bwd_routes']}; expected {expected}, all on wgmma")
            seq_parallel = None
            if sizes.get("model", 1) > 1:  # the last step's calls
                scatters, whole, allowed = sequence_parallel_calls(cfg, got["lan_shapes"], sizes["data"],
                                                                   sizes["model"], B_TRAIN, SEQ_TRAIN)
                if not scatters or whole > allowed:
                    raise AssertionError(f"{label}: {scatters} reduce-scatters onto the sequence shards and "
                                         f"{whole} whole-sequence all-reduces (at most {allowed}); LAN calls "
                                         f"{got['lan_shapes']}")
                seq_parallel = {"reduce_scatters_onto_sequence_shards": scatters,
                                "whole_sequence_all_reduces": whole}
            timed = rows[WARMUP:] if steps > WARMUP + 1 else rows[1:]
            per_rank.append({
                "coordinate": coord, "losses": losses, "loss_rel_err_max": max(abs(a - b) / abs(b) for a, b in zip(losses, want)),
                "param_change_norm": got["param_change_norm"], "param_diff_norm": got["param_diff_norm"],
                "param_diff_share_of_change": param_rel, "step_ms": [row["step_s"] * 1e3 for row in rows],
                "step_ms_median": statistics.median(row["step_s"] * 1e3 for row in timed),
                "wan_s_median": statistics.median(row["collective_s"] for row in timed),
                "lan_s_median": statistics.median(row["lan_s"] for row in timed),
                "wan_bytes_rank": [row["wan_bytes_rank"] for row in rows], "wan_bytes_pod": wan,
                "lan_bytes": [row["lan_bytes"] for row in rows],
                "launches": got["launches"], "fwd_routes": got["routes"], "bwd_routes": got["bwd_routes"],
                "peak_gb": got["peak_memory_bytes"] / 1e9, "local_param_bytes": got["local_param_bytes"],
                "lan_calls": got["lan_calls"], "lan_bytes_by_kind": got["lan_bytes_by_kind"],
                "sequence_parallel_last_step": seq_parallel, "wan_calls": got["wan_calls"],
            })
        runs.append({"mesh": sizes, "strategy": strategy, "steps": steps, "one_process_losses": want,
                     "one_process_param_change_norm": want_change,
                     "analytic_wan_bytes_per_pod": analytic[strategy] if pods > 1 else 0, "ranks": per_rank})
    emit({
        "phase": "train_mesh", "arch": cfg.name, "dtype": cfg.dtype, "ranks": MESH_RANKS, "backend": "gloo",
        "global_batch": B_TRAIN, "seq_len": SEQ_TRAIN, "warmup_steps_untimed": WARMUP, "spawn_s": spawn_s,
        "loss_rtol": MESH_LOSS_RTOL, "param_rtol": MESH_PARAM_RTOL, "device": ranks[0]["device"],
        "step_ms_is": "each rank's host clock around its step, ending in torch.cuda.synchronize()",
        "wan_s_is": "the rank's host seconds in gloo's WAN collectives over pod, device synchronised around each",
        "lan_s_is": "the rank's host seconds in DTensor's intra-pod collectives (plain gloo calls), "
                    "device synchronised around each",
        "runs": runs,
    })
    return [[r["launches"] for r in run["ranks"]] for run in runs]


SERVE_MESH = ((2, 2), ("data", "model"))
SERVE_MESH_STEPS = 4


def serve_mesh_rank(rank, fed):
    """One rank of serve_mesh: prefill and a decode step for each of the
    one-process run's greedy tokens ``fed`` on the (data 2, model 2) mesh,
    the serve phase's weights and prompts (seed 0); its launches and routes."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import init_pod_params, make_decode_step, make_prefill_step
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("distilgpt2-82m")
    mesh = make_mesh(*SERVE_MESH, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_pod_params(init_params(cfg, generator=gen, device="cuda"), mesh=mesh)
    batch = synthetic_prompt_batch(cfg, gen, B_SERVE, PROMPT)
    prefill_step, placements = make_prefill_step(cfg, mesh, device="cuda")
    decode, _ = make_decode_step(cfg, mesh, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, batch, max_len=PROMPT + GEN)
    torch.cuda.synchronize()
    prefill_ms, lan = (time.perf_counter() - t0) * 1e3, prefill_step.lan.lan_bytes
    out, steps_ms = [logits.float().cpu()], []
    for i, tokens in enumerate(fed):
        t0 = time.perf_counter()
        logits, cache = decode(params, tokens.to("cuda"), cache, PROMPT + i)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.float().cpu())
    return {"logits": out, "launches": dict(LAUNCHES), "routes": dict(ROUTE_LAUNCHES), "prefill_ms": prefill_ms,
            "decode_ms": steps_ms, "prefill_lan_bytes": lan, "decode_lan_bytes": decode.lan.lan_bytes,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "cache_placements": str(placements["cache"])}


def greedy_disagreements(got, want):
    """Rows whose argmax differs between ``got`` and ``want`` logits where
    ``want``'s top two are more than SERVE_TOL x (1 + |top|) apart: a
    near-tie at bf16 rounding is no disagreement.  Returns (rows that
    disagree, rows that disagree on a near-tie)."""
    top2 = want.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= SERVE_TOL * (1 + top2[:, 0].abs())
    differ = got.argmax(-1) != want.argmax(-1)
    return int((differ & ~tie).sum()), int((differ & tie).sum())


def phase_serve_mesh(torch):
    """The serving path with intra-pod placement: 4 ranks on the card, the
    (data 2, model 2) mesh, distilgpt2-82m at full width, the serve phase's
    8 x 1024 prompts and weights: prefill and 4 decode steps fed the
    one-process run's greedy tokens, each logits held to the one-process
    run's at rtol = atol = SERVE_TOL and its greedy tokens equal (but on
    near-ties, counted); 6 flash launches a rank, all on wgmma."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import spawn
    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config("distilgpt2-82m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, device="cuda")
    batch = synthetic_prompt_batch(cfg, gen, B_SERVE, PROMPT)
    logits, cache = prefill(params, batch, cfg, max_len=PROMPT + GEN)
    want, fed = [logits.float().cpu()], []
    for i in range(SERVE_MESH_STEPS):
        fed.append(logits.argmax(-1).cpu())
        logits, cache = decode_step(params, fed[-1].to("cuda"), cache, cfg, PROMPT + i)
        want.append(logits.float().cpu())
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn(serve_mesh_rank, MESH_RANKS, fed, device="cuda", join_timeout_s=MESH_TIMEOUT_S)
    per_rank = []
    for r, rank in enumerate(ranks):
        label = f"serve_mesh rank {r}"
        diffs = [_logit_diff(g, w) for g, w in zip(rank["logits"], want)]
        if not all(share <= 1 for _, share in diffs):
            raise AssertionError(f"{label}: logits vs one process outside rtol=atol={SERVE_TOL}: {diffs}")
        greedy = [greedy_disagreements(g, w) for g, w in zip(rank["logits"], want)]
        if any(d for d, _ in greedy):
            raise AssertionError(f"{label}: greedy tokens differ beyond near-ties: {greedy}")
        if rank["launches"] != {"flash_attention_fwd": cfg.num_layers} or \
                rank["routes"] != {"wgmma": cfg.num_layers}:
            raise AssertionError(f"{label}: launches {rank['launches']}, routes {rank['routes']}; "
                                 f"expected {cfg.num_layers} flash forwards on wgmma")
        per_rank.append({"max_abs_err": [d for d, _ in diffs], "worst_share_of_tol": [s for _, s in diffs],
                         "greedy_near_tie_rows": [t for _, t in greedy],
                         "launches": rank["launches"], "fwd_routes": rank["routes"],
                         "prefill_ms": rank["prefill_ms"], "decode_ms": rank["decode_ms"],
                         "prefill_lan_bytes": rank["prefill_lan_bytes"],
                         "last_decode_lan_bytes": rank["decode_lan_bytes"],
                         "peak_gb": rank["peak_memory_bytes"] / 1e9})
    emit({
        "phase": "serve_mesh", "arch": cfg.name, "dtype": cfg.dtype, "mesh": dict(zip(SERVE_MESH[1], SERVE_MESH[0])),
        "batch": B_SERVE, "prompt": PROMPT, "decode_steps": SERVE_MESH_STEPS, "tol": SERVE_TOL,
        "decode_fed": "the one-process run's greedy tokens", "cache_placements": ranks[0]["cache_placements"],
        "ranks": per_rank,
    })
    return [r["launches"] for r in per_rank]


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


def no_checkpoint_trainer(cfg, directory, tc, *, donate=False):
    """A GeoTrainer on the card that writes no checkpoint: at the last step
    the big training phases' would hold tens of GB (the float32 parameters,
    AdamW's two moments and the two pods' int8 error feedback).  The
    checkpoint path is the train and checkpoint phases'.  ``donate``: its
    step is built with ``donate=True`` (parameters, moments and error
    feedback updated in their own storage; the same values), without which
    the old and new training state do not fit on the card together."""
    from repro_torch.distributed import make_train_step
    from repro_torch.runtime import GeoTrainer

    class NoCheckpointTrainer(GeoTrainer):
        def _save(self, step, params, state):
            pass

    trainer = NoCheckpointTrainer(cfg, device="cuda", checkpoint_dir=str(directory), trainer_cfg=tc)
    if donate:
        trainer.step_fn = make_train_step(cfg, npods=tc.npods, strategy=tc.strategy, num_channels=tc.num_channels,
                                          opt_cfg=tc.opt, diloco_cfg=tc.diloco, device="cuda", donate=True)
    return trainer


def rwkv_card_vs_cpu_step(torch, full):
    """One sequence of RWKV_CHECK_SEQ tokens through a RWKV_CHECK_LAYERS-layer
    cut at full width, from the same weights on the card and on the CPU,
    both in bf16: the loss at rtol TRAIN_TOL, each leaf's gradient by its
    relative norm at TRAIN_TOL, or, where bf16 itself resolves the leaf no
    better, at 1.5 x the CPU bf16 gradient's own distance from the float32
    one (the card's float32 run).  Measured: the bonus u, whose gradient
    sums r k (v . dy) over the sequence with cancelling signs, is 7.0% from
    float32 on the CPU in bf16 and 5.8% from the card; every other leaf
    within 1.8% of the CPU."""
    import dataclasses

    from repro_torch.data import loader_for_model
    from repro_torch.distributed import pod_grads
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import init_params
    from repro_torch.tree import tree_items, tree_leaves, tree_map

    cut = dataclasses.replace(full, num_layers=RWKV_CHECK_LAYERS)
    params = init_params(cut, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    batch = loader_for_model(cut, seq_len=RWKV_CHECK_SEQ, global_batch=1, seed=1).next_batch()
    sides, launches, cpu_s = {}, {}, None
    runs = (("card", params, cut), ("card_f32", params, dataclasses.replace(cut, dtype="float32")),
            ("cpu", tree_map(lambda t: t.cpu(), params), cut))
    for name, p, cfg in runs:
        dev = "cpu" if name == "cpu" else "cuda"
        LAUNCHES.clear()
        t0 = time.perf_counter()
        loss, _, grads = pod_grads(p, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg, 1)
        sides[name] = (loss.item(), tree_map(lambda g: g[0].float().cpu(), grads))
        if name == "card":
            launches = dict(LAUNCHES)
        elif name == "cpu":
            cpu_s = time.perf_counter() - t0
        del grads
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params

    def rel(a, b):
        return {path: ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
                for (path, x), (_, y) in zip(tree_items(sides[a][1]), tree_items(sides[b][1]))}

    leaf_err, bf16_floor = rel("card", "cpu"), rel("cpu", "card_f32")
    bar = {path: max(TRAIN_TOL, 1.5 * bf16_floor[path]) for path in leaf_err}
    g_loss, c_loss = sides["card"][0], sides["cpu"][0]
    want = {"wkv6_fwd": RWKV_CHECK_LAYERS, "wkv6_bwd": RWKV_CHECK_LAYERS}
    if (abs(g_loss - c_loss) > TRAIN_TOL * abs(c_loss) or any(leaf_err[k] > bar[k] for k in bar)
            or launches != want):
        raise AssertionError(f"train_rwkv card vs CPU: loss {g_loss} / {c_loss}, leaf relative errors {leaf_err}, "
                             f"bars {bar}; card launches {launches}, expected {want}")
    return {"layers": RWKV_CHECK_LAYERS, "params": n_params, "batch": [1, RWKV_CHECK_SEQ],
            "loss": [g_loss, c_loss], "loss_f32_card": sides["card_f32"][0],
            "leaf_rel_err_max": max(leaf_err.values()), "leaf_rel_err_worst": max(leaf_err, key=leaf_err.get),
            "tol": TRAIN_TOL, "leaves_beyond_tol": {k: {"card_vs_cpu": leaf_err[k], "cpu_bf16_vs_f32": bf16_floor[k],
                                                         "bar": bar[k]} for k in bar if leaf_err[k] > TRAIN_TOL},
            "cpu_bf16_vs_f32_max": max(bf16_floor.values()), "card_launches": launches, "cpu_s": cpu_s}


def phase_train_rwkv(torch):
    """rwkv6-7b at full width, RWKV_TRAIN_LAYERS of its 32 layers, through
    GeoTrainer: 2 pods, hier_int8, global batch 4 x 4096, AdamW, 2 untimed
    and 4 timed steps; then one step of a 2-layer cut on the card against
    the CPU."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.distributed import wan_bytes_per_step
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.rwkv6_wkv import WKV_BWD_ROUTE_LAUNCHES, bwd_route
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainerConfig
    from repro_torch.tree import tree_leaves

    full = get_config("rwkv6-7b")
    cfg = dataclasses.replace(full, num_layers=RWKV_TRAIN_LAYERS)
    opt = AdamWConfig(lr=1e-3, warmup_steps=WARMUP, total_steps=RWKV_TRAIN_STEPS)
    tc = TrainerConfig(seq_len=SEQ_RWKV_TRAIN, global_batch=B_RWKV_TRAIN, steps=RWKV_TRAIN_STEPS,
                       strategy="hier_int8", npods=NPODS, log_every=RWKV_TRAIN_STEPS, seed=0, opt=opt)
    directory = ckpt_dir("train_rwkv")
    trainer = no_checkpoint_trainer(cfg, directory, tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    WKV_BWD_ROUTE_LAUNCHES.clear()
    result = trainer.run()
    launches, bwd_routes = dict(LAUNCHES), dict(WKV_BWD_ROUTE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rows = result["metrics"]
    leaves = tree_leaves(trainer.params)
    n_leaves, n_params = len(leaves), sum(t.numel() for t in leaves)
    del leaves
    per_step = {"wkv6_fwd": NPODS * cfg.num_layers, "wkv6_bwd": NPODS * cfg.num_layers,
                "wan_quant": n_leaves, "wan_dequant": n_leaves}
    expected = {k: RWKV_TRAIN_STEPS * n for k, n in per_step.items()}
    if launches != expected:
        raise AssertionError(f"train_rwkv: launches {launches} over {RWKV_TRAIN_STEPS} steps, expected {expected}")
    path_route = bwd_route(getattr(torch, cfg.dtype), cfg.rwkv_head_dim)
    if bwd_routes != {path_route: expected["wkv6_bwd"]}:
        raise AssertionError(f"train_rwkv: wkv6_bwd routes {bwd_routes}, expected all {expected['wkv6_bwd']} on {path_route}")
    losses = falling_losses("train_rwkv", rows)
    analytic = wan_bytes_per_step(n_params * 4, "hier_int8", npods=NPODS)
    wan = [r["wan_bytes"] for r in rows]
    if any(abs(x - analytic) > 0.01 * analytic for x in wan):
        raise AssertionError(f"train_rwkv: WAN payload {wan} B/pod/step vs wan_bytes_per_step {analytic}")
    timed = [r["step_s"] * 1e3 for r in rows[WARMUP:]]
    step_ms = statistics.median(timed)
    del trainer, result
    shutil.rmtree(directory, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit({
        "phase": "train_rwkv", "arch": full.name, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
        "reduced": {"num_layers": [full.num_layers, cfg.num_layers]},
        "d_model": cfg.d_model, "heads": cfg.d_model // cfg.rwkv_head_dim, "head_dim": cfg.rwkv_head_dim,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "remat": cfg.remat, "params": n_params, "leaves": n_leaves,
        "pods": NPODS, "strategy": "hier_int8", "global_batch": B_RWKV_TRAIN, "seq_len": SEQ_RWKV_TRAIN,
        "steps": RWKV_TRAIN_STEPS, "warmup_steps_untimed": WARMUP, "checkpoint": "none written (no_checkpoint_trainer)",
        "adamw": {"lr": opt.lr, "warmup_steps": opt.warmup_steps, "total_steps": opt.total_steps},
        "step_ms_median": step_ms, "step_ms": timed,
        "tokens_per_s": B_RWKV_TRAIN * SEQ_RWKV_TRAIN / (step_ms / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "grad_norm_last": rows[-1]["grad_norm"], "peak_memory_bytes": peak, "peak_memory_gb": peak / 1e9,
        "wan_bytes_per_pod_step": wan[-1], "wan_bytes_per_step_analytic": analytic,
        "launches_main_path": launches, "launches_per_step": per_step, "wkv6_bwd_routes": bwd_routes,
        "card_vs_cpu": rwkv_card_vs_cpu_step(torch, full),
    })
    return launches


def rg_card_vs_cpu_step(torch, full):
    """One sequence of RG_TRAIN_CHECK_SEQ tokens through train_recurrentgemma's
    one-group cut at full width, its window cut to RG_CHECK_WINDOW so the
    sequence crosses it (four 64-step scan chunks), from the same weights
    on the card in bf16, on the card in float32 (the f32 flash routes at
    head_dim 256) and on the CPU in bf16: the loss at rtol TRAIN_TOL, each
    leaf's gradient by its relative norm at TRAIN_TOL, or at 1.5 x the CPU
    bf16 gradient's own distance from the card's float32 one where bf16
    resolves the leaf no better.  Each card run's launches and flash
    backward route are held too."""
    import dataclasses

    from repro_torch.data import loader_for_model
    from repro_torch.distributed import pod_grads
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import BWD_ROUTE_LAUNCHES, bwd_route
    from repro_torch.models import init_params
    from repro_torch.tree import tree_items, tree_leaves, tree_map

    cut = dataclasses.replace(full, num_layers=RG_TRAIN_LAYERS, local_window=RG_CHECK_WINDOW)
    params = init_params(cut, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    batch = loader_for_model(cut, seq_len=RG_TRAIN_CHECK_SEQ, global_batch=1, seed=1).next_batch()
    sides, launches, cpu_s = {}, {}, None
    runs = (("card", params, cut), ("card_f32", params, dataclasses.replace(cut, dtype="float32")),
            ("cpu", tree_map(lambda t: t.cpu(), params), cut))
    recurrent = sum(k == "recurrent" for k in cut.pattern)
    # remat="full" runs each forward kernel again in the backward
    want = {"rglru_scan": 2 * recurrent, "rglru_scan_bwd": recurrent,
            "flash_attention_fwd": 2 * (RG_TRAIN_LAYERS - recurrent),
            "flash_attention_bwd": RG_TRAIN_LAYERS - recurrent}
    for name, p, cfg in runs:
        dev = "cpu" if name == "cpu" else "cuda"
        LAUNCHES.clear()
        BWD_ROUTE_LAUNCHES.clear()
        t0 = time.perf_counter()
        loss, _, grads = pod_grads(p, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg, 1)
        sides[name] = (loss.item(), tree_map(lambda g: g[0].float().cpu(), grads))
        if dev == "cuda":
            route = bwd_route(getattr(torch, cfg.dtype), cfg.head_dim)
            launches[name] = (dict(LAUNCHES), dict(BWD_ROUTE_LAUNCHES))
            if launches[name] != (want, {route: want["flash_attention_bwd"]}):
                raise AssertionError(f"train_recurrentgemma card vs CPU, {name}: launches and flash backward "
                                     f"routes {launches[name]}, expected {want} and all on {route}")
        else:
            cpu_s = time.perf_counter() - t0
        del grads
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params

    def rel(a, b):
        return {path: ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
                for (path, x), (_, y) in zip(tree_items(sides[a][1]), tree_items(sides[b][1]))}

    leaf_err, bf16_floor = rel("card", "cpu"), rel("cpu", "card_f32")
    bar = {path: max(TRAIN_TOL, 1.5 * bf16_floor[path]) for path in leaf_err}
    g_loss, c_loss = sides["card"][0], sides["cpu"][0]
    if abs(g_loss - c_loss) > TRAIN_TOL * abs(c_loss) or any(leaf_err[k] > bar[k] for k in bar):
        raise AssertionError(f"train_recurrentgemma card vs CPU: loss {g_loss} / {c_loss}, leaf relative errors "
                             f"{leaf_err}, bars {bar}")
    return {"layers": RG_TRAIN_LAYERS, "local_window": cut.local_window, "params": n_params,
            "batch": [1, RG_TRAIN_CHECK_SEQ], "loss": [g_loss, c_loss], "loss_f32_card": sides["card_f32"][0],
            "leaf_rel_err_max": max(leaf_err.values()), "leaf_rel_err_worst": max(leaf_err, key=leaf_err.get),
            "tol": TRAIN_TOL, "leaves_beyond_tol": {k: {"card_vs_cpu": leaf_err[k], "cpu_bf16_vs_f32": bf16_floor[k],
                                                         "bar": bar[k]} for k in bar if leaf_err[k] > TRAIN_TOL},
            "cpu_bf16_vs_f32_max": max(bf16_floor.values()),
            "card_launches_and_bwd_routes": launches, "cpu_s": cpu_s}


def phase_train_recurrentgemma(torch):
    """recurrentgemma-9b at full width, its depth cut to one group
    (recurrent, recurrent, local attention), through GeoTrainer: 2 pods,
    hier_int8, global batch 2 x 4096, AdamW, 2 untimed and 4 timed steps,
    no checkpoint written; then one step of the cut with its window cut to
    128 on the card (bf16 and float32) against the CPU."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.distributed import wan_bytes_per_step
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import BWD_ROUTE_LAUNCHES, bwd_route
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainerConfig
    from repro_torch.tree import tree_leaves

    full = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(full, num_layers=RG_TRAIN_LAYERS)
    opt = AdamWConfig(lr=1e-3, warmup_steps=WARMUP, total_steps=RG_TRAIN_STEPS)
    tc = TrainerConfig(seq_len=SEQ_RG_TRAIN, global_batch=B_RG_TRAIN, steps=RG_TRAIN_STEPS,
                       strategy="hier_int8", npods=NPODS, log_every=RG_TRAIN_STEPS, seed=0, opt=opt)
    directory = ckpt_dir("train_recurrentgemma")
    # 1.71 B float32 parameters, AdamW's moments and two pods' error
    # feedback take 31.8 GiB; a functional step holds a second copy beside
    # the gradients (measured: out of memory in AdamW), so the step donates
    trainer = no_checkpoint_trainer(cfg, directory, tc, donate=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    BWD_ROUTE_LAUNCHES.clear()
    result = trainer.run()
    launches, bwd_routes = dict(LAUNCHES), dict(BWD_ROUTE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rows = result["metrics"]
    leaves = tree_leaves(trainer.params)
    n_leaves, n_params = len(leaves), sum(t.numel() for t in leaves)
    del leaves
    if (n_params, n_leaves) != (RG_TRAIN_PARAMS, RG_TRAIN_LEAVES):
        raise AssertionError(f"train_recurrentgemma: {n_params} parameters in {n_leaves} leaves, "
                             f"expected {RG_TRAIN_PARAMS} in {RG_TRAIN_LEAVES}")
    recurrent = sum(k == "recurrent" for k in cfg.pattern) * cfg.num_groups
    local = cfg.num_layers - recurrent
    # remat="full": the recomputed forward launches each forward kernel again
    per_step = {"rglru_scan": 2 * NPODS * recurrent, "rglru_scan_bwd": NPODS * recurrent,
                "flash_attention_fwd": 2 * NPODS * local, "flash_attention_bwd": NPODS * local,
                "wan_quant": n_leaves, "wan_dequant": n_leaves}
    expected = {k: RG_TRAIN_STEPS * n for k, n in per_step.items()}
    if launches != expected:
        raise AssertionError(f"train_recurrentgemma: launches {launches} over {RG_TRAIN_STEPS} steps, "
                             f"expected {expected}")
    path_route = bwd_route(getattr(torch, cfg.dtype), cfg.head_dim)
    if bwd_routes != {path_route: expected["flash_attention_bwd"]}:
        raise AssertionError(f"train_recurrentgemma: flash backward routes {bwd_routes}, expected all "
                             f"{expected['flash_attention_bwd']} on {path_route}")
    losses = falling_losses("train_recurrentgemma", rows)
    analytic = wan_bytes_per_step(n_params * 4, "hier_int8", npods=NPODS)
    wan = [r["wan_bytes"] for r in rows]
    if any(abs(x - analytic) > 0.01 * analytic for x in wan):
        raise AssertionError(f"train_recurrentgemma: WAN payload {wan} B/pod/step vs wan_bytes_per_step {analytic}")
    timed = [r["step_s"] * 1e3 for r in rows[WARMUP:]]
    step_ms = statistics.median(timed)
    del trainer, result
    shutil.rmtree(directory, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit({
        "phase": "train_recurrentgemma", "arch": full.name, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
        "reduced": {"num_layers": [full.num_layers, cfg.num_layers]},
        "d_model": cfg.d_model, "d_rnn": cfg.d_rnn, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "local_window": cfg.local_window, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
        "remat": cfg.remat, "params": n_params, "leaves": n_leaves,
        "pods": NPODS, "strategy": "hier_int8", "global_batch": B_RG_TRAIN, "seq_len": SEQ_RG_TRAIN,
        "steps": RG_TRAIN_STEPS, "warmup_steps_untimed": WARMUP, "checkpoint": "none written (no_checkpoint_trainer)",
        "step_donates": True,
        "adamw": {"lr": opt.lr, "warmup_steps": opt.warmup_steps, "total_steps": opt.total_steps},
        "step_ms_median": step_ms, "step_ms": timed,
        "tokens_per_s": B_RG_TRAIN * SEQ_RG_TRAIN / (step_ms / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "grad_norm_last": rows[-1]["grad_norm"], "peak_memory_bytes": peak, "peak_memory_gb": peak / 1e9,
        "wan_bytes_per_pod_step": wan[-1], "wan_bytes_per_step_analytic": analytic,
        "launches_main_path": launches, "launches_per_step": per_step, "flash_bwd_routes": bwd_routes,
        "card_vs_cpu": rg_card_vs_cpu_step(torch, full),
    })
    return launches


def router_gap(probs, k):
    """Per token, the least gap between neighbours among its k + 1 largest
    router probabilities: a rounding that moves each probability by less
    than half of it changes neither the token's expert choices nor their
    order."""
    top = probs.detach().float().topk(k + 1, dim=-1).values
    return (top[:, :-1] - top[:, 1:]).min(-1).values


class recorded_routing:
    """Within ``with``: every call of the port's MoE router
    (``repro_torch.models.ffn._router_probs``) as (its own expert choices
    [T, k], ``router_gap``), in call order, for runs that are not timed.

    ``take``: the calls route by these choices ([T, k] each) instead, the
    gates read from their own probabilities and renormalised as the router
    does, so that two runs dispatch alike.  ``per_router``: the n-th
    distinct router (by its storage) takes ``take[n]``, and a router seen
    again (the forward recomputed under remat "full") takes what it took
    first and is not recorded again; otherwise the n-th call takes
    ``take[n]``."""

    def __init__(self, take=None, per_router=False):
        self.take, self.per_router = take, per_router

    def __enter__(self):
        from repro_torch.models import ffn

        self.ffn, self.real, self.calls, seen = ffn, ffn._router_probs, [], {}

        def route(params, x, moe):
            probs, gates, idx = self.real(params, x, moe)
            n = len(self.calls)
            if self.per_router:
                n = seen.setdefault(params["router"].data_ptr(), n)
            if n == len(self.calls):
                self.calls.append((idx.detach(), router_gap(probs, moe.num_experts_per_tok)))
            if self.take is not None:
                idx = self.take[n].to(idx.device)
                gates = probs.gather(-1, idx)
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            return probs, gates, idx

        ffn._router_probs = route
        return self.calls

    def __exit__(self, *exc):
        self.ffn._router_probs = self.real


def dropped_choices(idx, moe) -> int:
    """(token, choice) pairs the einsum dispatch drops: in each group of
    MOE_GROUP_SIZE tokens an expert takes at most the capacity."""
    import torch.nn.functional as F

    from repro_torch.models.ffn import MOE_GROUP_SIZE, _capacity

    t = idx.shape[0]
    tg = min(MOE_GROUP_SIZE, t)
    counts = F.one_hot(idx.reshape(t // tg, -1), moe.num_experts).sum(1)  # (groups, E)
    return int((counts - _capacity(tg, moe)).clamp_min(0).sum())


def routing_agreement(a_calls, b_calls, bar):
    """Per router call of two runs (``recorded_routing``'s records), the
    tokens given the same expert choices in the same order; raises where
    they differ and neither run's ``router_gap`` there is below ``bar``
    (below it, that run's choice is a rounding's to move)."""
    agree = []
    for (a_idx, a_gap), (b_idx, b_gap) in zip(a_calls, b_calls, strict=True):
        same = (a_idx.cpu() == b_idx.cpu()).all(-1)
        apart = a_gap.cpu().minimum(b_gap.cpu())[~same]
        if bool((apart >= bar).any()):
            raise AssertionError(f"MoE routing: two runs route tokens apart away from a near-tie (bar {bar}), "
                                 f"gaps {apart.tolist()}")
        agree.append(same)
    return agree


def moe_card_vs_cpu(torch, full):
    """One layer of ``full`` at full width, compute in float32 from the
    config's own bf16 weights (each cast per use, as the model casts it), on
    the card and on the CPU: a [1, MOE_CHECK_PROMPT] prompt, its prefill
    and MOE_CHECK_STEPS greedy decode steps, the CPU fed the card's tokens.
    Each token's expert choices compared (apart only at near-ties), and
    each logits row at rtol = atol = TOL["float32"] where the token it
    reads through the one FFN is routed alike."""
    import dataclasses

    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_leaves, tree_map

    cut = dataclasses.replace(full, num_layers=1, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cut, generator=gen, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = synthetic_prompt_batch(cut, gen, 1, MOE_CHECK_PROMPT)
    n = MOE_CHECK_PROMPT + MOE_CHECK_STEPS
    out = {}
    fed = []
    for side in ("card", "cpu"):
        if side == "cpu":
            params = tree_map(lambda t: t.cpu(), params)
            batch = {k: v.cpu() for k, v in batch.items()}
        t0 = time.perf_counter()
        rows = []
        with recorded_routing() as calls:
            logits, cache = prefill(params, batch, cut, max_len=n)
            rows.append(logits.float().cpu())
            for i in range(MOE_CHECK_STEPS):
                if side == "card":
                    fed.append(logits.argmax(-1))
                logits, cache = decode_step(params, fed[i].to(logits.device), cache, cut, MOE_CHECK_PROMPT + i)
                rows.append(logits.float().cpu())
        out[side] = (rows, calls, time.perf_counter() - t0)
        del cache, logits
    del params
    agree = routing_agreement(out["card"][1], out["cpu"][1], MOE_NEAR_TIE)
    diffs = []
    for row, (card, cpu) in enumerate(zip(out["card"][0], out["cpu"][0])):
        if not bool(agree[row][-1]):  # the row's logits read its last token's experts
            diffs.append(None)
            continue
        d = (card - cpu).abs()
        tol = TOL["float32"]
        if not bool((d <= tol + tol * cpu.abs()).all()):
            raise AssertionError(f"MoE card vs CPU: logits row {row} max_abs_err {d.max().item()}, rtol=atol={tol}")
        diffs.append(d.max().item())
    tokens = sum(int(a.numel()) for a in agree)
    return {"layers": 1, "params": n_params, "dtype": "float32", "param_dtype": cut.param_dtype,
            "prompt": [1, MOE_CHECK_PROMPT], "decode_steps": MOE_CHECK_STEPS, "tol": TOL["float32"],
            "tokens_routed": tokens, "tokens_routed_alike": sum(int(a.sum()) for a in agree),
            "near_tie_bar": MOE_NEAR_TIE, "logits_max_abs_err_by_row": diffs,
            "card_s": out["card"][2], "cpu_s": out["cpu"][2]}


def phase_serve_moe(torch, phase):
    """An MoE arch at full width, its depth cut (MOE_CUTS): a prefill of
    B_MOE x PROMPT_MOE tokens, then GEN_MOE greedy decode steps, through the
    flash forward (one launch a layer a prefill, all on wgmma; decode runs
    dense sdpa on the cache); the choices each layer's capacity dropped in a
    prefill; then ``moe_card_vs_cpu``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.models import init_params, prefill
    from repro_torch.tree import tree_leaves

    arch, layers, want_params, want_leaves = MOE_CUTS[phase]
    gen_steps = GEN_MOE[phase]
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params, n_leaves = sum(t.numel() for t in leaves), len(leaves)
    del leaves
    if (n_params, n_leaves) != (want_params, want_leaves):
        raise AssertionError(f"{phase}: {n_params} parameters in {n_leaves} leaves, "
                             f"expected {want_params} in {want_leaves}")
    batch = synthetic_prompt_batch(cfg, gen, B_MOE, PROMPT_MOE)
    max_len = PROMPT_MOE + gen_steps

    def run():
        return serve_run(torch, params, batch, cfg, prompt=PROMPT_MOE, gen=gen_steps, max_len=max_len)

    run()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    res = run()
    launches, routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not res["ok"]:
        raise AssertionError(f"{phase}: logits not finite or of the wrong shape")
    got = [c.get("flash_attention_fwd", 0) for c in [res["after_prefill"]] + res["after_steps"]]
    if got != [layers] * (gen_steps + 1) or launches != {"flash_attention_fwd": layers} or routes != {"wgmma": layers}:
        raise AssertionError(f"{phase}: flash launches {got} after prefill and each decode step, expected "
                             f"{layers} a prefill and none in decode; all launches {launches}, routes {routes}")
    prefill_ms_median = time_ms(lambda: prefill(params, batch, cfg, max_len=max_len), runs=3, warmup=0)
    MEASURED[phase] = {"peak_bytes": peak, "ms": prefill_ms_median, "ms_is": "median prefill ms", "cfg": cfg,
                       "batch": B_MOE, "seq_len": PROMPT_MOE, "max_len": max_len}
    with recorded_routing() as calls:
        prefill(params, batch, cfg, max_len=max_len)
    drops = [dropped_choices(idx, cfg.moe) for idx, _ in calls]
    if len(drops) != layers:
        raise AssertionError(f"{phase}: {len(drops)} router calls in a prefill, expected {layers}")
    del params, calls
    gc.collect()
    torch.cuda.empty_cache()
    check = moe_card_vs_cpu(torch, full)
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.models.ffn import MOE_GROUP_SIZE, _capacity

    step_ms = res["step_ms"]
    tokens = B_MOE * PROMPT_MOE
    emit({
        "phase": phase, "arch": arch, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype, "params": n_params,
        "leaves": n_leaves, "reduced": {"num_layers": [full.num_layers, layers]},
        "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "window": cfg.window, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "experts": cfg.moe.num_experts,
        "top_k": cfg.moe.num_experts_per_tok, "capacity_factor": cfg.moe.capacity_factor,
        "parallel_dense": cfg.moe.parallel_dense, "moe_impl": cfg.moe.impl,
        "group_size": MOE_GROUP_SIZE, "capacity_per_group": _capacity(MOE_GROUP_SIZE, cfg.moe),
        "batch": B_MOE, "prompt": PROMPT_MOE, "gen": gen_steps, "init_s": init_s,
        "prefill_ms": res["t_prefill"] * 1e3, "prefill_ms_median_of_3_more": prefill_ms_median,
        "prefill_tokens_per_s": tokens / (prefill_ms_median / 1e3),
        "decode_ms_per_step_mean": statistics.fmean(step_ms), "decode_ms_per_step_median": statistics.median(step_ms),
        "decode_tokens_per_s": B_MOE * gen_steps / res["t_decode"], "decode_s": res["t_decode"],
        "peak_memory_bytes": peak, "peak_memory_gb": peak / 1e9,
        "launches_main_path": launches, "fwd_routes_main_path": routes,
        "flash_per_prefill": layers, "flash_per_decode_step": 0,
        "dropped_choices_per_layer": drops, "choices_per_layer": tokens * cfg.moe.num_experts_per_tok,
        "card_vs_cpu": check, "last_tokens": res["tokens"].tolist(),
    })
    return launches


def phase_serve_mixtral(torch):
    return phase_serve_moe(torch, "serve_mixtral")


def phase_serve_arctic(torch):
    return phase_serve_moe(torch, "serve_arctic")


def phase_train_mixtral(torch):
    """mixtral-8x22b at full width, its depth cut to one layer (MOE_CUTS),
    through GeoTrainer: 2 pods, hier_int8, global batch 2 x 4096, bf16
    parameters and compute, remat "full", AdamW, 2 untimed and 4 timed
    steps, no checkpoint written, the step built with ``donate=True``;
    the aux loss of every step read from the step's metrics; then
    ``card_vs_cpu_step`` on the same cut, the step donating too."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.distributed import wan_bytes_per_step
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import BWD_ROUTE_LAUNCHES, ROUTE_LAUNCHES
    from repro_torch.kernels.flash_attention.ops import CLUSTER_LAUNCHES
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainerConfig
    from repro_torch.tree import tree_leaves

    arch, layers, want_params, want_leaves = MOE_CUTS["train_mixtral"]
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    opt = AdamWConfig(lr=1e-3, warmup_steps=WARMUP, total_steps=MIXTRAL_TRAIN_STEPS)
    tc = TrainerConfig(seq_len=SEQ_MIXTRAL_TRAIN, global_batch=B_MIXTRAL_TRAIN, steps=MIXTRAL_TRAIN_STEPS,
                       strategy="hier_int8", npods=NPODS, log_every=MIXTRAL_TRAIN_STEPS, seed=0, opt=opt)
    directory = ckpt_dir("train_mixtral")
    # 2.91 B parameters (5.0 GB of bf16 experts and attention, 1.6 GB of
    # float32 tables), float32 moments 23.3 GB and two pods' float32 error
    # feedback 23.3 GB: a functional step's second copy does not fit
    trainer = no_checkpoint_trainer(cfg, directory, tc, donate=True)
    step, auxes = trainer.step_fn, []

    def step_with_aux(params, state, batch):  # reads the loss's aux part, which GeoTrainer's row leaves out
        out = step(params, state, batch)
        auxes.append(float(out[2]["aux"]))
        return out

    trainer.step_fn = step_with_aux
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    BWD_ROUTE_LAUNCHES.clear()
    CLUSTER_LAUNCHES.clear()
    result = trainer.run()
    launches, routes, bwd_routes = dict(LAUNCHES), dict(ROUTE_LAUNCHES), dict(BWD_ROUTE_LAUNCHES)
    bwd_clusters = dict(CLUSTER_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rows = result["metrics"]
    leaves = tree_leaves(trainer.params)
    n_leaves, n_params = len(leaves), sum(t.numel() for t in leaves)
    del leaves
    if (n_params, n_leaves) != (want_params, want_leaves):
        raise AssertionError(f"train_mixtral: {n_params} parameters in {n_leaves} leaves, "
                             f"expected {want_params} in {want_leaves}")
    # remat="full": the recomputed forward launches the flash forward again
    per_step = {"flash_attention_fwd": 2 * NPODS * layers, "flash_attention_bwd": NPODS * layers,
                "wan_quant": n_leaves, "wan_dequant": n_leaves}
    expected = {k: MIXTRAL_TRAIN_STEPS * v for k, v in per_step.items()}
    if launches != expected or routes != {"wgmma": expected["flash_attention_fwd"]} \
            or bwd_routes != {"wgmma": expected["flash_attention_bwd"]}:
        raise AssertionError(f"train_mixtral: launches {launches}, flash routes {routes} / {bwd_routes} over "
                             f"{MIXTRAL_TRAIN_STEPS} steps, expected {expected}, all on wgmma")
    losses = falling_losses("train_mixtral", rows)
    if len(auxes) != MIXTRAL_TRAIN_STEPS or not all(math.isfinite(a) and a > 0 for a in auxes):
        raise AssertionError(f"train_mixtral: aux {auxes}, expected one finite value above 0 a step")
    analytic = wan_bytes_per_step(n_params * 4, "hier_int8", npods=NPODS)
    wan = [r["wan_bytes"] for r in rows]
    if any(abs(x - analytic) > 0.01 * analytic for x in wan):
        raise AssertionError(f"train_mixtral: WAN payload {wan} B/pod/step vs wan_bytes_per_step {analytic}")
    timed = [r["step_s"] * 1e3 for r in rows[WARMUP:]]
    step_ms = statistics.median(timed)
    del trainer, result, step
    shutil.rmtree(directory, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit({
        "phase": "train_mixtral", "arch": arch, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
        "reduced": {"num_layers": [full.num_layers, layers]},
        "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "window": cfg.window, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "experts": cfg.moe.num_experts,
        "top_k": cfg.moe.num_experts_per_tok, "capacity_factor": cfg.moe.capacity_factor, "remat": cfg.remat,
        "params": n_params, "leaves": n_leaves, "pods": NPODS, "strategy": "hier_int8",
        "global_batch": B_MIXTRAL_TRAIN, "seq_len": SEQ_MIXTRAL_TRAIN, "steps": MIXTRAL_TRAIN_STEPS,
        "warmup_steps_untimed": WARMUP, "checkpoint": "none written (no_checkpoint_trainer)", "step_donates": True,
        "adamw": {"lr": opt.lr, "warmup_steps": opt.warmup_steps, "total_steps": opt.total_steps},
        "step_ms_median": step_ms, "step_ms": timed,
        "tokens_per_s": B_MIXTRAL_TRAIN * SEQ_MIXTRAL_TRAIN / (step_ms / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses, "aux": auxes,
        "grad_norm_last": rows[-1]["grad_norm"], "peak_memory_bytes": peak, "peak_memory_gb": peak / 1e9,
        "wan_bytes_per_pod_step": wan[-1], "wan_bytes_per_step_analytic": analytic,
        "launches_main_path": launches, "launches_per_step": per_step,
        "flash_fwd_routes": routes, "flash_bwd_routes": bwd_routes, "flash_bwd_launches_by_kv_cluster": bwd_clusters,
        "card_vs_cpu": card_vs_cpu_step(torch, cfg, "hier_int8", donate=True, opt=opt),
    })
    return launches


# mesh_models: recurrentgemma-9b and mixtral-8x22b at full width on a
# 4-rank mesh of the one card (gloo): (arch, run, layers, (data, model),
# batch, seq, decode or train steps).  The RG-LRU conv and scan run on each
# rank's rows and Dr / model channels, local attention on its 16 / model
# query heads over the one kv head, the experts on its E / model experts.
MESH_MODEL_RUNS = [
    ("recurrentgemma-9b", "serve", RG_TRAIN_LAYERS, (2, 2), 4, 4096, 4),
    ("recurrentgemma-9b", "train", RG_TRAIN_LAYERS, (1, 4), 2, 4096, 3),
    ("mixtral-8x22b", "serve", 2, (2, 2), 4, 4096, 4),
    ("mixtral-8x22b", "train", 1, (2, 2), 2, 4096, 3),
]
MESH_MODEL_TIMEOUT_S = 900
# the aux loss after the first step: AdamW's first update, lr * g / (|g| +
# eps), moves a router weight whose gradient is rounding by up to 2 lr
# either way, and E * sum f P follows the router directly (measured on an
# H100 80GB HBM3: 1.07e-3 at step 2 against the one-process run, the loss
# within 1e-3)
MESH_AUX_LATER_RTOL = 5 * MESH_LOSS_RTOL
# recurrentgemma-9b's bf16 logits are held in relative norm, as
# serve_recurrentgemma holds them against the CPU: at this model bf16's
# rounding alone moves them 1.7-2.2x an elementwise SERVE_TOL
MESH_REL_NORM_ARCHS = ("recurrentgemma-9b",)
MESH_MODEL_LR = 1e-3


def mesh_model_cfg(arch, layers):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers)


def mesh_model_reference(i):
    directory = ROOT / "build" / "chip_smoke_checkpoints"
    directory.mkdir(parents=True, exist_ok=True)
    return directory / f"mesh_models_reference_{i}.pt"


def mesh_model_opt(steps):
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(lr=MESH_MODEL_LR, warmup_steps=1, total_steps=steps)


def mesh_model_batches(cfg, batch, seq, steps):
    from repro_torch.data import loader_for_model

    loader = loader_for_model(cfg, seq_len=seq, global_batch=batch, seed=0)
    return [loader.next_batch() for _ in range(steps)]


class recorded_kernel_inputs:
    """Within ``with``: the shapes each call of the RG-LRU scan and the flash
    forward is handed in the models (``repro_torch.models.rglru.rglru_scan``,
    ``repro_torch.models.attention.flash_attention``): on a mesh, the rank's
    local shards."""

    def __enter__(self):
        from repro_torch.models import attention, rglru

        self.mods, self.shapes = (rglru, attention), {"rglru_scan": [], "flash_attention_fwd": []}
        self.real = (rglru.rglru_scan, attention.flash_attention)

        def scan(x, *rest):
            self.shapes["rglru_scan"].append(tuple(x.shape))
            return self.real[0](x, *rest)

        def flash(q, k, v, **kw):
            self.shapes["flash_attention_fwd"].append((tuple(q.shape), tuple(k.shape)))
            return self.real[1](q, k, v, **kw)

        rglru.rglru_scan, attention.flash_attention = scan, flash
        return self.shapes

    def __exit__(self, *exc):
        self.mods[0].rglru_scan, self.mods[1].flash_attention = self.real


def mesh_model_one_process(torch, i, run):
    """The one-process run of ``MESH_MODEL_RUNS[i]`` on the card, the same
    seed-0 weights and rows as the mesh's: serve -> the logits of the
    prefill and of each decode step (fed its greedy tokens) and the expert
    choices; train -> the losses, aux and the parameters after the last
    step (saved for the ranks), with the change from the initial weights."""
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.launch.batches import synthetic_prompt_batch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_items

    arch, kind, layers, _, batch, seq, steps = run
    cfg = mesh_model_cfg(arch, layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, device="cuda")
    out = {}
    if kind == "serve":
        prompts = synthetic_prompt_batch(cfg, gen, batch, seq)
        with recorded_routing() as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, prompts, cfg, max_len=seq + steps)
            torch.cuda.synchronize()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            want, fed, decode_ms = [logits.float().cpu()], [], []
            for j in range(steps):
                fed.append(logits.argmax(-1).cpu())
                t0 = time.perf_counter()
                logits, cache = decode_step(params, fed[-1].to("cuda"), cache, cfg, seq + j)
                torch.cuda.synchronize()
                decode_ms.append((time.perf_counter() - t0) * 1e3)
                want.append(logits.float().cpu())
        out.update(prompts={k: v.cpu() for k, v in prompts.items()}, logits=want, fed=fed, decode_ms=decode_ms,
                   routing=[(idx.cpu(), gap.cpu()) for idx, gap in calls])
        del cache, logits
    else:
        opt = mesh_model_opt(steps)
        batches = mesh_model_batches(cfg, batch, seq, steps)
        state = init_train_state(params, opt, strategy="allreduce")
        step = make_train_step(cfg, strategy="allreduce", opt_cfg=opt, device="cuda", donate=True)
        rows, step_ms = [], []
        with recorded_routing() as calls:  # every call, the recomputed forward's too: the mesh replays them
            for b in batches:
                t0 = time.perf_counter()
                params, state, metrics = step(params, state, b)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                rows.append({k: float(metrics[k]) for k in ("loss", "ce", "aux")})
        del state
        reference = {k: t.detach().cpu() for k, t in tree_items(params)}
        torch.save(reference, mesh_model_reference(i))
        change, _ = param_distances(torch, cfg, params, reference)
        out.update(batches=batches, rows=rows, step_ms=step_ms, change=change,
                   routing=[(idx.cpu(), gap.cpu()) for idx, gap in calls])
        del reference
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_models_rank(rank, plan):
    """One rank of mesh_models: each run of ``plan`` ((run, its one-process
    inputs)) on its (data, model) mesh, the counts zeroed just before and
    read just after.  A training run is routed by the one-process run's
    expert choices (its own recorded beside them), so that the two steps
    dispatch alike."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import (init_pod_params, init_train_state, make_decode_step, make_prefill_step,
                                         make_train_step)
    from repro_torch.distributed.placement import place
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import BWD_ROUTE_LAUNCHES, ROUTE_LAUNCHES
    from repro_torch.kernels.flash_attention.ops import CLUSTER_LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.tree import tree_items

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for i, ((arch, kind, layers, shape, batch, seq, steps), given) in enumerate(plan):
        cfg = mesh_model_cfg(arch, layers)
        mesh = make_mesh(shape, ("data", "model"), device="cuda")
        params = init_pod_params(init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                                             device="cuda"), mesh=mesh)
        gc.collect()
        torch.cuda.empty_cache()
        res = {"coordinate": list(mesh.get_coordinate())}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        ROUTE_LAUNCHES.clear()
        BWD_ROUTE_LAUNCHES.clear()
        CLUSTER_LAUNCHES.clear()
        if kind == "serve":
            prefill_step, placements = make_prefill_step(cfg, mesh, device="cuda")
            decode, _ = make_decode_step(cfg, mesh, device="cuda")
            prompts = {k: v.to("cuda") for k, v in given["prompts"].items()}
            with recorded_routing() as calls, recorded_kernel_inputs() as shapes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = prefill_step(params, prompts, max_len=seq + steps)
                torch.cuda.synchronize()
                res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
                lan = prefill_step.lan
                res.update(prefill_lan_bytes=lan.lan_bytes, prefill_lan_s=lan.lan_seconds,
                           prefill_lan_calls=dict(lan.calls), prefill_lan_shapes=dict(lan.shapes))
                got, decode_ms, decode_lan = [logits.float().cpu()], [], []
                for j, tokens in enumerate(given["fed"]):
                    t0 = time.perf_counter()
                    logits, cache = decode(params, tokens.to("cuda"), cache, seq + j)
                    torch.cuda.synchronize()
                    decode_ms.append((time.perf_counter() - t0) * 1e3)
                    decode_lan.append(decode.lan.lan_bytes)
                    got.append(logits.float().cpu())
            res.update(logits=got, decode_ms=decode_ms, decode_lan_bytes=decode_lan,
                       decode_lan_calls=dict(decode.lan.calls), cache_placements=str(placements["cache"]))
            del cache, logits, prefill_step, decode  # the decode step keeps the gathered parameters
        else:
            opt = mesh_model_opt(steps)
            state = init_train_state(params, opt, strategy="allreduce", mesh=mesh)
            step = make_train_step(cfg, mesh=mesh, strategy="allreduce", opt_cfg=opt, device="cuda", donate=True)
            rows = []
            storage = local_ptrs((params, state.adam.m, state.adam.v))
            d = mesh.get_local_rank("data")
            take = [idx for idx, _ in rank_routing(given["routing"], kind, layers, seq,
                                                   range(d * batch // shape[0], (d + 1) * batch // shape[0]))]
            with recorded_routing(take=take) as calls, recorded_kernel_inputs() as shapes:
                for b in given["batches"]:
                    t0 = time.perf_counter()
                    params, state, metrics = step(params, state, b)
                    torch.cuda.synchronize()
                    rows.append({"loss": float(metrics["loss"]), "ce": float(metrics["ce"]),
                                 "aux": float(metrics["aux"]), "step_ms": (time.perf_counter() - t0) * 1e3,
                                 "lan_bytes": step.lan.lan_bytes, "lan_s": step.lan.lan_seconds,
                                 "lan_calls": dict(step.lan.calls), "lan_bytes_by_kind": dict(step.lan.handed),
                                 "lan_shapes": dict(step.lan.shapes),
                                 "storage_kept": local_ptrs((params, state.adam.m, state.adam.v)) == storage,
                                 "card_free_bytes": torch.cuda.mem_get_info()[0]})
            del state
            # the distance to the one-process parameters on this rank's shards,
            # each leaf's share divided by the ranks that hold the same shard
            reference = torch.load(mesh_model_reference(i), mmap=True)
            diff2 = 0.0
            for path, t in tree_items(params):
                local = t.to_local().double()
                want = place(reference[path], t.device_mesh, t.placements).to_local().to("cuda").double()
                copies = math.prod(t.device_mesh.size(d) for d, p in enumerate(t.placements) if not p.is_shard())
                diff2 += float((local - want).square().sum()) / copies
            del reference
            res.update(rows=rows, param_diff2=diff2, devices=sorted({t.to_local().device.type
                                                                      for _, t in tree_items(params)}))
        res.update(launches=dict(LAUNCHES), routes=dict(ROUTE_LAUNCHES), bwd_routes=dict(BWD_ROUTE_LAUNCHES),
                   bwd_launches_by_kv_cluster=dict(CLUSTER_LAUNCHES),
                   peak_memory_bytes=torch.cuda.max_memory_allocated(), kernel_inputs=shapes,
                   routing=[(idx.cpu(), gap.cpu()) for idx, gap in calls])
        out.append(res)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return {"device": torch.cuda.get_device_name(torch.cuda.current_device()), "runs": out}


def mesh_model_expected(cfg, kind, shape, batch, seq, steps):
    """(launches a rank, the shapes each RG-LRU scan and flash forward call
    is handed on a rank) of a run: rows over data, Dr and query heads over
    model, kv heads too where they divide it, else the rank's one kv head."""
    data, model = shape
    b = batch // data
    recurrent = sum(k == "recurrent" for k in cfg.pattern) * cfg.num_groups
    attention = cfg.num_layers - recurrent
    kvh = cfg.num_kv_heads // model if cfg.num_kv_heads % model == 0 else 1
    flash = ((b, seq, cfg.num_heads // model, cfg.head_dim), (b, seq, kvh, cfg.head_dim))
    scan = (b, seq, cfg.d_rnn // model) if recurrent else None
    if kind == "serve":  # the prefill, then each decode step's one-token scans (decode attends by sdpa)
        launches = {"flash_attention_fwd": attention, "rglru_scan": recurrent * (1 + steps)}
        shapes = {"rglru_scan": [scan] * recurrent + [(b, 1, cfg.d_rnn // model)] * recurrent * steps,
                  "flash_attention_fwd": [flash] * attention}
    else:  # remat "full": the recomputed forward launches each forward kernel again
        launches = {"flash_attention_fwd": 2 * attention * steps, "flash_attention_bwd": attention * steps,
                    "rglru_scan": 2 * recurrent * steps, "rglru_scan_bwd": recurrent * steps}
        shapes = {"rglru_scan": [scan] * 2 * recurrent * steps, "flash_attention_fwd": [flash] * 2 * attention * steps}
    if not recurrent:
        shapes["rglru_scan"] = []
    return {k: v for k, v in launches.items() if v}, shapes


def routing_noise(a_calls, b_calls) -> float:
    """The largest change of a token's ``router_gap`` between two runs'
    records, over the tokens both route alike: each probability moved by
    at most half of it, so a token whose gap exceeds twice it in either run
    cannot have changed its choices by the runs' rounding."""
    worst = 0.0
    for (a_idx, a_gap), (b_idx, b_gap) in zip(a_calls, b_calls, strict=True):
        same = (a_idx.cpu() == b_idx.cpu()).all(-1)
        if bool(same.any()):
            worst = max(worst, float((a_gap.cpu() - b_gap.cpu()).abs()[same].max()))
    return worst


def rank_routing(calls, kind, layers, seq, rows):
    """A one-process run's router records (``recorded_routing``) cut to a
    rank's batch rows: a prefill's or a train step's calls hold ``seq``
    tokens a row, a decode step's one."""
    out = []
    for j, (idx, gap) in enumerate(calls):
        per_row = seq if kind == "train" or j < layers else 1
        cut = slice(rows.start * per_row, rows.stop * per_row)
        out.append((idx[cut], gap[cut]))
    return out


def dispatched_numels(cfg, shape, batch, seq):
    """The sizes the dispatched MoE activations (g, e, c, d) take, on a rank
    and whole: a LAN collective handed a tensor of one of them would be
    moving them."""
    from repro_torch.models.ffn import MOE_GROUP_SIZE, _capacity

    data, model = shape
    e, c, d = cfg.moe.num_experts, _capacity(MOE_GROUP_SIZE, cfg.moe), cfg.d_model
    g = batch * seq // MOE_GROUP_SIZE
    return sorted({gg * ee * c * d for gg in (g, g // data) for ee in (e, e // model)})


def phase_mesh_models(torch):
    """recurrentgemma-9b and mixtral-8x22b at full width on 4 ranks of the
    card (MESH_MODEL_RUNS), each run held to a one-process run of the same
    weights and rows made here first: serve on (data 2, model 2) -> logits at
    SERVE_TOL, greedy tokens equal but on near-ties; train (allreduce, one
    pod, donating, sequence parallel) on (data 1, model 4) or (data 2,
    model 2) -> losses at MESH_LOSS_RTOL, parameters after
    the last step within MESH_PARAM_RTOL of the one-process change; mixtral's
    expert choices through routing_agreement at MOE_NEAR_TIE_BF16 and its aux
    at MESH_LOSS_RTOL.  Every RG-LRU scan and flash forward call on a rank
    is handed its local shard, every flash launch is on wgmma, and no LAN
    collective moves the dispatched MoE activations.  One line an arch."""
    from repro_torch.distributed import spawn
    from repro_torch.models.ffn import MOE_GROUP_SIZE, _capacity

    import os

    refs = [mesh_model_one_process(torch, i, run) for i, run in enumerate(MESH_MODEL_RUNS)]
    plan = [(run, {k: v for k, v in ref.items() if k in ("prompts", "fed", "batches")
                   or (k == "routing" and run[1] == "train")}) for run, ref in zip(MESH_MODEL_RUNS, refs)]
    parent_reserved = torch.cuda.memory_reserved()
    # four ranks share the card: growable segments keep each one's cached
    # but unused blocks from adding up (the ranks' own allocators only)
    before = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        ranks = spawn(mesh_models_rank, MESH_RANKS, plan, device="cuda", join_timeout_s=MESH_MODEL_TIMEOUT_S)
    finally:
        if before is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = before
    spawn_s = time.perf_counter() - t0
    for i, run in enumerate(MESH_MODEL_RUNS):
        if run[1] == "train":
            mesh_model_reference(i).unlink()
    lines, failures = {}, []
    for i, ((arch, kind, layers, shape, batch, seq, steps), ref) in enumerate(zip(MESH_MODEL_RUNS, refs)):
        cfg = mesh_model_cfg(arch, layers)
        sizes = dict(zip(("data", "model"), shape))
        launches_want, shapes_want = mesh_model_expected(cfg, kind, shape, batch, seq, steps)
        forbidden = dispatched_numels(cfg, shape, batch, seq) if cfg.moe is not None else []
        per_rank = []
        for r, rank in enumerate(ranks):
            got = rank["runs"][i]
            label = f"mesh {arch} {kind} {sizes} rank {r}"
            if got["launches"] != launches_want or got["routes"] != {"wgmma": launches_want["flash_attention_fwd"]} \
                    or got["bwd_routes"] != ({"wgmma": launches_want["flash_attention_bwd"]}
                                             if "flash_attention_bwd" in launches_want else {}):
                failures.append(f"{label}: launches {got['launches']}, routes {got['routes']} / "
                                f"{got['bwd_routes']}; expected {launches_want}, all flash on wgmma")
            if got["kernel_inputs"] != shapes_want:
                failures.append(f"{label}: kernels handed {got['kernel_inputs']}, expected the rank's "
                                f"shards {shapes_want}")
            lan_shapes = got.get("prefill_lan_shapes") or {}
            for row in got.get("rows", []):
                lan_shapes = {**lan_shapes, **row["lan_shapes"]}
            moved = [k for k in lan_shapes if math.prod(k[1]) in forbidden]
            if moved:
                failures.append(f"{label}: LAN collectives handed the dispatched activations: {moved}")
            routing = None
            if cfg.moe is not None:
                d = got["coordinate"][0]
                mine = rank_routing(ref["routing"], kind, layers, seq,
                                    range(d * batch // shape[0], (d + 1) * batch // shape[0]))
                noise = [routing_noise([a], [b]) for a, b in zip(got["routing"], mine, strict=True)]
                bars = [max(MOE_NEAR_TIE_BF16, 2 * n) for n in noise]
                agree = []
                for a, b, bar in zip(got["routing"], mine, bars):
                    try:
                        agree += routing_agreement([a], [b], bar)
                    except AssertionError as e:
                        failures.append(f"{label}: {e}")
                routing = {"tokens_routed_alike": [int(a.sum()) for a in agree],
                           "tokens_per_call": [int(a.numel()) for a in agree], "gap_noise": noise,
                           "near_tie_bar": bars}
            entry = {"coordinate": dict(zip(("data", "model"), got["coordinate"])), "launches": got["launches"],
                     "fwd_routes": got["routes"], "bwd_routes": got["bwd_routes"],
                     "bwd_launches_by_kv_cluster": got["bwd_launches_by_kv_cluster"],
                     "peak_gb": got["peak_memory_bytes"] / 1e9, "routing_vs_one_process": routing}
            if kind == "serve":
                diffs = [_logit_diff(g, w) for g, w in zip(got["logits"], ref["logits"])]
                rel = [((g - w).norm() / w.norm()).item() for g, w in zip(got["logits"], ref["logits"])]
                if arch in MESH_REL_NORM_ARCHS:
                    if not all(x <= SERVE_TOL for x in rel):
                        failures.append(f"{label}: logits vs one process {rel} in relative norm, bar {SERVE_TOL}")
                elif not all(share <= 1 for _, share in diffs):
                    failures.append(f"{label}: logits vs one process outside rtol=atol={SERVE_TOL}: {diffs}")
                greedy = [greedy_disagreements(g, w) for g, w in zip(got["logits"], ref["logits"])]
                if any(d for d, _ in greedy):
                    failures.append(f"{label}: greedy tokens differ beyond near-ties: {greedy}")
                entry.update(prefill_ms=got["prefill_ms"], decode_ms=got["decode_ms"],
                             decode_ms_median=statistics.median(got["decode_ms"]), rel_norm_err=rel,
                             max_abs_err=[d for d, _ in diffs], worst_share_of_tol=[s for _, s in diffs],
                             greedy_near_tie_rows=[t for _, t in greedy],
                             prefill_lan_bytes=got["prefill_lan_bytes"], prefill_lan_s=got["prefill_lan_s"],
                             prefill_lan_calls=got["prefill_lan_calls"], decode_lan_bytes=got["decode_lan_bytes"],
                             decode_lan_calls_last=got["decode_lan_calls"])
            else:
                rows = got["rows"]
                for name, later in (("loss", MESH_LOSS_RTOL), ("aux", MESH_AUX_LATER_RTOL)):
                    have, want = [x[name] for x in rows], [x[name] for x in ref["rows"]]
                    bars = [MESH_LOSS_RTOL] + [later] * (len(want) - 1)
                    if not all(math.isfinite(a) for a in have) or any(
                            abs(a - b) > bar * abs(b) for a, b, bar in zip(have, want, bars)):
                        failures.append(f"{label}: {name} {have} vs one-process {want}, rtol {bars}")
                if got["devices"] != ["cuda"]:
                    failures.append(f"{label}: parameters on {got['devices']}")
                if not all(x["storage_kept"] for x in rows):
                    failures.append(f"{label}: the donating step left a leaf's storage: "
                                    f"{[x['storage_kept'] for x in rows]}")
                calls = [sequence_parallel_calls(cfg, x["lan_shapes"], *shape, batch, seq) for x in rows]
                if not all(scatters and whole <= allowed for scatters, whole, allowed in calls):
                    failures.append(f"{label}: (reduce-scatters onto the sequence shards, whole-sequence "
                                    f"all-reduces, most allowed) a step {calls}; LAN calls {rows[-1]['lan_shapes']}")
                entry.update(storage_kept=[x["storage_kept"] for x in rows],
                             reduce_scatters_onto_sequence_shards=[c[0] for c in calls],
                             whole_sequence_all_reduces=[c[1] for c in calls],
                             whole_sequence_all_reduces_allowed=calls[0][2])
                entry.update(losses=[x["loss"] for x in rows], aux=[x["aux"] for x in rows],
                             step_ms=[x["step_ms"] for x in rows],
                             step_ms_median_after_first=statistics.median(x["step_ms"] for x in rows[1:]),
                             lan_bytes=[x["lan_bytes"] for x in rows], lan_s=[x["lan_s"] for x in rows],
                             lan_calls_last=rows[-1]["lan_calls"],
                             lan_bytes_by_kind_last=rows[-1]["lan_bytes_by_kind"],
                             card_free_gb_min=min(x["card_free_bytes"] for x in rows) / 1e9)
            per_rank.append(entry)
        result = {"kind": kind, "mesh": sizes, "reduced": {"num_layers": [full_layers(arch), layers]},
                  "batch": batch, "seq": seq, "steps": steps, "launches_per_rank": launches_want,
                  "kernel_inputs_per_rank": {k: sorted(set(map(str, v))) for k, v in shapes_want.items()},
                  "one_process": {k: ref[k] for k in ("prefill_ms", "decode_ms", "rows", "step_ms", "change")
                                  if k in ref},
                  "ranks": per_rank}
        if kind == "train":
            diff = math.sqrt(sum(rank["runs"][i]["param_diff2"] for rank in ranks))
            share = diff / ref["change"]
            if not share <= MESH_PARAM_RTOL:
                failures.append(f"mesh {arch} train: parameters after the last step {diff} from the "
                                f"one-process run's, {share} of its change {ref['change']}; at most "
                                f"{MESH_PARAM_RTOL}")
            result.update(param_diff_norm=diff, param_diff_share_of_change=share, strategy="allreduce", pods=1,
                          adamw={"lr": MESH_MODEL_LR, "warmup_steps": 1, "total_steps": steps},
                          storage_kept_every_step=all(all(x["storage_kept"] for x in rank["runs"][i]["rows"])
                                                      for rank in ranks),
                          residual_local_checked=[batch // shape[0], seq // shape[1], cfg.d_model],
                          card_free_gb_min=min(rank["runs"][i]["rows"][j]["card_free_bytes"]
                                               for rank in ranks for j in range(steps)) / 1e9)
        if cfg.moe is not None:
            result.update(experts_per_rank=cfg.moe.num_experts // shape[1],
                          groups_per_rank=batch // shape[0] * seq // MOE_GROUP_SIZE,
                          capacity_per_group=_capacity(MOE_GROUP_SIZE, cfg.moe),
                          dispatched_numels_no_collective_moved=forbidden)
        lines.setdefault(arch, []).append(result)
    out = {}
    for arch, runs in lines.items():
        phase = "mesh_recurrentgemma" if arch == "recurrentgemma-9b" else "mesh_mixtral"
        emit({"phase": phase, "arch": arch, "ranks": MESH_RANKS, "backend": "gloo", "device": ranks[0]["device"],
              "dtype": mesh_model_cfg(arch, 1).dtype, "param_dtype": mesh_model_cfg(arch, 1).param_dtype,
              "spawn_s": spawn_s, "parent_reserved_gb_at_spawn": parent_reserved / 1e9,
              "rank_allocator": "expandable_segments:True", "serve_tol": SERVE_TOL, "loss_rtol": MESH_LOSS_RTOL,
              "param_rtol": MESH_PARAM_RTOL, "aux_rtol_after_the_first_step": MESH_AUX_LATER_RTOL,
              "near_tie_bar_is": "per router call, MOE_NEAR_TIE_BF16 or twice the largest router_gap change of a "
                                 "token that call routes alike"
              if arch != "recurrentgemma-9b" else None,
              "ms_is": "each rank's host clock around the call, ending in torch.cuda.synchronize()",
              "lan_s_is": "the rank's host seconds in DTensor's intra-pod collectives (plain gloo calls), "
                          "device synchronised around each",
              "logits_bar": "relative norm" if arch in MESH_REL_NORM_ARCHS else "elementwise rtol = atol",
              "runs": runs})
        out[phase] = [dict(sum((Counter(rank["runs"][i]["launches"]) for i, run in enumerate(MESH_MODEL_RUNS)
                                if run[0] == arch), Counter())) for rank in ranks]
    if failures:  # every number is on the lines above first
        raise AssertionError("mesh_models: " + "; ".join(failures))
    return out


def full_layers(arch) -> int:
    from repro_torch.configs import get_config

    return get_config(arch).num_layers


def dryrun_predictions():
    """The dry run's accounting of the three paths the earlier phases
    measured, as they build them, at world 1: train's step
    (``make_train_step`` without a mesh, as ``GeoTrainer`` builds it) and
    the recurrentgemma-9b and mixtral-8x22b prefills."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import token_specs

    def prompt(m):  # the serving path's batch: its tokens alone
        return {"tokens": token_specs(m["cfg"], m["batch"], m["seq_len"])["tokens"]}

    train, cfg = MEASURED["train"], get_config("distilgpt2-82m")
    return {
        "train": dryrun.trace_train_step(cfg, token_specs(cfg, B_TRAIN, SEQ_TRAIN), strategy="hier_int8",
                                         opt_cfg=train["opt"], npods=NPODS),
        **{path: dryrun.trace_prefill(m["cfg"], prompt(m), max_len=m["max_len"])
           for path, m in MEASURED.items() if path in ("serve_recurrentgemma", "serve_mixtral")},
    }


def phase_dryrun(torch):
    """(a) The dry run against the card: each path's predicted peak against
    the ``max_memory_allocated`` its phase measured (within
    DRYRUN_PEAK_BAND), its counted FLOPs and bytes over the phase's measured
    ms (TFLOP/s achieved, share of the bf16 peak), model FLOPs over counted
    FLOPs.  (b) The production meshes: DRYRUN_CELLS traced on fake 256- and
    512-rank groups, each command in its own process (started first, so
    that they run beside (a); no fake group reaches this process), each
    record's summary printed as the dry run prints it."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.kernels import costs
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        for m in (("single", "multi") if mesh == "both" else (mesh,)):
            (out_dir / f"{arch}__{shape}__{m}.json").unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", str(out_dir)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        rows = []
        for path, pred in dryrun_predictions().items():
            m = MEASURED[path]
            cfg = get_config("distilgpt2-82m") if path == "train" else m["cfg"]
            tokens = B_TRAIN * SEQ_TRAIN if path == "train" else m["batch"] * m["seq_len"]
            model = (6.0 if path == "train" else 2.0) * cfg.active_param_count() * tokens
            flops, nbytes, seconds = pred["flops_per_device"], pred["bytes_per_device"], m["ms"] / 1e3
            ratio = pred["memory"]["peak_estimate_bytes"] / m["peak_bytes"]
            row = {
                "phase": "dryrun", "part": "a", "path": path,
                "predicted_peak_bytes": pred["memory"]["peak_estimate_bytes"], "measured_peak_bytes": m["peak_bytes"],
                "peak_ratio": ratio, "peak_band": DRYRUN_PEAK_BAND, "predicted_memory": pred["memory"],
                "flops": flops, "flops_by_type": pred["flops_by_type"], "bytes": nbytes, "ms": m["ms"],
                "ms_is": m["ms_is"], "tflops": flops / seconds / 1e12,
                "share_of_bf16_peak": flops / seconds / costs.PEAK_FLOPS["bfloat16"],
                "bytes_per_s": nbytes / seconds, "share_of_hbm_rate": nbytes / seconds / costs.HBM_BYTES_PER_S,
                "bound_ms": costs.bound(pred["flops_by_type"], nbytes)[0],
                "model_flops": model, "model_flops_over_counted": model / flops, "ops": pred["ops"],
            }
            emit(row)
            rows.append(row)
        deadline = t0 + DRYRUN_TIMEOUT_S
        for p in procs:
            p.communicate(timeout=max(deadline - time.perf_counter(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    cells = []
    for arch, shape, mesh in DRYRUN_CELLS:
        for m in (("single", "multi") if mesh == "both" else (mesh,)):
            f = out_dir / f"{arch}__{shape}__{m}.json"
            rec = json.loads(f.read_text()) if f.exists() else {"arch": arch, "shape": shape, "mesh": m,
                                                                 "status": "error", "error": "no record"}
            dryrun._print_cell(rec, rec.get("wall_seconds", 0.0))
            cells.append(rec)
    seconds = time.perf_counter() - t0
    bad = [r["path"] for r in rows if not DRYRUN_PEAK_BAND[0] <= r["peak_ratio"] <= DRYRUN_PEAK_BAND[1]]
    emit({
        "phase": "dryrun", "part": "b", "seconds": seconds, "timeout_s": DRYRUN_TIMEOUT_S,
        "cells": [{k: r.get(k) for k in ("arch", "shape", "mesh", "status", "error", "wall_seconds", "fits",
                                         "model_flops_total", "roofline", "chips")}
                  | ({"peak_estimate_bytes": r["main"]["memory"]["peak_estimate_bytes"],
                      "flops_per_device": r["main"]["flops_per_device"],
                      "bytes_per_device": r["main"]["bytes_per_device"],
                      "collectives": r["main"]["collectives"]} if r.get("status") == "ok" else {})
                  for r in cells],
    })
    if bad:
        raise AssertionError(f"dryrun: predicted peak outside {DRYRUN_PEAK_BAND} of the measured on {bad}")
    if any(r.get("status") != "ok" for r in cells):
        raise AssertionError(f"dryrun: production cells not ok: {[(r['arch'], r['mesh'], r.get('error')) for r in cells]}")
    if seconds > DRYRUN_TIMEOUT_S:
        raise AssertionError(f"dryrun: {seconds:.1f} s, above {DRYRUN_TIMEOUT_S}")
    return rows, cells


def phase_quickstart(torch):
    """``repro_torch.examples.quickstart`` on the CPU, then on the card, each
    in a fresh checkpoint directory: the fabric, port and cost lines (the
    numpy cost model) equal, the card's 20 losses finite and falling, its
    flash launches 2 x layers a step."""
    import contextlib
    import io
    import shutil

    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import quickstart
    from repro_torch.kernels import LAUNCHES

    runs = {}
    for dev in ("cpu", "cuda"):
        directory = ckpt_dir(f"quickstart_{dev}")
        out = io.StringIO()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = quickstart.main(["--device", dev, "--checkpoint-dir", str(directory)])
        runs[dev] = (res, out.getvalue(), time.perf_counter() - t0, dict(LAUNCHES))
        shutil.rmtree(directory, ignore_errors=True)

    def numpy_lines(text):
        return [ln for ln in text.splitlines() if ln.startswith(("[fabric]", "[ports]", "[sync]", " " * 8))]

    card, cpu = runs["cuda"], runs["cpu"]
    if numpy_lines(card[1]) != numpy_lines(cpu[1]) or len(numpy_lines(card[1])) != 4 + len(card[0]["costs"]):
        raise AssertionError(f"quickstart: cost-model lines differ:\n{card[1]}\n---\n{cpu[1]}")
    losses = card[0]["losses"]
    if len(losses) != quickstart.QUICKSTART.workload.steps:
        raise AssertionError(f"quickstart: {len(losses)} steps, expected {quickstart.QUICKSTART.workload.steps}")
    falling_losses("quickstart", [{"loss": x} for x in losses])
    layers = get_smoke_config(quickstart.ARCH).num_layers
    want = {"flash_attention_fwd": layers * len(losses), "flash_attention_bwd": layers * len(losses)}
    if card[3] != want:
        raise AssertionError(f"quickstart: launches {card[3]}, expected {want}")
    emit({
        "phase": "quickstart", "command": "python -m repro_torch.examples.quickstart --device cuda",
        "numpy_lines_equal_cpu_run": True, "lines": numpy_lines(card[1]),
        "losses": losses, "cpu_losses": cpu[0]["losses"], "seconds": card[2], "cpu_seconds": cpu[2],
        "step_ms": [m["step_s"] * 1e3 for m in card[0]["result"]["metrics"]], "launches_main_path": card[3],
    })
    return card[3]


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
    wkv_bwd = phase_kernels_wkv_bwd(torch)
    rglru = phase_kernels_rglru(torch)
    rglru_bwd = phase_kernels_rglru_bwd(torch)
    gc.collect()
    torch.cuda.empty_cache()
    serve = phase_serve(torch)
    train, train_losses, train_step_ms = phase_train(torch)
    trains, one_process_losses = {}, {"hier_int8": train_losses}
    for strategy in ("ps", "local_sgd"):
        gc.collect()
        torch.cuda.empty_cache()
        trains[strategy], one_process_losses[strategy] = phase_train_strategy(torch, strategy)
    gc.collect()
    torch.cuda.empty_cache()
    group = phase_train_group(torch, one_process_losses, train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_train = phase_train_mesh(torch)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_serve = phase_serve_mesh(torch)
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
    gc.collect()
    torch.cuda.empty_cache()
    serve_rg = phase_serve_recurrentgemma(torch)
    gc.collect()
    torch.cuda.empty_cache()
    train_rwkv = phase_train_rwkv(torch)
    gc.collect()
    torch.cuda.empty_cache()
    train_rg = phase_train_recurrentgemma(torch)
    moe = {}
    for phase, run in (("serve_mixtral", phase_serve_mixtral), ("train_mixtral", phase_train_mixtral),
                       ("serve_arctic", phase_serve_arctic)):
        gc.collect()
        torch.cuda.empty_cache()
        moe[phase] = run(torch)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_models = phase_mesh_models(torch)
    quick = phase_quickstart(torch)
    phase_dryrun(torch)
    parts = phase_flash_bwd_parts(torch)

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
            "launches_serve_geo": serve_geo.get(name, 0),
            "launches_train_group_per_rank": {s: [r.get(name, 0) for r in ranks] for s, ranks in group.items()},
            "launches_train_mesh_per_rank": {f"{dict(zip(axes, shape))} {strategy}": [r.get(name, 0) for r in ranks]
                                             for (shape, axes, strategy, _), ranks in zip(MESH_PLAN, mesh_train)},
            "launches_serve_mesh_per_rank": [r.get(name, 0) for r in mesh_serve],
            "launches_train_rwkv": train_rwkv.get(name, 0), "launches_quickstart": quick.get(name, 0),
            "launches_serve_recurrentgemma": serve_rg.get(name, 0),
            "launches_train_recurrentgemma": train_rg.get(name, 0),
            "launches_per_train_recurrentgemma_step": train_rg.get(name, 0) // RG_TRAIN_STEPS,
            **{f"launches_{phase}": launches.get(name, 0) for phase, launches in moe.items()},
            "launches_per_train_mixtral_step": moe["train_mixtral"].get(name, 0) // MIXTRAL_TRAIN_STEPS,
            **{f"launches_{phase}_per_rank": [r.get(name, 0) for r in ranks] for phase, ranks in mesh_models.items()},
            **more,
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
              bwd_route=bwd[0]["bwd_route"], shapes=bwd, wgmma_parts=parts),
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
             launches_per_decode_step=rwkv_per_step, launches_per_train_step=0,
             launches_per_train_rwkv_step=train_rwkv["wkv6_fwd"] // RWKV_TRAIN_STEPS,
             training_instance_ms=wkv_bwd[0]["fwd_training_instance_ms"],
             serving_instance_ms_beside_it=wkv_bwd[0]["fwd_serving_instance_ms"]),
        dict(entry("wkv6_bwd", "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv6_bwd.cu",
                   "none: the JAX package trains RWKV6 through jax.grad of the checkpointed lax.scan "
                   "(src/repro/models/rwkv6.py:165, _wkv_with_initial_state; no Pallas backward)", wkv_bwd[0],
                   library_why="no single PyTorch call computes the WKV6 recurrence's gradient",
                   plain_ms_is=wkv_bwd[0]["plain_ms_is"], bound_figures=wkv_bwd[0]["bound_figures"],
                   bwd_route=wkv_bwd[0]["route"], shapes=wkv_bwd),
             launches=train_rwkv["wkv6_bwd"], launches_per_train_step=0,
             launches_per_train_rwkv_step=train_rwkv["wkv6_bwd"] // RWKV_TRAIN_STEPS),
        dict(entry("rglru_scan", "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
                   "none: the JAX package runs the RG-LRU as jax.lax.associative_scan (src/repro/models/rglru.py:91)",
                   rglru[0], library_why=rglru[0]["library_why"], tol_h_last=RGLRU_LAST_TOL, shapes=rglru),
             launches=serve_rg["rglru_scan"], launches_per_prefill=RG_SCANS,
             launches_per_decode_step=RG_SCANS, launches_per_train_step=0),
        dict(entry("rglru_scan_bwd", "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan_bwd.cu",
                   "none: the JAX package differentiates jax.lax.associative_scan (src/repro/models/rglru.py:67-92, "
                   "rg_lru; no Pallas kernel)", rglru_bwd[0], library_why=rglru_bwd[0]["library_why"],
                   plain_ms_is=rglru_bwd[0]["plain_ms_is"], tol_by_output=rglru_bwd[0]["tol_by_output"],
                   shapes=rglru_bwd),
             launches=train_rg["rglru_scan_bwd"], launches_per_train_step=0),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
