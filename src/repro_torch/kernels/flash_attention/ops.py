"""Flash attention in the model's [B, S, H, hd] layout, with its gradient.

On a CUDA tensor the forward launches the hand-written kernel
``csrc/flash_fwd.cu`` (the port of the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``), on the
route :func:`fwd_route` picks from the dtype and head_dim, and the
backward ``csrc/flash_bwd.cu`` (the JAX package has no backward kernel), on
the route :func:`bwd_route` picks, or they raise if the inputs are ones
they cannot take.  On a CPU tensor they compute the plain versions
(:mod:`.ref`).  There is no other fallback: the
kernels take any sequence lengths S >= 1, ragged tiles included, and read
their inputs through their strides with no copy.  Head dims 8 and 12 (the
smoke configs of yi-34b and starcoder2-7b) run zero-padded to 16 on the
16-wide kernels (:func:`pad_head_dim`), with the softmax scale of the true
head_dim; ``PADDED_LAUNCHES`` counts those launches beside their route.

:func:`flash_attention` records a gradient only where autograd needs one:
then it goes through :class:`FlashAttentionFn`, whose forward also writes
the rows' log-sum-exp for the backward.  Serving runs under ``no_grad`` and
launches the forward alone.

Each launch is a custom op, ``torch.ops.repro_torch.flash_fwd`` and
``flash_bwd``, with a fake implementation (the outputs' and the scratch's
shapes, for the dry run) and a FLOP formula from
:mod:`repro_torch.kernels.costs`.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from ...device import has_values
from .. import LAUNCHES, _build, address, costs, define_op, on_card
from .ref import flash_attention_bwd_ref, flash_attention_ref

KERNEL = "flash_attention_fwd"
BWD_KERNEL = "flash_attention_bwd"
#: head dims a kernel is built for
HEAD_DIMS = (16, 64, 96, 128, 256)
#: head dims that run zero-padded on head_dim to ``PAD_TO``
PADDED_HEAD_DIMS = (8, 12)
PAD_TO = 16
_DTYPES = (torch.bfloat16, torch.float32)
#: route -> the code ``repro_flash_fwd`` and ``repro_flash_bwd`` take for it
ROUTES = {"f32": 0, "mma_sync": 1, "wgmma": 2}
#: forward launches by route, counted beside ``LAUNCHES``
ROUTE_LAUNCHES: Counter = Counter()
#: backward launches by route, counted beside ``LAUNCHES``
BWD_ROUTE_LAUNCHES: Counter = Counter()
#: launches by kernel name (forward, backward) whose head_dim was zero-padded
PADDED_LAUNCHES: Counter = Counter()


def kernel_head_dim(head_dim: int) -> int:
    """The head_dim the kernel runs at: ``head_dim`` itself, or ``PAD_TO``
    for the padded ones; raises for any other."""
    if head_dim in HEAD_DIMS:
        return head_dim
    if head_dim in PADDED_HEAD_DIMS:
        return PAD_TO
    raise ValueError(f"no kernel for head_dim {head_dim}: kernels take {HEAD_DIMS}, padded {PADDED_HEAD_DIMS}")


def pad_head_dim(*tensors: torch.Tensor):
    """[B, S, H, hd] tensors zero-padded on head_dim to the kernel's
    (:func:`kernel_head_dim`); unchanged where it is the same.  Zero
    columns leave q . k unchanged, and give zero output and gradient
    columns, which the caller slices off."""
    hd = tensors[0].shape[3]
    extra = kernel_head_dim(hd) - hd
    return [torch.nn.functional.pad(t, (0, extra)) if extra else t for t in tensors]


def fwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which forward kernel serves (dtype, head_dim); raises for any other.

    ``"wgmma"``: bf16 at head_dim 64, 128 and 256 (recurrentgemma-9b), the
    Hopper kernel (TMA ring, wgmma, warp specialisation) that every
    full-width path runs.  ``"mma_sync"``: bf16 at head_dim 96
    (phi-3-vision-4.2b) and 16 (the smoke configs; 8 and 12 padded to 16).
    ``"f32"``: float32 at 16, 64, 96, 128 and 256 (8 and 12 padded).
    """
    return _route(dtype, head_dim, "forward")


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which backward kernels serve (dtype, head_dim); raises for any other.

    ``"wgmma"``: bf16 at head_dim 64, 128 and 256 (recurrentgemma-9b), the
    Hopper kernels (TMA rings, wgmma, warp specialisation) that every
    full-width training path runs.  ``"mma_sync"``: bf16 at head_dim 96 and
    16 (8 and 12 padded to 16).  ``"f32"``: float32 at 16, 64, 96, 128 and
    256 (8 and 12 padded).
    """
    return _route(dtype, head_dim, "backward")


def _route(dtype: torch.dtype, head_dim: int, which: str) -> str:
    try:
        hd = kernel_head_dim(head_dim)
    except ValueError as e:
        raise ValueError(f"no {which} kernel for dtype {dtype} with head_dim {head_dim}: {e}") from None
    if dtype == torch.bfloat16:
        return "wgmma" if hd in (64, 128, 256) else "mma_sync"
    if dtype == torch.float32:
        return "f32"
    raise ValueError(f"no {which} kernel for dtype {dtype} with head_dim {head_dim}")


#: CTAs a cluster may split a dK/dV item's query heads over (``wgmma``), by
#: head_dim: at 128 a pair, each CTA's float32 partials going through the
#: other's Q and dO ring (``csrc/flash_bwd.cu::cluster_sum_128``)
KV_CLUSTER_SIZES = {256: (1, 2, 4), 128: (1, 2)}
KV_CLUSTERS = (1, 2, 4)
#: dK/dV keys an item takes at head_dim 256 and 128 (``csrc/flash_bwd.cu``, ``KvShape<HD>::kKeys``)
KV_ITEM_KEYS_256 = 64
KV_ITEM_KEYS_128 = 128
#: backward launches by the dK/dV kernel's cluster size, counted beside ``LAUNCHES``
CLUSTER_LAUNCHES: Counter = Counter()


def dkdv_cluster(batch: int, kv_heads: int, seq_k: int, groups: int, sms: int) -> int:
    """CTAs a cluster of the hd-256 dK/dV kernel splits each item's
    ``groups`` query heads over: the size in ``KV_CLUSTER_SIZES[256]``
    dividing ``groups`` whose clusters finish soonest, counting per CTA the
    rounds of items (``sms // size`` clusters at once) times its share of
    the heads; on a tie the smaller (less to sum).  An item is 64 keys of
    one (kv head, batch row)."""
    items = batch * kv_heads * -(-seq_k // KV_ITEM_KEYS_256)

    def cost(size):
        return -(-items // max(sms // size, 1)) * (groups // size)

    return min((s for s in KV_CLUSTER_SIZES[256] if groups % s == 0), key=lambda s: (cost(s), s))


def dkdv_cluster_128(batch: int, kv_heads: int, seq_k: int, groups: int, sms: int) -> int:
    """The same for the hd-128 dK/dV kernel, whose item is 128 keys of one
    (kv head, batch row): 2 where the items are fewer than the SMs and
    ``groups`` is even, else 1.  With fewer items than SMs one round leaves
    SMs idle and the heaviest item (under the causal mask the first key
    tile, seen by every query of every head) sets the time; a pair of CTAs
    halves each item, and the second round, dealt in reverse, evens out a
    pair's heavy and light items.  With items enough to fill the card, a
    pair's wait and sum at each item's end cost more than they even out.
    On the H100 (``tools/flash_fwd_gqa.py``, 1 x 4096): the mesh training
    shard, 24 heads over 4 (128 items), dK/dV 0.70 ms at 1 and 0.39 at 2;
    mixtral's 48 over 8 (256 items) 0.72 at 1 and 0.76 at 2."""
    items = batch * kv_heads * -(-seq_k // KV_ITEM_KEYS_128)
    return 2 if items < sms and groups % 2 == 0 else 1


def bwd_cluster(dtype: torch.dtype, batch: int, heads: int, kv_heads: int, seq_k: int, head_dim: int,
                sms: int) -> int:
    """The dK/dV kernel's cluster size for a backward of these shapes, as
    the wrapper picks it: :func:`dkdv_cluster` at head_dim 256,
    :func:`dkdv_cluster_128` at 128 (``wgmma`` route), else 1."""
    if bwd_route(dtype, head_dim) != "wgmma" or head_dim not in KV_CLUSTER_SIZES:
        return 1
    size = dkdv_cluster if head_dim == 256 else dkdv_cluster_128
    return size(batch, kv_heads, seq_k, heads // kv_heads, sms)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window, logit_softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, hd]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head_dim")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("sequence lengths must be >= 1")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, got {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if window is not None and sq >= k.shape[1] + window:
        raise ValueError(f"window {window} with Sq {sq} >= Sk {k.shape[1]} + window: a query row would see no key")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")


def _layout_error(name: str, t: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot read ``t`` through its strides, or None."""
    if kernel_head_dim(t.shape[3]) != t.shape[3]:
        return None  # the kernels read a zero-padded copy
    if t.stride(3) != 1:
        return f"{name}: head_dim must be contiguous, strides {t.stride()}"
    # bf16 tiles load as 16-byte vectors of 8 elements
    if t.dtype == torch.bfloat16 and (any(s % 8 for s in t.stride()[:3]) or address(t) % 16):
        return f"{name}: bf16 strides {t.stride()} or address not 16-byte aligned"
    return None


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel takes {_DTYPES}, got {q.dtype}")
    fwd_route(q.dtype, q.shape[3])  # raises, naming the head_dim
    b, sq, h, _ = q.shape
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        err = _layout_error(name, t)
        if err:
            raise ValueError(err)


def _strides(*tensors) -> ctypes.Array:
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _dims(q: torch.Tensor, k: torch.Tensor) -> ctypes.Array:
    b, sq, h, _ = q.shape
    return (ctypes.c_int * 5)(b, h, k.shape[2], sq, k.shape[1])


def _launch_fwd(q, k, v, out, lse, *, scale, causal, window, logit_softcap) -> None:
    lib = _build.load("flash_fwd")
    fn = lib.repro_flash_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    strides, dims = _strides(q, k, v, out), _dims(q, k)
    hd = q.shape[3]
    route = fwd_route(q.dtype, hd)
    err = fn(
        q.device.index, ROUTES[route], hd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        ctypes.addressof(strides), ctypes.addressof(dims),
        int(causal), window or 0, logit_softcap or 0.0, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    LAUNCHES[KERNEL] += 1
    ROUTE_LAUNCHES[route] += 1


def _launch_bwd(q, k, v, o, lse, do, delta, dq, dk, dv, *, scale, causal, window, logit_softcap, kv_cluster) -> None:
    lib = _build.load("flash_bwd")
    fn = lib.repro_flash_bwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    strides, dims = _strides(q, k, v, o, do, dq, dk, dv), _dims(q, k)
    hd = q.shape[3]
    route = bwd_route(q.dtype, hd)
    err = fn(
        q.device.index, ROUTES[route], hd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ctypes.addressof(strides), ctypes.addressof(dims),
        int(causal), window or 0, logit_softcap or 0.0, scale, kv_cluster,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, BWD_KERNEL)
    LAUNCHES[BWD_KERNEL] += 1
    BWD_ROUTE_LAUNCHES[route] += 1
    CLUSTER_LAUNCHES[kv_cluster] += 1


# -- the launches as custom ops: the ctypes launch on the card, shapes under a fake tensor --

def _fwd_outputs(q, with_lse: bool):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    shape = (q.shape[0], q.shape[2], q.shape[1]) if with_lse else (0,)
    return out, torch.empty(shape, dtype=torch.float32, device=q.device)


def _flash_fwd_launch(q, k, v, scale, causal, window, logit_softcap, with_lse):
    """One forward launch on checked, padded inputs -> (out, lse; lse is
    empty unless ``with_lse``); ``window`` 0 and ``logit_softcap`` 0 are none."""
    out, lse = _fwd_outputs(q, with_lse)
    _launch_fwd(q, k, v, out, lse if with_lse else None, scale=scale, causal=causal, window=window or None,
                logit_softcap=logit_softcap or None)
    return out, lse


def _bwd_outputs(q, k, v, lse):
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)  # the launch's scratch
    return delta, torch.empty(q.shape, dtype=q.dtype, device=q.device), torch.empty(
        k.shape, dtype=k.dtype, device=k.device), torch.empty(v.shape, dtype=v.dtype, device=v.device)


def _flash_bwd_launch(q, k, v, o, lse, dout, scale, causal, window, logit_softcap, kv_cluster):
    """One backward launch on checked, padded inputs -> (dq, dk, dv)."""
    delta, dq, dk, dv = _bwd_outputs(q, k, v, lse)
    _launch_bwd(q, k, v, o, lse, dout, delta, dq, dk, dv, scale=scale, causal=causal, window=window or None,
                logit_softcap=logit_softcap or None, kv_cluster=kv_cluster)
    return dq, dk, dv


def _fwd_cost(q, k, v, scale, causal, window, logit_softcap, with_lse):
    b, sq, h, hd = q.shape
    return costs.flash_fwd(b, sq, k.shape[1], h, k.shape[2], hd, costs.dtype_name(q.dtype), window or None, causal)


def _bwd_cost(q, k, v, o, lse, dout, scale, causal, window, logit_softcap, kv_cluster):
    b, sq, h, hd = q.shape
    return costs.flash_bwd(b, sq, k.shape[1], h, k.shape[2], hd, costs.dtype_name(q.dtype), window or None, causal)


define_op("flash_fwd(Tensor q, Tensor k, Tensor v, float scale, bool causal, int window, float logit_softcap, "
          "bool with_lse) -> (Tensor, Tensor)", _flash_fwd_launch,
          lambda q, k, v, *rest: _fwd_outputs(q, rest[-1]), _fwd_cost)
define_op("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor dout, float scale, bool causal, "
          "int window, float logit_softcap, int kv_cluster) -> (Tensor, Tensor, Tensor)", _flash_bwd_launch,
          lambda q, k, v, o, lse, *rest: _bwd_outputs(q, k, v, lse)[1:], _bwd_cost)


def _heads_first(*tensors):
    return [t.transpose(1, 2) for t in tensors]


def flash_attention_fwd(q, k, v, *, causal=True, window=None, logit_softcap=None, with_lse=False):
    """The forward alone -> out [B, Sq, H, hd] (and lse [B, H, Sq] float32 if asked)."""
    _check(q, k, v, window, logit_softcap)
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    if not on_card(q):
        out, lse = flash_attention_ref(*_heads_first(q, k, v), **kw)
        out = out.transpose(1, 2)
    else:
        _check_cuda(q, k, v)
        hd = q.shape[3]
        q, k, v = pad_head_dim(q, k, v)
        out, lse = torch.ops.repro_torch.flash_fwd(q, k, v, hd ** -0.5, causal, window or 0, logit_softcap or 0.0,
                                                   with_lse)
        if out.shape[3] != hd:
            if has_values(out):  # launched: a fake tensor's op launches nothing
                PADDED_LAUNCHES[KERNEL] += 1
            out = out[..., :hd]
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None, logit_softcap=None, kv_cluster=None):
    """dq, dk, dv [B, S, H, hd] from the forward's inputs, output and lse.

    ``kv_cluster`` (tests and timing only) forces the hd-128 or hd-256
    ``wgmma`` dK/dV kernel's cluster size, else :func:`bwd_cluster` picks it."""
    _check(q, k, v, window, logit_softcap)
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    if not on_card(q):
        grads = flash_attention_bwd_ref(*_heads_first(q, k, v, o), lse, do.transpose(1, 2), **kw)
        return tuple(g.transpose(1, 2) for g in grads)
    _check_cuda(q, k, v)
    if _layout_error("do", do):  # autograd's gradient: read it contiguous
        do = do.contiguous()
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match q {tuple(q.shape)} {q.dtype}")
        err = _layout_error(name, t)
        if err:
            raise ValueError(err)
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 [B, H, Sq], got {tuple(lse.shape)} {lse.dtype}")
    hd = q.shape[3]
    if kv_cluster is None:  # a fake tensor (the dry run) is on no card: take the H100's SM count
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count if has_values(q) else costs.SMS
        kv_cluster = bwd_cluster(q.dtype, q.shape[0], q.shape[2], k.shape[2], k.shape[1], hd, sms)
    groups = q.shape[2] // k.shape[2]
    sizes = KV_CLUSTER_SIZES.get(hd, (1,)) if bwd_route(q.dtype, hd) == "wgmma" else (1,)
    if kv_cluster not in sizes or groups % kv_cluster:
        raise ValueError(f"kv_cluster {kv_cluster}: this backward's dK/dV kernel takes {sizes} dividing the "
                         f"{groups} query heads a kv head (head_dim {hd}, {q.dtype})")
    q, k, v, o, do = pad_head_dim(q, k, v, o, do)
    dq, dk, dv = torch.ops.repro_torch.flash_bwd(q, k, v, o, lse, do, hd ** -0.5, causal, window or 0,
                                                 logit_softcap or 0.0, kv_cluster)
    if q.shape[3] != hd:
        if has_values(q):
            PADDED_LAUNCHES[BWD_KERNEL] += 1
        return dq[..., :hd], dk[..., :hd], dv[..., :hd]
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the kernel backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap):
        out, lse = flash_attention_fwd(
            q, k, v, causal=causal, window=window, logit_softcap=logit_softcap, with_lse=True
        )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, KVH, hd]
    v: torch.Tensor,  # [B, Sk, KVH, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Blocked online-softmax attention; query and key indices start at 0."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if on_card(q):
            bwd_route(q.dtype, q.shape[3])  # no backward kernel: raise before the forward runs
        return FlashAttentionFn.apply(q, k, v, causal, window, logit_softcap)
    return flash_attention_fwd(q, k, v, causal=causal, window=window, logit_softcap=logit_softcap)
