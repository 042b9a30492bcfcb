"""Hand-written Hopper kernels of the port, one package per TPU kernel, and
``rglru_scan`` for the RG-LRU recurrence, which the JAX package leaves to
XLA (``jax.lax.associative_scan``).

``LAUNCHES`` counts the launches of each kernel by name.  A wrapper adds
one where it launches its kernel on the card, and nowhere else, so a run
can show that its main path went through the kernels.

Each kernel's launch is an operator of the ``repro_torch`` namespace,
``torch.ops.repro_torch.<name>`` (:func:`define_op`), whose implementation
on a CUDA tensor is the ``ctypes`` launch; its fake implementation gives
the outputs' (and scratch's) shapes, dtypes and strides without a card,
and its FLOP formula comes from :mod:`.costs`.  The wrappers call the op
on CUDA tensors only (:func:`on_card`): a CPU tensor takes the plain
version, as before.  The ops are defined through ``torch.library.Library``
rather than ``torch.library.custom_op``, whose Python wrapper adds host
time to every call (``tools/kernel_call_host.py`` measures a call's).
"""

import contextlib
from collections import Counter

import torch

from ..device import has_values
from . import costs

LAUNCHES: Counter = Counter()

LIB = torch.library.Library("repro_torch", "DEF")


def define_op(schema: str, launch, fake, cost):
    """Define ``torch.ops.repro_torch.<name>`` by ``schema``: ``launch`` is
    its implementation on CUDA tensors (the kernel's ``ctypes`` launch),
    ``fake`` gives its outputs under a fake tensor mode (no card),
    ``cost(*args)`` its (flops by type, bytes) (:func:`.costs.register_op`)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, launch, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    op = getattr(torch.ops.repro_torch, name)
    costs.register_op(op, cost)
    return op

_CARD_ROUTES = [False]


@contextlib.contextmanager
def card_routes():
    """While on, a fake tensor takes the kernels' card routes (their custom
    ops, whose fake implementations run) whatever its device.  The dry run
    traces the card's path on fake CPU tensors: in a build of PyTorch
    without CUDA, autograd cannot take a fake CUDA tensor."""
    before, _CARD_ROUTES[0] = _CARD_ROUTES[0], True
    try:
        yield
    finally:
        _CARD_ROUTES[0] = before


def on_card(t) -> bool:
    """Whether a wrapper takes its kernel's route for ``t``: a CUDA tensor,
    or a fake tensor under :func:`card_routes`; else the plain version."""
    return t.device.type == "cuda" or (_CARD_ROUTES[0] and not has_values(t))


def address(t) -> int:
    """``t``'s address, for the kernels' alignment checks: its data pointer,
    or for a fake tensor (the dry run's, which has no storage) its offset
    from its storage in bytes; storage from the caching allocator starts
    512-byte aligned, so the offset decides the alignment."""
    return t.data_ptr() if has_values(t) else t.storage_offset() * t.element_size()
