"""Device selection for the port's entry points.

Every entry point defaults to ``"cuda"``.  Asking for the card where there
is none raises: the port never falls back to the CPU on its own.  The CPU
runs only when a caller asks for it (the tests do), and then every kernel
wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

DeviceLike = Union[str, torch.device]


def has_values(t: torch.Tensor) -> bool:
    """False for a fake tensor (the dry run's, :mod:`repro_torch.launch.dryrun`),
    which has a shape but no values to read; a kernel wrapper asks on every
    call, so it is one ``isinstance``."""
    return not isinstance(t, FakeTensor)


def host_tensors():
    """A context in which new tensors are real even while a trace runs: a
    host integer the step reduces and reads back (a metric)."""
    return unset_fake_temporarily()


def resolve_device(device: DeviceLike) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(d)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return d
