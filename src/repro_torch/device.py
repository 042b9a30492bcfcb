"""Device selection for the port's entry points.

Every entry point defaults to ``"cuda"``.  Asking for the card where there
is none raises: the port never falls back to the CPU on its own.  The CPU
runs only when a caller asks for it (the tests do), and then every kernel
wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(d)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return d
