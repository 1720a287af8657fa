"""Device policy: entry points run on the card unless the caller asks for
the CPU, and say so plainly when there is no card."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and ``torch.cuda.is_available()`` is false: the port never
    drops to the CPU on its own.  Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def cache_device(device=None) -> torch.device:
    """:func:`resolve_device` for a decode cache's constructor, which also
    takes ``"meta"``: the cache's shapes and dtypes without an allocation
    (``models.registry.input_specs``, the dry-run's stand-ins)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)
