"""Carry the JAX package's parameters into the port.

The reference's ``registry.init`` returns a nested dict of arrays (the
decoder LMs' tree, with the vlm family's ``frontend.adapter``, or the
enc-dec tree); the port's parameter tree has the same names and layouts,
so the conversion is a copy: no transposes, no renames.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_params


def _groups(tree: dict, prefix: str = "") -> dict:
    """Flatten to ``{"layers.attn": {"wq": array, ...}, ...}``: a dict whose
    values are all arrays is one parameter group."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    nested = {k: v for k, v in tree.items() if isinstance(v, dict)}
    if leaves and nested:
        raise ValueError(f"mixed leaves and subtrees under {prefix!r}")
    if leaves:
        return {prefix: leaves}
    out = {}
    for k, v in nested.items():
        out.update(_groups(v, f"{prefix}.{k}" if prefix else k))
    return out


def params_from_numpy(tree: dict, device="cuda", dtype=None,
                      trainable: bool = False):
    """The port's parameters from a nested dict of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)`` of the reference's
    ``registry.init``).
    ``dtype`` (a ``torch.dtype``) overrides the arrays' own; bfloat16
    arrays, which numpy lacks, arrive as float32 and need it.
    ``trainable`` makes the parameters require gradients."""
    device = resolve_device(device)
    tensors = {}
    for group, leaves in _groups(tree).items():
        tensors[group] = {}
        for name, arr in leaves.items():
            t = torch.from_numpy(np.array(arr, copy=True))
            tensors[group][name] = t.to(device=device,
                                        dtype=dtype or t.dtype)
    return build_params(tensors, trainable)
