"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch around hand-written CUDA C++ kernels.  Its layout
mirrors ``repro``'s (``configs/``, ``core/``, ``kernels/``, ``models/``,
``serving/``) so each module's counterpart is found by name.  It imports
``torch`` and never ``jax`` nor anything of ``repro``: what it needs from
there (the config schema, the block solver) is copied.

Entry points (``models.transformer.init_lm``, ``serving.ServeEngine``) run
on the card by default and raise without one unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper computes its plain
PyTorch version (``kernels/ref.py``).
"""
from repro_torch.device import resolve_device  # noqa: F401
