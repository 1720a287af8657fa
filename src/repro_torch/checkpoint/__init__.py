"""Checkpointing (``repro.checkpoint`` counterpart)."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
