"""Runnable examples (twins of the repository's ``examples/``):
``python -m repro_torch.examples.<name> [--device cpu]``."""
