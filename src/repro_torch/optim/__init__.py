"""Optimizers (``repro.optim`` counterparts)."""
