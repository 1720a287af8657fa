"""The training step (``repro.train`` counterpart)."""
