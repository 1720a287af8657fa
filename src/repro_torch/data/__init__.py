"""Data pipelines (``repro.data`` counterparts)."""
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM  # noqa: F401
