from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: F401
