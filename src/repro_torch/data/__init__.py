"""The synthetic data pipeline of the port (`repro.data`)."""

from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticSource

__all__ = ["DataConfig", "Prefetcher", "SyntheticSource"]
