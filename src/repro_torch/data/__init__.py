from repro_torch.data.pipeline import DataConfig, SyntheticLMData, make_host_batch

__all__ = ["DataConfig", "SyntheticLMData", "make_host_batch"]
