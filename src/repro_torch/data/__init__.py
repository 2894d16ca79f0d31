from .pipeline import DataConfig, SyntheticLMStream

__all__ = ["DataConfig", "SyntheticLMStream"]
