from repro_torch.configs.base import ModelConfig

__all__ = ["ModelConfig"]
