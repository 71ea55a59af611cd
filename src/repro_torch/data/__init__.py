"""Data pipeline of the port (:mod:`repro.data`)."""

from repro_torch.data.pipeline import SyntheticLMData, host_shard

__all__ = ["SyntheticLMData", "host_shard"]
