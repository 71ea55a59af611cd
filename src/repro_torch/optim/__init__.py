"""Optimizer of the port (:mod:`repro.optim`): AdamW, learning-rate
schedules and int8 gradient compression with error feedback."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule, linear_warmup
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           compressed_gradients,
                                           init_error_feedback)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update",
    "cosine_schedule", "linear_warmup",
    "compress_int8", "decompress_int8", "compressed_gradients",
    "init_error_feedback",
]
