"""Device and dtype resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["as_dtype", "is_integer", "resolve_device"]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
}


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A dtype name as the JAX configs spell it (``"bfloat16"``) or a
    ``torch.dtype`` → ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. A CUDA request without a visible GPU raises rather than
    drifting onto the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the GPU unless "
                "the caller passes device='cpu'")
        if dev.index is None:           # "cuda" means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
