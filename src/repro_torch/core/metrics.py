"""Error metrics for approximate arithmetic (paper eq. 2 and relatives) on
tensors — the port of ``repro/core/metrics.py``. Each is computed in
float32, as the reference does, and returned as a 0-d float32 tensor."""

from __future__ import annotations

import torch

__all__ = ["mred", "nmed", "max_red", "error_rate"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _rel(s_hat, s, eps: float):
    s_hat, s = _f32(s_hat), _f32(s)
    valid = s.abs() > eps
    denom = torch.where(valid, s.abs(), torch.ones_like(s))
    return torch.where(valid, (s_hat - s).abs() / denom,
                       torch.zeros_like(s)), valid


def mred(s_hat, s, *, eps: float = 0.0) -> torch.Tensor:
    """Mean Relative Error Distance, mean(|ŝ − s| / s) over the non-zero
    exact sums (paper eq. 2)."""
    rel, valid = _rel(s_hat, s, eps)
    return rel.sum() / valid.sum().clamp(min=1).to(torch.float32)


def nmed(s_hat, s, *, max_abs: float) -> torch.Tensor:
    """Normalized Mean Error Distance: mean(|ŝ − s|) / max_abs."""
    return (_f32(s_hat) - _f32(s)).abs().mean() / max_abs


def max_red(s_hat, s) -> torch.Tensor:
    """Worst-case relative error distance."""
    return _rel(s_hat, s, 0.0)[0].max()


def error_rate(s_hat, s) -> torch.Tensor:
    """Fraction of results that differ at all (ER)."""
    return (torch.as_tensor(s_hat) != torch.as_tensor(s)).to(
        torch.float32).mean()
