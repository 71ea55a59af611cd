"""Single-Constant-Multiplication (SCM) weight census — the port's numpy
copy of ``repro/core/scm.py``.

Under Direct Hardware Mapping every weight gets its own multiplier tiled to
the constant: zeros vanish, ±2^k become wiring, only generic constants need
adders. Zero weights remove operands from the MOA: Table 1's "mean
non-null operands per MOA".
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SCMCensus", "classify_weights", "quantize_symmetric"]


@dataclasses.dataclass(frozen=True)
class SCMCensus:
    """Per-filter multiplier census after SCM optimization."""

    total: int            # C*J*K operands per filter × N filters
    zeros: int            # multiplications removed entirely
    pow2: int             # ±2^k → shift (wiring)
    generic: int          # need a real (adder-based) multiplier
    n_filters: int        # N — number of MOAs in the layer
    mean_nonnull_per_moa: float  # Table 1's n_opd

    @property
    def density(self) -> float:
        return 1.0 - self.zeros / max(self.total, 1)


def quantize_symmetric(w: np.ndarray, bits: int = 8) -> np.ndarray:
    """Symmetric per-tensor quantization to signed ``bits`` integers."""
    w = np.asarray(w, dtype=np.float64)
    qmax = 2 ** (bits - 1) - 1
    scale = np.max(np.abs(w)) / qmax if np.max(np.abs(w)) > 0 else 1.0
    return np.clip(np.round(w / scale), -qmax - 1, qmax).astype(np.int32)


def _is_pow2(q: np.ndarray) -> np.ndarray:
    a = np.abs(q)
    return (a > 0) & ((a & (a - 1)) == 0)


def classify_weights(weights: np.ndarray, *, already_quantized: bool = False,
                     bits: int = 8) -> SCMCensus:
    """Census of ``(N, C, J, K)`` conv filters or ``(N, K)`` linear weights
    (one MOA per leading index)."""
    w = np.asarray(weights)
    n_filters = w.shape[0]
    q = (w.astype(np.int64) if already_quantized
         else quantize_symmetric(w, bits))
    q = q.reshape(n_filters, -1)
    zeros = int(np.sum(q == 0))
    pow2 = int(np.sum(_is_pow2(q)))
    total = int(q.size)
    nonnull_per_filter = np.sum(q != 0, axis=1)
    return SCMCensus(
        total=total,
        zeros=zeros,
        pow2=pow2,
        generic=total - zeros - pow2,
        n_filters=n_filters,
        mean_nonnull_per_moa=float(np.mean(nonnull_per_filter)),
    )
