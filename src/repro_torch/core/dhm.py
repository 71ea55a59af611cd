"""Direct-Hardware-Mapping (DHM) analyzer, Table 1 — the port's numpy copy
of ``repro/core/dhm.py``.

For a conv layer ``(N, C, J, K)`` and its quantized weights: ``N`` MOAs,
``C·J·K`` structural operands each, the mean non-null operand count
``n_opd`` after SCM zero removal, and the share of layer logic spent on
MOAs (the paper's 69 %). Trained AlexNet weights are not available, so
Table 1 plants a Bernoulli zero mask at the paper's per-layer densities
(``paper_calibrated_densities``); the structural counts are exact. The same
seed gives the same reports as the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import cost_model, scm

__all__ = ["ConvLayerSpec", "MOAReport", "analyze_layer", "analyze_network",
           "paper_calibrated_densities", "ALEXNET_CONV_SPECS",
           "ALEXNET_PAPER_NOPD", "LENET5_CONV_SPECS"]


@dataclasses.dataclass(frozen=True)
class ConvLayerSpec:
    name: str
    n_filters: int    # N  (== number of MOAs)
    in_channels: int  # C (per group)
    kernel_h: int     # J
    kernel_w: int     # K

    @property
    def operands(self) -> int:
        """Structural MOA fan-in C·J·K."""
        return self.in_channels * self.kernel_h * self.kernel_w


# AlexNet conv geometry; grouped convs (conv2/4/5, groups=2) use per-group C
ALEXNET_CONV_SPECS: List[ConvLayerSpec] = [
    ConvLayerSpec("conv1", 96, 3, 11, 11),     # 363 operands
    ConvLayerSpec("conv2", 256, 48, 5, 5),     # 1200
    ConvLayerSpec("conv3", 384, 256, 3, 3),    # 2304
    ConvLayerSpec("conv4", 384, 192, 3, 3),    # 1728
    ConvLayerSpec("conv5", 256, 192, 3, 3),    # 1728
]

# Paper Table 1 — mean non-null operands per MOA with trained 8-bit weights
ALEXNET_PAPER_NOPD: Dict[str, int] = {
    "conv1": 325, "conv2": 957, "conv3": 1774, "conv4": 1398, "conv5": 1420,
}

LENET5_CONV_SPECS: List[ConvLayerSpec] = [
    ConvLayerSpec("conv1", 6, 1, 5, 5),
    ConvLayerSpec("conv2", 16, 6, 5, 5),
]


@dataclasses.dataclass(frozen=True)
class MOAReport:
    spec: ConvLayerSpec
    census: scm.SCMCensus
    moa_alms: float          # ALMs of the N adder trees
    multiplier_alms: float   # ALMs of the SCM-tiled multipliers
    moa_fraction: float      # the paper's "69 %" metric

    @property
    def n_opd(self) -> float:
        return self.census.mean_nonnull_per_moa


def analyze_layer(spec: ConvLayerSpec, weights: Optional[np.ndarray] = None,
                  *, bits: int = 8,
                  rng: Optional[np.random.Generator] = None,
                  target_density: Optional[float] = None) -> MOAReport:
    """One conv layer's DHM resource split. Without ``weights``, int8
    weights are drawn from ``rng`` (Gaussian, quantized) and, with
    ``target_density``, zeros planted i.i.d. at rate ``1 - density``."""
    rng = rng or np.random.default_rng(0)
    shape = (spec.n_filters, spec.in_channels, spec.kernel_h, spec.kernel_w)
    if weights is None:
        w = rng.standard_normal(shape)
        q = scm.quantize_symmetric(w, bits)
        if target_density is not None:
            keep = rng.random(shape) < target_density
            q = np.where(keep, np.where(q == 0, 1, q), 0)
        census = scm.classify_weights(q, already_quantized=True)
    else:
        census = scm.classify_weights(weights, bits=bits)

    moa_alms = spec.n_filters * cost_model.alm_adder_tree(
        int(round(census.mean_nonnull_per_moa)), bits)
    # zeros cost 0, powers of two ~0 (wiring), generic constants a
    # shift-add multiplier
    mult_alms = census.generic * cost_model.alm_scm_multiplier(bits)
    return MOAReport(
        spec=spec,
        census=census,
        moa_alms=moa_alms,
        multiplier_alms=mult_alms,
        moa_fraction=moa_alms / max(moa_alms + mult_alms, 1e-9),
    )


def analyze_network(specs: Sequence[ConvLayerSpec], *, bits: int = 8,
                    densities: Optional[Dict[str, float]] = None,
                    seed: int = 0) -> List[MOAReport]:
    rng = np.random.default_rng(seed)
    out = []
    for spec in specs:
        density = None
        if densities and spec.name in densities:
            density = densities[spec.name]
        out.append(analyze_layer(spec, bits=bits, rng=rng,
                                 target_density=density))
    return out


def paper_calibrated_densities() -> Dict[str, float]:
    """Per-layer non-null densities implied by Table 1 (n_opd / C·J·K)."""
    return {s.name: ALEXNET_PAPER_NOPD[s.name] / s.operands
            for s in ALEXNET_CONV_SPECS}
