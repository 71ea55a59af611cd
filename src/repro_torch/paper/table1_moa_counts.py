"""Paper Table 1: the MOA census of AlexNet's conv layers under Direct
Hardware Mapping (the counterpart of ``benchmarks/table1_moa_counts.py``;
numpy on the host, no device work)."""

from __future__ import annotations

import time

from repro_torch.core import dhm
from repro_torch.paper.timing import derived

__all__ = ["run"]


def run(verbose: bool = True, device="cuda"):
    del device                       # a census: nothing runs on a device
    t0 = time.perf_counter()
    reports = dhm.analyze_network(
        dhm.ALEXNET_CONV_SPECS, densities=dhm.paper_calibrated_densities())
    elapsed_us = (time.perf_counter() - t0) * 1e6
    rows = []
    if verbose:
        print("# Table 1 — MOAs and mean non-null operands per AlexNet layer")
        print(f"{'layer':8s} {'N (MOAs)':>9s} {'C·J·K':>7s} {'n_opd':>8s} "
              f"{'paper':>6s} {'err%':>6s} {'MOA frac':>9s}")
    for r in reports:
        paper = dhm.ALEXNET_PAPER_NOPD[r.spec.name]
        err = 100 * abs(r.n_opd - paper) / paper
        rows.append((r.spec.name, r.spec.n_filters, r.spec.operands,
                     r.n_opd, paper, err, r.moa_fraction))
        if verbose:
            print(f"{r.spec.name:8s} {r.spec.n_filters:9d} "
                  f"{r.spec.operands:7d} {r.n_opd:8.1f} {paper:6d} "
                  f"{err:5.2f}% {r.moa_fraction:8.1%}")
    return {
        "us_per_call": elapsed_us,
        "derived": derived(
            max_nopd_err=f"{max(r[5] for r in rows):.2f}%",
            conv1_moa_frac=f"{rows[0][6]:.3f}(paper:0.69)"),
    }
