"""Paper Fig. 5: LOA accuracy (MRED) and area (the counterpart of
``benchmarks/fig5_loa.py``).

Accuracy: MRED over uniform random operands for b ∈ {4, 8, 12, 16} and
l/b ∈ {0 … 50 %} (under 10 % at 8 bits, as the paper's curves). Area: the
ALM model, flat in ``l`` (the FPGA negative result), and the op count that
prices the LOA strategy (6 ops against 1 hard add). Measured on the device:
the ``loa_add`` kernel against the exact add, and — beyond the reference —
the LOA inside a multi-operand adder of AlexNet conv3's fan-in (2304 8-bit
operands) through ``LOAStrategy.sum``, on the ``auto`` route (on the card
the ``loa_reduce`` kernel: exact 256-operand clusters, LOA folds) and the
``torch`` route (an LOA at every adder of a binary tree).
"""

from __future__ import annotations

import time

import torch

from repro_torch.core import cost_model, loa, metrics
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.moa import resolve
from repro_torch.paper.timing import derived, time_us

__all__ = ["run", "moa_mred"]

N_PAIRS = 200_000
MOA_OPERANDS, MOA_OUTPUTS = 2304, 4096


def moa_mred(dev: torch.device, *, approx_bits: int, backend: str) -> float:
    """MRED of a 2304-operand 8-bit sum (``MOA_OUTPUTS`` of them) through
    ``loa?approx_bits=l`` on ``backend`` against the exact sum."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (MOA_OPERANDS, MOA_OUTPUTS), generator=g,
                      device=dev, dtype=torch.int32)
    spec = f"loa?approx_bits={approx_bits}&backend={backend}"
    s_hat = resolve(spec).sum(x, axis=0)
    return float(metrics.mred(s_hat, x.sum(0, dtype=torch.int32)))


def run(verbose: bool = True, device="cuda"):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if verbose:
        print("# Fig. 5 — LOA MRED vs approximation ratio (top) and "
              "cost (bottom)")
        print(f"{'b':>3s} {'l':>3s} {'ratio':>6s} {'MRED':>8s} {'ALMs':>5s}")
    mred_8bit_max = 0.0
    flat_alms = True
    for bits in (4, 8, 12, 16):
        g = torch.Generator(device=dev).manual_seed(bits)
        x = torch.randint(0, 2 ** bits, (N_PAIRS,), generator=g, device=dev,
                          dtype=torch.int32)
        y = torch.randint(0, 2 ** bits, (N_PAIRS,), generator=g, device=dev,
                          dtype=torch.int32)
        base_alm = cost_model.alm_loa_adder(bits, 0)
        for l in range(0, bits // 2 + 1):
            m = float(metrics.mred(loa.loa_add(x, y, approx_bits=l,
                                               width=bits), x + y))
            alms = cost_model.alm_loa_adder(bits, l)
            flat_alms &= alms == base_alm
            if bits == 8:
                mred_8bit_max = max(mred_8bit_max, m)
            if verbose:
                print(f"{bits:3d} {l:3d} {l / bits:6.1%} {m:8.4f} {alms:5d}")

    # the LOA inside a conv3-sized MOA, per route
    routes = ("auto", "torch") if dev.type == "cuda" else ("torch",)
    moa = {r: {l: moa_mred(dev, approx_bits=l, backend=r)
               for l in (0, 2, 4, 6)} for r in routes}
    route_auto = resolve("loa").resolve_backend(
        torch.empty(0, device=dev, dtype=torch.int32))
    if verbose:
        print(f"# LOA in a {MOA_OPERANDS}-operand MOA (AlexNet conv3 "
              f"fan-in), MRED by l:")
        for r, row in moa.items():
            name = route_auto if r == "auto" else r
            print(f"#   route {name:6s} " + "  ".join(
                f"l={l}: {m:.5f}" for l, m in row.items()))

    g = torch.Generator(device=dev).manual_seed(0)
    xk = torch.randint(0, 256, (1 << 16,), generator=g, device=dev,
                       dtype=torch.int32)
    yk = torch.randint(0, 256, (1 << 16,), generator=g, device=dev,
                       dtype=torch.int32)
    t_loa, clock = time_us(lambda: ops.loa_add(xk, yk, approx_bits=4), dev)
    t_exact, _ = time_us(lambda: xk + yk, dev)
    ratio = (resolve("loa?approx_bits=4").cost(2, "int8")["ops_per_add"]
             / cost_model.vpu_ops_exact_add())
    if verbose:
        print(f"# LOA = {ratio:.0f} ops vs 1 hard add ({ratio:.0f}x); "
              f"measured ({clock} clock) loa_add {t_loa:.1f}us vs exact add "
              f"{t_exact:.1f}us on 65536 words")
        print("# → approximation saves nothing where the exact adder is "
              "hard-wired. 'How not to solve it', reproduced.")
    return {
        "us_per_call": (time.perf_counter() - t0) * 1e6,
        "derived": derived(
            mred8bit_max=f"{mred_8bit_max:.4f}(paper:<0.10)",
            alm_flat=flat_alms, tpu_loa_cost=f"{ratio:.0f}x",
            moa_mred_l4=f"{moa['torch'][4]:.5f}@torch"
            + (f",{moa['auto'][4]:.5f}@{route_auto}" if "auto" in moa else ""),
            loa_us=f"{t_loa:.1f}", exact_us=f"{t_exact:.1f}", clock=clock),
    }
