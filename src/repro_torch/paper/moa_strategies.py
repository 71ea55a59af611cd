"""The registry sweep of MOA strategies (the counterpart of the sweep in
``benchmarks/moa_strategies.py``).

Every registered strategy contributes its ``bench_specs()``; each spec runs
``strategy.dot`` on its own backend (``kernel`` specs need CUDA tensors and
are skipped on the CPU) against a float64 (floats) or exact integer
product, showing that the schedule does not change the math of the exact
strategies. The model-level line retargets one built model with
:func:`~repro_torch.moa.moa_scope` (the smoke llama3-8b's loss under
``tree`` and under ``serial?chunk=16``, :func:`scope_losses`), and the int8
gradient-compression line is the reference's analytic count.
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.moa import (available_strategies, get_strategy_class,
                             moa_scope, resolve)
from repro_torch.paper.timing import derived, time_us

__all__ = ["run", "scope_losses", "SCOPES"]

#: the model-level line's two strategies
SCOPES = ("tree", "serial?chunk=16")


def scope_losses(model, params, batch) -> tuple:
    """``model.loss`` of ``batch`` under each of :data:`SCOPES`, as
    floats: one built model retargeted by the ambient scope."""
    out = []
    with torch.no_grad():
        for spec in SCOPES:
            with moa_scope(spec):
                out.append(float(model.loss(params, batch)[0]))
    return tuple(out)


def _scope_line(dev) -> tuple:
    """The smoke llama3-8b (seed 0) on 4 sequences of 64 random tokens."""
    model = build_model(smoke_config(get_config("llama3-8b")))
    params = model.init(seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, model.cfg.vocab, (4, 65), generator=g,
                           device=dev, dtype=torch.int32)
    return scope_losses(model, params, {"tokens": tokens[:, :-1],
                                        "labels": tokens[:, 1:]})


def run(verbose: bool = True, device="cuda"):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    M, K, N = 256, 4096, 256
    a = torch.randn((M, K), generator=g, device=dev)
    b = torch.randn((K, N), generator=g, device=dev)
    want_f = (a.double() @ b.double())
    # integer-only strategies (LOA) materialize (M, K, N) partial products
    # on the torch route: keep their problem DHM-conv-sized
    Mi, Ki, Ni = 64, 512, 64
    ai = torch.randint(0, 8, (Mi, Ki), generator=g, device=dev,
                       dtype=torch.int32)
    bi = torch.randint(0, 8, (Ki, Ni), generator=g, device=dev,
                       dtype=torch.int32)
    want_i = (ai.double() @ bi.double())
    if verbose:
        print(f"# registry-driven MOA sweep on ({M}x{K})·({K}x{N}); "
              f"strategies: {available_strategies()}")
        print(f"{'spec':>32s} {'route':>6s} {'us':>9s} {'max_err':>9s}")
    exact_max_err = 0.0
    clock = "-"
    for name in available_strategies():
        for spec in get_strategy_class(name).bench_specs():
            strat = resolve(spec)
            x, y, want = (ai, bi, want_i) if strat.integer_only else \
                (a, b, want_f)
            if strat.backend == "kernel" and dev.type != "cuda":
                if verbose:
                    print(f"{spec:>32s} {'kernel':>6s}   (needs CUDA tensors)")
                continue
            f = (lambda: strat.dot(x, y, out_dtype=torch.int32)) \
                if strat.integer_only else (lambda: strat.dot(x, y))
            us, clock = time_us(f, dev, reps=3)
            err = float((f().double() - want).abs().max())
            if strat.cost(K)["exact"]:
                exact_max_err = max(exact_max_err, err)
            if verbose:
                print(f"{spec:>32s} {strat.resolve_backend(x):>6s} "
                      f"{us:9.1f} {err:9.2e}")
    lt, ls = _scope_line(dev)
    # int8 gradient all-reduce wire bytes (analytic, llama3-8b, 16 devices)
    pbytes = get_config("llama3-8b").param_count() * 4
    full = 2 * (pbytes / 16) * 15 / 16
    compressed = full / 4
    if verbose:
        print(f"# model-level loss under moa_scope: tree={lt:.4f} "
              f"serial={ls:.4f} (delta {abs(lt - ls):.2e})")
        print(f"# int8 grad all-reduce wire bytes: {full / 1e9:.1f}GB → "
              f"{compressed / 1e9:.1f}GB per device ({full / compressed:.1f}x)")
    return {
        "us_per_call": (time.perf_counter() - t0) * 1e6,
        "derived": derived(strategy_max_err=f"{exact_max_err:.2e}",
                           loss_delta=f"{abs(lt - ls):.2e}",
                           grad_compress=f"{full / compressed:.1f}x",
                           clock=clock),
    }
