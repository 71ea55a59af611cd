"""The paper's experiments on the port (the counterpart of
``examples/paper_repro.py`` and ``benchmarks/run.py``).

  python -m repro_torch.launch.paper_repro                  # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.paper_repro --device cpu
  python -m repro_torch.launch.paper_repro --strategy "serial?chunk=256"

Runs, in order:

1. Table 1, Fig. 4, Fig. 5 and the strategy sweep (``repro_torch.paper``),
   under ``moa_scope(--strategy)`` when one is given; then the
   ``name,us_per_call,derived`` CSV of ``benchmarks/run.py``.
2. The LOA conv: ``im2col_conv`` on quantized int32 operands (unsigned
   8-bit activations, 4-bit weights) under ``loa?approx_bits=l&width=8``,
   ``l ∈ {0, 2, 4, 6}``, at the paper example's 16×16×3 / 5×5 shape
   (K = 75: not a multiple of ``chunk=256``, so one cluster, and exact, on
   the kernel route) and at AlexNet conv3's (``(--alexnet-batch, 13, 13,
   256)``, ``(384, 256, 3, 3)``, SAME; K = 2304: 9 clusters, 8 LOA folds).
   MRED against the exact conv, per route; on the card the kernel route is
   also held bit for bit against its plain version.
3. LeNet-5 (batch 16) and AlexNet (227×227×3, batch ``--alexnet-batch``,
   full width) forward in f32: ``accum="im2col"`` under ``tree`` and
   ``serial?chunk=256`` against ``accum="conv"``.

Sections 2 and 3 name their strategies and run outside ``--strategy``'s
scope; on the card they are timed with CUDA events (a host-clock time of
the CPU's plain versions would say nothing of the port). Runs on the GPU
unless ``--device cpu`` is given. Random operands and weights: seed 0.
"""

from __future__ import annotations

import argparse
import contextlib
from typing import List

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.scm import quantize_symmetric
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.models import cnn
from repro_torch.moa import moa_scope, resolve
from repro_torch.paper import (fig4_serialization, fig5_loa, moa_strategies,
                               table1_moa_counts)
from repro_torch.paper.timing import time_us

__all__ = ["main", "run_benchmarks", "loa_conv", "cnn_forward", "run_all",
           "CNN_TOL"]

BENCHES = [("table1_moa_counts", table1_moa_counts.run),
           ("fig4_serialization", fig4_serialization.run),
           ("fig5_loa", fig5_loa.run),
           ("moa_strategies", moa_strategies.run)]

#: im2col against conv logits, f32: |diff| <= CNN_TOL * max(1, max|conv|).
#: Both sum in f32 in different orders (cuDNN / the CPU conv against the
#: dot_moa K clusters) over contractions of up to 2304 operands and two FC
#: layers; a tenth of the bound of the reference's own im2col-vs-conv test
#: (2e-3).
CNN_TOL = 2e-4


def run_benchmarks(device, *, strategy: str = "", verbose: bool = True):
    """The four runners, under ``moa_scope(strategy)`` if given: a list of
    ``(name, us_per_call, derived)``."""
    scope = moa_scope(resolve(strategy)) if strategy \
        else contextlib.nullcontext()
    if strategy and verbose:
        print(f"# moa_scope override: {resolve(strategy).spec}")
    out = []
    with scope:
        for name, fn in BENCHES:
            if verbose:
                print(f"\n=== {name} " + "=" * (68 - len(name)))
            res = fn(verbose=verbose, device=device)
            out.append((name, res["us_per_call"], res["derived"]))
    return out


def _quantized_operands(rs, x_shape, w_shape, dev):
    """Unsigned 8-bit activations and 4-bit weight magnitudes, int32 (the
    reference example's operands)."""
    x = quantize_symmetric(rs.standard_normal(x_shape), 8) + 128
    w = np.abs(quantize_symmetric(rs.standard_normal(w_shape), 4))
    return (torch.from_numpy(x.astype(np.int32)).to(dev),
            torch.from_numpy(w.astype(np.int32)).to(dev))


def loa_conv(device, *, batch: int = 1, verbose: bool = True) -> List[dict]:
    """Section 2 of the module docstring: one row per (shape, l)."""
    dev = resolve_device(device)
    rs = np.random.default_rng(0)
    shapes = [("paper example", (1, 16, 16, 3), (8, 3, 5, 5), "VALID"),
              ("alexnet conv3", (batch, 13, 13, 256), (384, 256, 3, 3),
               "SAME")]
    routes = ("kernel", "torch") if dev.type == "cuda" else ("torch",)
    rows = []
    if verbose:
        print("\n=== LOA inside a real conv layer " + "=" * 36)
    for name, xs, ws, pad in shapes:
        xq, wq = _quantized_operands(rs, xs, ws, dev)
        b = torch.zeros(ws[0], dtype=torch.int32, device=dev)
        cols, _ = cnn.im2col_patches(xq, ws[2], ws[3], stride=1, padding=pad)
        wmat = wq.reshape(ws[0], -1).t().contiguous()
        exact = cnn.im2col_conv(xq, wq, b, stride=1, padding=pad,
                                strategy="tree")
        if not torch.equal(exact.reshape(cols.shape[0], -1),
                           ref.matmul_accum(cols, wmat, torch.int32)):
            raise AssertionError(f"{name}: the exact conv is not exact")
        k = cols.shape[1]
        for l in (0, 2, 4, 6):
            spec = f"loa?approx_bits={l}&width=8"
            strat = resolve(spec)
            block_k = strat._fold_block(k)
            row = {"shape": name, "x": list(xs), "w": list(ws), "K": k,
                   "l": l, "block_k": block_k, "loa_folds": k // block_k - 1,
                   "mred": {}, "us": {}}
            for route in routes:
                s = f"{spec}&backend={route}"
                run = lambda: cnn.im2col_conv(xq, wq, b, stride=1,
                                              padding=pad, strategy=s)
                approx = run()
                row["mred"][route] = float(metrics.mred(approx, exact))
                if route == "kernel":
                    plain = ref.dot_moa_ref(cols, wmat, block_k=block_k,
                                            approx_bits=l)
                    row["bit_exact_vs_plain"] = torch.equal(
                        approx.reshape(plain.shape), plain)
                    if not row["bit_exact_vs_plain"]:
                        raise AssertionError(f"{name} l={l}: the kernel "
                                             "route differs from its plain "
                                             "version")
                if dev.type == "cuda":
                    row["us"][route], row["clock"] = time_us(run, dev, 3)
            rows.append(row)
            if verbose:
                print(f"{name:14s} K={k:5d} l={l} block_k={block_k:5d} "
                      f"folds={row['loa_folds']}  " + "  ".join(
                          f"MRED[{r}]={m:.5f}"
                          for r, m in row["mred"].items()))
    if verbose:
        print("→ graceful error growth, as Fig. 5 predicts; the kernel route "
              "is exact where K is not a multiple of chunk=256 (one "
              "cluster, no LOA fold).")
    return rows


def cnn_forward(device, *, batch: int = 1,
                verbose: bool = True) -> List[dict]:
    """Section 3 of the module docstring: one row per (net, strategy);
    AlexNet at ``batch`` (0 skips it)."""
    dev = resolve_device(device)
    timed = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    nets = [("lenet5", cnn.init_lenet5, cnn.lenet5_forward, (16, 32, 32, 1))]
    if batch:
        nets.append(("alexnet", cnn.init_alexnet, cnn.alexnet_forward,
                     (batch, 227, 227, 3)))
    rows = []
    if verbose:
        print("\n=== CNN forward: im2col through the MOA strategy vs conv "
              + "=" * 11)
    with torch.no_grad():
        for net, init, fwd, shape in nets:
            params = init(0, device=dev)
            x = torch.randn(shape, generator=g, device=dev)
            want = fwd(params, x, accum="conv")
            t_conv, clock = time_us(lambda: fwd(params, x, accum="conv"), dev,
                                    3) if timed else (None, None)
            tol = CNN_TOL * max(1.0, float(want.abs().max()))
            for spec in ("tree", "serial?chunk=256"):
                run = lambda: fwd(params, x, accum="im2col", strategy=spec)
                got = run()
                err = float((got - want).abs().max())
                row = {"net": net, "input": list(shape), "strategy": spec,
                       "route": resolve(spec).resolve_backend(x),
                       "logits": list(got.shape), "max_abs_err": err,
                       "tol": tol, "finite": bool(torch.isfinite(got).all()),
                       "im2col_us": time_us(run, dev, 3)[0] if timed
                       else None,
                       "conv_us": t_conv, "clock": clock}
                rows.append(row)
                if verbose:
                    times = (f" im2col {row['im2col_us']:.0f}us conv "
                             f"{t_conv:.0f}us ({clock})" if timed else "")
                    print(f"{net:8s} {str(tuple(shape)):20s} {spec:18s} "
                          f"route={row['route']:6s} err={err:.2e} "
                          f"(tol {tol:.1e}){times}")
                if not (row["finite"] and err <= tol):
                    raise AssertionError(f"{net} {spec}: im2col logits off "
                                         f"conv by {err} > {tol}")
    return rows


def run_all(device="cuda", *, strategy: str = "", batch: int = 1,
            verbose: bool = True) -> dict:
    """Every section, with AlexNet and the conv3 LOA conv at ``batch``; the
    results as one dict."""
    return {"benchmarks": run_benchmarks(device, strategy=strategy,
                                         verbose=verbose),
            "loa_conv": loa_conv(device, batch=max(batch, 1),
                                 verbose=verbose),
            "cnn": cnn_forward(device, batch=batch, verbose=verbose)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Table 1, Fig. 4, Fig. 5, the LOA conv and the CNNs on "
                    "the port")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; the CPU runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--strategy", metavar="SPEC", default="",
                    help="run the four benchmark runners under "
                         "moa_scope(SPEC), e.g. 'serial?chunk=256'")
    ap.add_argument("--alexnet-batch", type=int, default=1,
                    help="batch of the full-width AlexNet forward (0 skips "
                         "it) and of the conv3-shaped LOA conv")
    args = ap.parse_args(argv)
    out = run_all(args.device, strategy=args.strategy,
                  batch=args.alexnet_batch)
    print("\nname,us_per_call,derived")
    for name, us, d in out["benchmarks"]:
        print(f"{name},{us:.1f},{d}")
    return out


if __name__ == "__main__":
    main()
