"""Paper Fig. 4: the serialized MOA against the pipelined adder tree (the
counterpart of ``benchmarks/fig4_serialization.py``).

FPGA side: the calibrated ALM model, where the serializer's linear cost
buries the accumulator's savings at every cluster size (the paper's first
negative result). Device side: the same schedule, serial accumulation over
512-operand clusters, as ``resolve("serial?chunk=512").sum`` — on the card
the ``moa_reduce`` kernel — against the one-shot reductions: ``tree`` (the
same kernel with one 4096-operand cluster) and ``torch.sum``, on a
``(4096, 256)`` f32 operand, with the working-set reduction read from the
strategies' own ``cost``.
"""

from __future__ import annotations

import time

import torch

from repro_torch.core import cost_model
from repro_torch.device import resolve_device
from repro_torch.moa import resolve
from repro_torch.paper.timing import derived, time_us

__all__ = ["run", "CLUSTERS", "SHAPE"]

CLUSTERS = [2, 4, 6, 8, 16, 32, 64, 128, 325, 957, 1774]
SHAPE = (4096, 256)


def run(verbose: bool = True, device="cuda"):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if verbose:
        print("# Fig. 4 — FPGA ALM model: serialized MOA vs binary adder "
              "tree (8-bit operands)")
        print(f"{'n_c':>6s} {'tree':>7s} {'serializer':>10s} "
              f"{'accum':>6s} {'serial':>7s} {'verdict':>9s}")
    serial_wins = 0
    for n in CLUSTERS:
        tree_alms = cost_model.alm_adder_tree(n, 8)
        ser = cost_model.alm_serializer(n, 8)
        acc = cost_model.alm_accumulator(n, 8)
        if ser + acc < tree_alms:
            serial_wins += 1
        if verbose:
            print(f"{n:6d} {tree_alms:7d} {ser:10d} {acc:6d} {ser + acc:7d} "
                  f"{'SERIAL' if ser + acc < tree_alms else 'tree':>9s}")

    serial = resolve("serial?chunk=512")
    tree = resolve("tree")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(SHAPE, generator=g, device=dev)
    route = serial.resolve_backend(x)
    got = serial.sum(x, axis=0)
    torch.testing.assert_close(got.double(), x.double().sum(0), rtol=1e-5,
                               atol=1e-4)
    t_serial, clock = time_us(lambda: serial.sum(x, axis=0), dev)
    t_tree, _ = time_us(lambda: tree.sum(x, axis=0), dev)
    t_oneshot, _ = time_us(lambda: torch.sum(x, dim=0), dev)
    n, f = SHAPE
    ws_serial = serial.cost(n, "float32")["working_set_operands"] * f * 4
    ws_tree = tree.cost(n, "float32")["working_set_operands"] * f * 4
    if verbose:
        print(f"# {device} analogue ({route} route, {clock} clock): "
              f"serial?chunk=512 {t_serial:.1f}us, tree {t_tree:.1f}us, "
              f"one-shot torch.sum {t_oneshot:.1f}us; working set "
              f"{ws_serial // 1024}KiB vs {ws_tree // 1024}KiB "
              f"({ws_tree / ws_serial:.0f}x smaller)")
    return {
        "us_per_call": (time.perf_counter() - t0) * 1e6,
        "derived": derived(
            fpga_serial_wins=f"{serial_wins}/{len(CLUSTERS)}(paper:0)",
            tpu_vmem_reduction=f"{ws_tree / ws_serial:.0f}x",
            route=route, serial_us=f"{t_serial:.1f}", tree_us=f"{t_tree:.1f}",
            oneshot_us=f"{t_oneshot:.1f}", clock=clock),
    }
