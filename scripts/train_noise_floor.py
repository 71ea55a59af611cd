#!/usr/bin/env python3
"""How far apart do a hybrid's gradients drift from rounding alone, and
what does a wrong ``dot_moa`` read there?

    python3 scripts/train_noise_floor.py [--arch zamba2-1.2b]
        [--layers 6 38] [--smoke --device cpu]

One train step's gradients of ``--arch`` at full width (f32 master
weights from seed 0, bf16 compute, remat "full", 8 x 512 tokens of
``SyntheticLMData`` seed 0) at each depth of ``--layers``, on the plain
route (``backend=torch``) and on four others, each read as every leaf's
relative error (Frobenius) against the plain route's:

* ``kernel``: the ``dot_moa`` kernel, the route ``chip_smoke.py`` holds
  to the plain one;
* ``floor``: the plain route with each product's K summed in chunks of
  ``TRAIN_FLOOR_CHUNK`` (4096 on the plain route): rounding alone, the
  noise floor ``chip_smoke.py``'s ``TRAIN_FLOOR_RATIO`` is set against;
* ``bf16_slices``: a deliberately wrong kernel, put in by a wrapper (no
  code is edited): four K slices through the kernel, each rounded to bf16
  and summed in bf16, about twice a right kernel's error a product;
* ``drop_tile``: a deliberately wrong kernel that never reads the last
  64 of K.

One JSON line a depth: each route's loss difference, worst leaf, worst
shared-block leaf and every leaf's error. On the CPU (``--smoke --device
cpu``) every route but ``floor`` is the plain one. It imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.moa import backends  # noqa: E402

BATCH, SEQ = 8, 512


def bf16_slices(real):
    def dot(a, b, *, block_k, out_dtype, approx_bits=0):
        k, acc = a.shape[-1], None
        for s in range(0, k, k // 4):
            y = real(a[..., s:s + k // 4], b[s:s + k // 4], block_k=block_k,
                     out_dtype=torch.bfloat16)
            acc = y if acc is None else acc + y
        return acc.to(out_dtype)
    return dot


def drop_tile(real):
    def dot(a, b, *, block_k, out_dtype, approx_bits=0):
        return real(a[..., :-64], b[:-64], block_k=block_k,
                    out_dtype=out_dtype)
    return dot


def _worst(errs: dict) -> list:
    if not errs:
        return [None, None]
    k = max(errs, key=errs.get)
    return [k, errs[k]]


def depth(cfg, device: str, seq: int, batch: int) -> dict:
    """Every route's gradient errors against the plain route's at
    ``cfg``'s depth."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps
    from repro_torch.models.api import build_model

    hyper = steps.TrainHyper(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           seed=0, family="lm", d_model=cfg.d_model,
                           n_patches=cfg.n_patches)
    batch = {k: v.to(device) for k, v in data.batch_for_step(0).items()}
    params = steps.init_train_state(build_model(cfg), hyper=hyper, seed=0,
                                    device=device)["params"]
    plain = chip_smoke._plain_cfg(cfg)
    g_p, m_p = steps.loss_and_grads(build_model(plain), params, batch)
    floor = dataclasses.replace(plain, moa=plain.moa.replace(
        "chunk=4096", f"chunk={chip_smoke.TRAIN_FLOOR_CHUNK}"))
    real = backends.kernel_dot
    routes = {"kernel": (cfg, None), "floor": (floor, None),
              "bf16_slices": (cfg, bf16_slices(real)),
              "drop_tile": (cfg, drop_tile(real))}
    out = {"arch": cfg.name, "layers": cfg.n_layers}
    for name, (c, wrong) in routes.items():
        if wrong is not None:
            backends.kernel_dot = wrong
        try:
            g, m = steps.loss_and_grads(build_model(c), params, batch)
        finally:
            backends.kernel_dot = real
        errs = chip_smoke._grad_errors(torch, g, g_p)
        out[name] = {
            "moa": c.moa,
            "loss_diff": abs(float(m["loss"]) - float(m_p["loss"])),
            "worst": _worst(errs),
            "worst_shared": _worst({k: v for k, v in errs.items()
                                    if k.startswith("shared")}),
            "errs": errs}
        del g
        gc.collect()
    return out


def main() -> int:
    from repro_torch.configs.registry import get_config, smoke_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--layers", type=int, nargs="+", default=[6, 38])
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config, 2 x 32 tokens")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config(args.arch)
    seq, batch = SEQ, BATCH
    if args.smoke:
        base, seq, batch = smoke_config(base), 32, 2
    if args.device == "cuda":
        from repro_torch.kernels import _build
        _build.build(["dot_moa"])
        print(chip_smoke.nvidia_smi(), flush=True)
    for n in args.layers:
        cfg = dataclasses.replace(base, n_layers=n)
        print(json.dumps(depth(cfg, args.device, seq, batch)), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
