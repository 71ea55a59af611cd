#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--log PATH]

``--log`` also appends every JSON line to a file.

Phases, in order; each prints JSON lines and any failure ends the run with
a non-zero exit:

1. build    — compile the three CUDA kernels from ``src/repro_torch/
              kernels/csrc`` with nvcc for sm_90a (one nvcc per source, all
              at once); print the card's name and power limit.
2. kernels  — each kernel against its plain PyTorch version on the card, at
              the served model's full-width shapes plus ragged edge cases:
              error against a stated tolerance, and the kernel's, the plain
              version's and (where one PyTorch call computes the same
              function) the library call's time, beside the least time the
              card could take (``bound_ms``).
3. serve    — llama3-8b at full width and full depth (bf16 weights from
              the port's own initializer, seed 0) served through the
              paged engine: 8 Poisson requests into 4 slots. Every kernel
              must have been launched by that run. Then the same workload
              is served again, by a fresh engine (an empty prefix cache),
              with each tick under torch.profiler: device
              time by kernel of the decode and admission ticks, against
              the host clock.
4. parity   — the same engine at full width with 2 layers, once on the
              kernels and once on the plain PyTorch path: float32 compute
              on the f32 and int8 KV pools, bf16 compute on the bf16 pool.
              Greedy tokens must agree (a divergence passes only at a
              near-tie of the top-2 logits).

The last lines are the kernel summary (JSON), the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``. Without a GPU, or
without the rest of the repository beside it, the script exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: operations/s by operand type (f32 is the CUDA-core rate)
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}

#: TPU kernel each port replaces (the function that reaches pl.pallas_call)
REPLACES = {
    "dot_moa": "src/repro/kernels/dot_moa.py:71",
    "flash_attention": "src/repro/kernels/flash_attention.py:86",
    "paged_attention": "src/repro/kernels/paged_attention.py:119",
}

_LOG = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _LOG is not None:
        _LOG.write(line + "\n")
        _LOG.flush()


def bound(nbytes: float, ops: float, dtype: str):
    """Least time (ms) for the work: bytes over HBM rate vs operations over
    the type's peak, whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / PEAK_OPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude ``x`` (8 significant
    bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


class Timer:
    """Median device time of single launches, each after a write of 64 MiB
    that evicts the 50 MB L2 (the served model streams ~14 GB of weights
    per decode step, so its kernels find their operands cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check(row: dict) -> dict:
    emit(dict({"phase": "kernels"}, **row))
    if not row["max_abs_err"] <= row["tol"]:
        raise AssertionError(f"{row['kernel']} {row['case']}: max_abs_err "
                             f"{row['max_abs_err']} > tol {row['tol']}")
    return row


def kernel_phase(torch, timer):
    from repro_torch.kernels import dot_moa as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    F = torch.nn.functional
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}        # kernel -> the row at the served model's main shape

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dtype)

    def randint8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int32).to(torch.int8)

    def err(got, want):
        return float((got.double() - want.double()).abs().max())

    # ---- dot_moa: every projection of the served model -------------------
    block_k = 2048                # min(chunk=4096, the Pallas cap 2048)
    cases = [(m, k, n, block_k, torch.bfloat16, 0)
             for m in (4, 64)
             for k, n in ((4096, 6144), (4096, 4096), (4096, 1024),
                          (4096, 14336), (14336, 4096))]
    cases += [(64, k, n, block_k, torch.int8, l)
              for l in (0, 4)
              for k, n in ((4096, 6144), (4096, 4096), (4096, 14336),
                           (14336, 4096))]
    cases += [(37, 1000, 333, 256, torch.float32, 0),
              (37, 1000, 333, 256, torch.bfloat16, 0),
              (37, 1000, 333, 256, torch.int8, 0),
              (37, 1024, 333, 256, torch.int8, 4)]
    for m, k, n, bk, dt, l in cases:
        if dt == torch.int8:
            a, b = randint8(m, k), randint8(k, n)
        else:
            a, b = randn(m, k, dtype=dt), randn(k, n, scale=k ** -0.5,
                                                dtype=dt)
        run = lambda: dm.dot_moa_cuda(a, b, block_k=bk, approx_bits=l)
        plain = lambda: ref.dot_moa_ref(a, b, block_k=bk, approx_bits=l)
        got, want = run(), plain()
        torch.cuda.synchronize()
        item = a.element_size()
        name = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.int8: "int8"}[dt]
        b_ms, b_by = bound((m * k + k * n) * item + m * n
                           * got.element_size(), 2.0 * m * k * n, name)
        if dt == torch.int8:
            tol, why = 0.0, ("integer accumulation is exact: int32 K-block "
                             "partials, folded by + or the LOA combine")
        elif dt == torch.bfloat16:
            tol = bf16_ulp(float(want.float().abs().max()))
            why = ("1 bf16 ulp at max|ref|: both accumulate in f32 in "
                   "different orders, then round once to bf16")
        else:
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            why = "f32 reassociation of the K sum, relative 1e-5"
        # the library call that computes the same function: torch.matmul
        # for floats; for exact int8 (l=0) torch._int_mm, an int32 product
        # (needs m > 16 and k, n multiples of 8); none for LOA
        library = None
        if dt != torch.int8:
            library = lambda: torch.matmul(a, b)
        elif l == 0 and m > 16 and k % 8 == 0 and n % 8 == 0:
            library = lambda: torch._int_mm(a, b)
            if not torch.equal(library(), want):
                raise AssertionError(f"torch._int_mm != dot_moa_ref at "
                                     f"{m}x{k}x{n}")
        row = check({
            "kernel": "dot_moa", "case": f"{name} l={l}",
            "shape": {"m": m, "k": k, "n": n, "block_k": bk},
            "max_abs_err": err(got, want), "tol": tol, "tol_reason": why,
            "kernel_ms": timer(run), "plain_ms": timer(plain, 5),
            "library_ms": timer(library) if library else None,
            "bound_ms": b_ms, "bound_by": b_by,
        })
        if (m, k, n, dt) == (4, 4096, 14336, torch.bfloat16):
            summary["dot_moa"] = row          # decode's w_gate / w_up

    # ---- flash attention: prefill's causal softmax·V ----------------------
    cases = [(1, 64, 64, 32, 8, 128, torch.bfloat16, True),
             (1, 512, 512, 32, 8, 128, torch.bfloat16, True),
             (2, 100, 100, 4, 2, 64, torch.float32, True),
             (2, 37, 53, 4, 2, 64, torch.float32, False)]
    for B, Sq, Skv, H, Hk, D, dt, causal in cases:
        q = randn(B, Sq, H, D, dtype=dt)
        k, v = randn(B, Skv, Hk, D, dtype=dt), randn(B, Skv, Hk, D, dtype=dt)
        run = lambda: fa.flash_attention_cuda(q, k, v, causal=causal)
        plain = lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                q_chunk=256, kv_chunk=512)
        got, want = run(), plain()
        torch.cuda.synchronize()
        pairs = (Sq * (Sq + 1) // 2) if causal else Sq * Skv
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        b_ms, b_by = bound((2 * B * Sq * H + 2 * B * Skv * Hk) * D
                           * q.element_size(), 4.0 * B * H * D * pairs, name)
        if dt == torch.bfloat16:
            tol = bf16_ulp(float(want.float().abs().max()))
            why = ("1 bf16 ulp at max|ref|: f32 online softmax in both, "
                   "other tile orders, one rounding to bf16")
        else:
            tol, why = 1e-5, "f32 reassociation of dot products and sums"
        lib = None
        if causal and dt == torch.bfloat16:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        row = check({
            "kernel": "flash_attention",
            "case": f"{name} {'causal' if causal else 'full'}",
            "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hk": Hk,
                      "D": D},
            "max_abs_err": err(got, want), "tol": tol, "tol_reason": why,
            "kernel_ms": timer(run), "plain_ms": timer(plain, 5),
            "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
        })
        if Sq == 512:
            summary["flash_attention"] = row

    # ---- paged attention: decode over block tables ------------------------
    cases = [(4, 1, 32, 8, 128, 16, (5, 70, 200, 511), torch.bfloat16,
              torch.bfloat16),
             (4, 1, 32, 8, 128, 16, (5, 70, 200, 511), torch.bfloat16,
              torch.int8),
             (4, 4, 4, 2, 64, 16, (0, 13, 40, 60), torch.float32,
              torch.float32)]
    for B, T, H, Hk, D, bs, starts, qdt, pdt in cases:
        n_blocks = (max(starts) + T - 1) // bs + 1
        n_blocks = 1 << (n_blocks - 1).bit_length()   # a live-block bucket
        n_phys = 2 + B * n_blocks       # trash page 0, poison page last
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        tables = torch.zeros((B, n_blocks), dtype=torch.int32, device=dev)
        for i, s in enumerate(starts):
            live = (s + T - 1) // bs + 1
            tables[i, :live] = 1 + i * n_blocks + torch.arange(live,
                                                               device=dev)
        q = randn(B, T, H, D, dtype=qdt)
        scales = {}
        if pdt == torch.int8:
            kp, vp = randint8(n_phys, bs, Hk, D), randint8(n_phys, bs, Hk, D)
            scales = {"k_scale": torch.rand((n_phys, bs, Hk), device=dev,
                                            generator=g) * 0.02,
                      "v_scale": torch.rand((n_phys, bs, Hk), device=dev,
                                            generator=g) * 0.02}
        else:
            kp, vp = randn(n_phys, bs, Hk, D, dtype=pdt), \
                randn(n_phys, bs, Hk, D, dtype=pdt)
        run = lambda: pa.paged_attention_cuda(q, kp, vp, tables, start,
                                              dequant_dtype=qdt, **scales)
        plain = lambda: ref.paged_attention_ref(q, kp, vp, tables, start,
                                                dequant_dtype=qdt, **scales)
        got, want = run(), plain()
        # pages past a slot's deepest query must never be read: point the
        # dead table entries at a page of NaNs and expect the same bits
        if pdt != torch.int8:
            kp[-1], vp[-1] = float("nan"), float("nan")
            poisoned = torch.where(tables == 0, n_phys - 1, tables)
            if not torch.equal(pa.paged_attention_cuda(q, kp, vp, poisoned,
                                                       start), got):
                raise AssertionError("paged_attention read a dead page")
        torch.cuda.synchronize()
        tokens = sum(s + T for s in starts)
        kv_bytes = tokens * Hk * D * 2 * kp.element_size() + (
            tokens * Hk * 2 * 4 if scales else 0)
        ops = sum(4.0 * H * D * (s + t + 1) for s in starts for t in range(T))
        name = "float32" if qdt == torch.float32 else "bfloat16"
        b_ms, b_by = bound(kv_bytes + 2 * q.numel() * q.element_size()
                           + tables.numel() * 4 + B * 4, ops, name)
        if qdt == torch.bfloat16:
            tol = bf16_ulp(float(want.float().abs().max()))
            why = ("1 bf16 ulp at max|ref|: the same dequantized KV, f32 "
                   "online vs one-shot softmax, one rounding to bf16")
        else:
            tol, why = 1e-5, "f32 online vs one-shot softmax reassociation"
        row = check({
            "kernel": "paged_attention",
            "case": f"pool={str(pdt)[6:]} T={T}",
            "shape": {"B": B, "T": T, "H": H, "Hk": Hk, "D": D, "bs": bs,
                      "n_blocks": n_blocks, "start": list(starts)},
            "max_abs_err": err(got, want), "tol": tol, "tol_reason": why,
            "kernel_ms": timer(run), "plain_ms": timer(plain, 5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        })
        if pdt == torch.bfloat16:
            summary["paged_attention"] = row
    return summary


# ---------------------------------------------------------------------------
# phases 3 and 4: the served model
# ---------------------------------------------------------------------------


def profile_served(torch, engine, requests) -> None:
    """Device time by kernel of the ticks of a served run, each tick under
    its own ``torch.profiler``, against the host clock.

    The run serves ``requests`` again through the tick-level API, so every
    decode tick attends over the depths the workload really reaches. Ticks
    fall into two classes: decode only, and admission (one or more
    prefills, then the decode step). Each class prints one line with its
    mean per tick: host time, kernel time, idle share, the ten heaviest
    kernels, and for decode the attended KV lengths (``prompt + generated``
    per live slot) and live-block buckets. The profiler's own launch
    overhead is inside the host time; its setup and read-out are not."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    classes = {}
    engine.start_run()
    for r in requests:
        engine.submit(r)
    results = []
    while not engine.scheduler.done:
        before = {s: inf.metrics.prompt_tokens + len(inf.generated)
                  for s, inf in engine._inflight.items()}
        hw = engine._live_blocks(1)
        admissions = engine._admissions
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            engine.tick(results)
            torch.cuda.synchronize()
            host_ms = (time.monotonic() - t0) * 1e3
        admitted = engine._admissions - admissions
        c = classes.setdefault("admission" if admitted else "decode", {
            "ticks": 0, "host_ms": 0.0, "device_ms": 0.0, "kernels": {},
            "kv_lens": [], "live_blocks": set(), "live_slots": 0,
            "prefills": 0})
        c["ticks"] += 1
        c["host_ms"] += host_ms
        c["prefills"] += admitted
        if not admitted:
            c["kv_lens"] += before.values()
            c["live_blocks"].add(hw)
            c["live_slots"] += len(before)
        # kernel events only: a CPU op's device time repeats its kernels'
        for e in prof.key_averages():
            if e.device_type == cuda:
                ms, n = c["kernels"].get(e.key, (0.0, 0))
                c["kernels"][e.key] = (ms + e.device_time_total / 1e3,
                                       n + e.count)
                c["device_ms"] += e.device_time_total / 1e3
    engine.finish_run(results)
    for what, c in classes.items():
        n = c["ticks"]
        rows = sorted(c["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
        line = {"phase": "profile", "what": f"served {what} ticks",
                "ticks": n, "prefills": c["prefills"],
                "prefix_hits": engine._prefix_hits,
                "host_ms": c["host_ms"] / n, "device_ms": c["device_ms"] / n,
                "device_idle_share": max(0.0, 1.0 - c["device_ms"]
                                         / c["host_ms"]),
                "top": [{"name": k[:80], "ms": ms / n, "calls": cnt / n}
                        for k, (ms, cnt) in rows]}
        if what == "decode":
            line.update(kv_len_min=min(c["kv_lens"]),
                        kv_len_max=max(c["kv_lens"]),
                        kv_len_mean=statistics.mean(c["kv_lens"]),
                        live_slots_mean=c["live_slots"] / n,
                        live_blocks=sorted(c["live_blocks"]))
        emit(line)


def serve_phase(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine, poisson_workload

    cfg = dataclasses.replace(get_config("llama3-8b"),
                              param_dtype="bfloat16")
    t0 = time.monotonic()
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    engine = ServeEngine(model, params, n_slots=4, max_len=96, paged=True,
                         block_size=16, device="cuda")
    _, warm = engine.run([], warmup=True)
    def workload():
        return poisson_workload(n_requests=8, vocab=cfg.vocab, rate_rps=50.0,
                                prompt_len_range=(16, 64),
                                gen_len_range=(8, 16), seed=0)
    requests = workload()
    ops.reset_launch_counts()
    results, report = engine.run(requests)
    launches = ops.launch_counts()
    for req, r in zip(requests, results):
        if r.tokens.shape != (req.max_new_tokens,) or not (
                (r.tokens >= 0) & (r.tokens < cfg.vocab)).all():
            raise AssertionError(f"request {r.uid}: bad tokens {r.tokens}")
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "param_dtype": cfg.param_dtype,
          "n_params": model.param_count(), "init_s": init_s,
          "warmup_s": warm["compile_s"], "device": report["device"],
          "tok_per_s": report["tok_per_s"], "wall_s": report["wall_s"],
          "ttft_ms": report["ttft_ms"], "per_token_ms": report["per_token_ms"],
          "decode_steps": report["decode_steps"],
          "total_new_tokens": report["total_new_tokens"],
          "slot_occupancy": report["slot_occupancy"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "paged": report["paged"], "launches": launches,
          "tokens": {r.uid: r.tokens.tolist() for r in results}})
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the served run launched no {missing}")
    # a fresh engine: the first one's prefix cache holds every prompt of
    # the workload, which would turn the profiled prefills into prefix hits
    del engine
    engine = ServeEngine(model, params, n_slots=4, max_len=96, paged=True,
                         block_size=16, device="cuda")
    engine.run([], warmup=True)
    profile_served(torch, engine, workload())
    return launches


def _greedy_gap(torch, model, params, prompt, generated) -> float:
    """Top-2 logit gap of the plain path's next-token logits after
    ``prompt + generated`` (full causal forward)."""
    toks = torch.tensor([list(prompt) + list(generated)], device="cuda")
    with torch.no_grad():
        logits = model.forward(params, {"tokens": toks})[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def parity_phase(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serve import (ServeEngine, poisson_workload,
                                   shared_prefix_workload)

    #: pool -> (compute type, KV cache type, near-tie bound). A divergence
    #: passes only if the plain path's top-2 logits are closer than the
    #: bound. float32: kernel and plain differ by f32 reassociation (~1e-5
    #: relative after 2 layers) and the logits are O(1). bfloat16: each
    #: projection's output may round one bf16 ulp apart (the kernels
    #: phase's bound), and a few ulps of the hidden state through the
    #: unembedding move a logit by ~0.01 -- the CPU tests' 0.05 bound.
    #: (Under float32 compute the reference keeps a non-int8 pool in the
    #: compute type, so the bf16 pool needs bf16 compute.)
    pools = {"f32": ("float32", "bfloat16", 1e-3),
             "int8": ("float32", "int8", 1e-3),
             "bf16": ("bfloat16", "bfloat16", 0.05)}
    for pool, (compute, kv, gap_tol) in pools.items():
        cfg = dataclasses.replace(
            get_config("llama3-8b"), n_layers=2, compute_dtype=compute,
            kv_cache_dtype=kv)
        params = build_model(cfg).init(seed=0, device="cuda")
        plain_cfg = dataclasses.replace(cfg, moa="serial?backend=torch&"
                                        "chunk=4096", attn_backend="torch")
        for wl in ("poisson", "shared_prefix"):
            def workload():
                if wl == "poisson":
                    return poisson_workload(
                        n_requests=6, vocab=cfg.vocab, rate_rps=50.0,
                        prompt_len_range=(16, 64), gen_len_range=(8, 16),
                        seed=1)
                return shared_prefix_workload(
                    n_requests=6, vocab=cfg.vocab, rate_rps=50.0,
                    n_prefixes=2, prefix_len=32, suffix_len_range=(1, 16),
                    gen_len_range=(8, 16), seed=2)
            runs = {}
            for path, c in (("kernel", cfg), ("torch", plain_cfg)):
                engine = ServeEngine(build_model(c), params, n_slots=4,
                                     max_len=96, paged=True, block_size=16,
                                     device="cuda")
                ops.reset_launch_counts()
                runs[path] = engine.run(workload())
                counts = ops.launch_counts()
                if (path == "kernel") != all(counts.values()) or (
                        path == "torch" and any(counts.values())):
                    raise AssertionError(f"{path} path launches: {counts}")
            divergences = []
            for req, a, b in zip(workload(), runs["torch"][0],
                                 runs["kernel"][0]):
                if a.tokens.tolist() == b.tokens.tolist():
                    continue
                i = next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens))
                         if x != y)
                gap = _greedy_gap(torch, build_model(plain_cfg), params,
                                  req.prompt, a.tokens[:i])
                divergences.append({"uid": a.uid, "index": i, "gap": gap})
                if gap > gap_tol:
                    raise AssertionError(
                        f"parity {pool}/{wl}: uid {a.uid} diverges at token "
                        f"{i} with top-2 gap {gap} > {gap_tol}")
            emit({"phase": "parity", "pool": pool, "workload": wl,
                  "n_layers": 2, "compute_dtype": compute,
                  "requests": len(runs["torch"][0]),
                  "identical": not divergences, "divergences": divergences,
                  "gap_tol": gap_tol,
                  "prefix_hits": runs["kernel"][1]["paged"]["prefix_hits"]})
        del params
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


def main() -> int:
    global _LOG
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log", default="",
                    help="also append every JSON line to this file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs on the "
              "GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import _build, ops
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        _LOG = open(args.log, "a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    built = _build.build()
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernels": {name: {"seconds": b["seconds"], "cached": b["cached"],
                             "ptxas": [ln.strip() for ln in
                                       b["log"].splitlines()
                                       if "Used" in ln]}
                      for name, b in built.items()}})

    timer = Timer(torch)
    rows = kernel_phase(torch, timer)
    launches = serve_phase(torch)
    parity_phase(torch)

    sources = {"dot_moa": "src/repro_torch/kernels/csrc/dot_moa.cu",
               "flash_attention":
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
               "paged_attention":
                   "src/repro_torch/kernels/csrc/paged_attention.cu"}
    summary = []
    for name, row in rows.items():
        summary.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "case": row["case"]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    if _LOG is not None:
        _LOG.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
