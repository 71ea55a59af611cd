"""Serving CLI of the port: the continuous-batching engine, dense-slot or
over a paged KV pool (``--paged``), driven by a synthetic Poisson workload,
or the static batch path (``--static``, :func:`serve_batch`: one joint
prefill, then lockstep decode) — the port of ``repro/launch/serve.py``.

  python -m repro_torch.launch.serve --arch llama3-8b --paged \
      --param-dtype bfloat16 --requests 8 --slots 4
  python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
      --param-dtype bfloat16 [--paged]
  python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --param-dtype bfloat16 [--paged]
  python -m repro_torch.launch.serve --arch mamba2-370m \
      --param-dtype bfloat16
  python -m repro_torch.launch.serve --arch llama3-8b --paged \
      --param-dtype bfloat16 --spec-decode --drafter oracle --spec-k 3
  python -m repro_torch.launch.serve --arch llama3-8b --paged \
      --param-dtype bfloat16 --scheduling slo --prefill-chunk 256 \
      --prompt-len 1024 --gen-len 64 --requests 12
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --smoke --paged --device cpu [--spec-decode] [--prefill-chunk 16] \
      [--scheduling slo --dt 1e-3]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --smoke --device cpu --replicas 3 --kill 6:1 --reload-at 10
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --smoke --device cpu --mesh 1x2 [--paged]
  python -m repro_torch.launch.serve --arch llama3-8b --paged \
      --param-dtype bfloat16 --mesh 1x2 --dist-backend gloo --eager
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --smoke --device cpu --static --batch 4 --prompt-len 24 --gen-len 8

Runs on the GPU unless ``--device cpu`` is given. mamba2-370m (the SSM
family) has no K/V cache, so ``--paged`` is refused for it; the SSM and
hybrid families take ``--prefill-chunk`` in multiples of their
``ssd_chunk`` (256). An encoder (hubert-xlarge) has no decode step and
is refused, as the reference refuses it; the engine refuses a VLM, whose
prefill needs a patch batch. ``--layers`` cuts the
depth (``n_layers``) and nothing else. On the GPU the engine replays CUDA
graphs of its decode and padded full-prompt prefill (captured at warmup, or
at the first tick of each bucket with ``--no-warmup``); ``--eager`` runs
every tick eagerly instead. Each request's line and the aggregate give
its strategy-priced FLOPs (``moa_flops``). ``--spec-decode`` drafts
``--spec-k`` tokens a tick with ``--drafter`` and verifies them in one pass
(a ``[serve] spec:`` line); ``--prefill-chunk`` prefills longer prompts in
chunks; ``--scheduling slo`` swaps the workload for a deadline-carrying
bursty one (``--deadline``) and preempts (a ``[serve] slo`` line). ``--dt``
runs the engine on a :class:`repro_torch.serve.StepClock` of that many
virtual seconds a clock read (0, the default: the wall clock).

``--mesh DxM`` (or ``PxDxM``) serves on a device mesh
(:class:`repro_torch.serve.ServeEngine` with ``mesh=``): it starts one
rank a device (:func:`repro_torch.launch.mesh.run_ranks`), each builds
the engine from the same seeded tree and keeps its pieces, and rank 0
prints the results and a ``[serve] mesh:`` line. ``--dist-backend``
picks the process group: NCCL on the GPU and gloo on the CPU by default;
more ranks than cards need ``--dist-backend gloo`` (NCCL refuses two
ranks on one card), and a gloo mesh cannot capture CUDA graphs, so it
needs ``--eager``. ``--replicas`` with ``--mesh`` is refused, as the
reference refuses it.

``--replicas N`` serves through a fault-tolerant replica set of N engines
(:class:`repro_torch.serve.router.ReplicaSet`) on a ``StepClock`` of
``--dt`` seconds (1e-3 unless given): a failure-free fleet, then a chaos
fleet whose replicas crash at the router steps of ``--kill STEP:REPLICA``
and which reloads its weights through a checkpoint saved at
``--reload-at`` (a rolling drain, swap and rejoin). It exits non-zero if a
request is lost, a reload drops a request or never completes, or a greedy
token differs from the failure-free fleet's. ``--replicas -1`` plans the
count from the visible GPUs (:func:`repro_torch.runtime.plan_replicas`).

``--static`` serves ``--batch`` random prompts of ``--prompt-len`` tokens
together through :func:`serve_batch` (no engine, no slots: the fast path
when every request starts at once) and prints the prefill time, the decode
ms a token and tok/s; a VLM, whose prefill needs a patch batch, is
refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.serve import (GREEDY, Sampler, ServeEngine, StepClock,
                               bursty_workload, poisson_workload,
                               resolve_drafter)
from repro_torch.serve.engine import fit_max_len

__all__ = ["serve_batch", "main"]


@torch.no_grad()
def serve_batch(model, params, prompts: dict, *, gen_len: int,
                max_len: int, sampler: Sampler = GREEDY, rng=None):
    """Static-batch serving: one joint prefill of ``prompts`` (``tokens
    (B, S)``), then ``gen_len`` lockstep decode steps against its cache,
    written in place.

    ``sampler`` is the next-token policy of the whole batch; ``rng`` (a
    ``torch.Generator`` on the model's device) is required unless it is
    greedy. Returns ``(tokens (B, gen_len) int32, timings)``: seconds,
    ``per_token_ms`` in milliseconds. On the GPU ``max_len`` must be a
    multiple of 16 where the kernel walks the dense cache
    (:func:`repro_torch.serve.engine.fit_max_len`)."""
    if not sampler.greedy and rng is None:
        raise ValueError("non-greedy sampler needs a torch.Generator")

    def sync(t):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def next_tok(lg):
        return sampler(lg[:, -1], rng)[:, None]

    t0 = time.monotonic()
    logits, cache = model.prefill(params, prompts, max_len=max_len)
    # the decode steps advance one 0-d cursor on the device
    cache["pos"] = torch.as_tensor(cache["pos"], dtype=torch.int32,
                                   device=logits.device)
    sync(logits)
    t_prefill = time.monotonic() - t0

    B = logits.shape[0]
    out_tokens = []
    tok = next_tok(logits)
    t0 = time.monotonic()
    for _ in range(gen_len):
        out_tokens.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
        tok = next_tok(logits)
    sync(tok)
    t_decode = time.monotonic() - t0
    tokens = torch.cat(out_tokens, dim=1).to(torch.int32)
    return tokens, {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": B * gen_len / max(t_decode, 1e-9),
        "per_token_ms": 1e3 * t_decode / max(gen_len, 1),
    }


def _build(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step "
                         "(assignment skip rule)")
    updates = {}
    if args.layers:
        updates["n_layers"] = args.layers
    if args.param_dtype:
        updates["param_dtype"] = args.param_dtype
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    return cfg, build_model(cfg)


def _sampler(args) -> Sampler:
    return GREEDY if args.greedy else Sampler(args.temperature)


def _run_static(args):
    device = resolve_device(args.device)
    cfg, model = _build(args)
    if cfg.family == "vlm":
        raise SystemExit("--static: a VLM's prefill needs a patch batch")
    params = model.init(seed=args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = {"tokens": torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
        device=device, dtype=torch.int32)}
    max_len = fit_max_len(args.prompt_len + args.gen_len + 1,
                          attn_backend=args.attn_backend or cfg.attn_backend,
                          device=device)
    if args.attn_backend:
        model = build_model(dataclasses.replace(
            cfg, attn_backend=args.attn_backend))
    ops.reset_launch_counts()
    tokens, stats = serve_batch(model, params, prompts,
                                gen_len=args.gen_len, max_len=max_len,
                                sampler=_sampler(args), rng=gen)
    print(f"[serve] arch={cfg.name} layers={cfg.n_layers} device={device} "
          f"batch={args.batch} prompt={args.prompt_len} gen={args.gen_len} "
          f"max_len={max_len}")
    print(f"[serve] prefill={stats['prefill_s']*1e3:.0f}ms "
          f"decode={stats['per_token_ms']:.1f}ms/tok "
          f"throughput={stats['decode_tok_per_s']:.1f} tok/s "
          f"launches={ops.launch_counts()}")
    print(f"[serve] sample: {tokens[0, :16].tolist()}")


def _run_engine(args, mesh=None, say=print):
    """One engine over the workload; on a mesh every rank runs this with
    its ``DeviceMesh`` and only rank 0 prints (``say``)."""
    device = resolve_device(args.device)
    cfg, model = _build(args)
    params = model.init(seed=args.seed, device=device)
    spec_margin = args.spec_k if args.spec_decode else 0
    drafter = resolve_drafter(args.drafter, args.spec_k) \
        if args.spec_decode else None
    max_len = fit_max_len(
        args.max_len or (args.prompt_len + args.gen_len + spec_margin + 1) * 2,
        attn_backend=args.attn_backend or cfg.attn_backend, device=device,
        paged=args.paged, block_size=args.block_size, drafter=drafter)
    chunk = args.prefill_chunk or None
    if chunk is not None and args.paged and chunk % args.block_size:
        raise SystemExit(f"--prefill-chunk {chunk} must be a multiple of "
                         f"--block-size {args.block_size}")
    engine = ServeEngine(
        model, params, n_slots=args.slots, max_len=max_len,
        paged=args.paged, block_size=args.block_size,
        n_blocks=args.blocks or None,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        drafter=drafter, prefill_chunk_tokens=chunk,
        scheduling=args.scheduling,
        clock=StepClock(dt=args.dt) if args.dt else time.monotonic,
        attn_backend=args.attn_backend or None, device=device,
        cuda_graphs=False if args.eager else None, mesh=mesh)
    del params          # on a mesh the engine keeps only this rank's pieces
    if args.scheduling == "slo":
        requests = bursty_workload(
            vocab=cfg.vocab, n_long=args.slots,
            n_burst=max(args.requests - args.slots, 1),
            long_prompt_len=args.prompt_len, long_gen_len=args.gen_len,
            burst_prompt_len=max(args.prompt_len // 4, 1),
            burst_gen_len=max(args.gen_len // 4, 1),
            burst_deadline_s=args.deadline, sampler=_sampler(args),
            seed=args.seed)
    else:
        requests = poisson_workload(
            n_requests=args.requests, vocab=cfg.vocab, rate_rps=args.rate,
            prompt_len_range=(min(4, args.prompt_len), args.prompt_len),
            gen_len_range=(min(2, args.gen_len), args.gen_len),
            sampler=_sampler(args), seed=args.seed)
    ops.reset_launch_counts()
    results, report = engine.run(requests, warmup=not args.no_warmup)
    say(f"[serve] arch={cfg.name} layers={cfg.n_layers} "
        f"device={report['device']} slots={args.slots} max_len={max_len} "
        f"requests={args.requests} rate={args.rate}/s")
    mr = report["mesh"]
    if mr is not None:
        axes = ", ".join(f"{a}={n}" for a, n in mr["axes"].items())
        say(f"[serve] mesh: ({axes}) over {mr['ranks']} devices, family "
            f"rules for {mr['family_rules']!r} ({mr['backend']}; split: "
            f"{', '.join(k for k, v in mr['split'].items() if v) or 'none'})")
    for r in results:
        m = r.metrics
        say(f"[serve]   req {r.uid}: slot={r.slot} prompt={r.prompt_len} "
            f"gen={r.tokens.size} ttft={m.ttft_s*1e3:.0f}ms "
            f"{m.per_token_ms:.1f}ms/tok moa_flops={m.moa_flops:.4g} "
            f"({r.finish_reason.value})")
    say("[serve] tokens: " + "; ".join(
        f"{r.uid}:{','.join(str(int(t)) for t in r.tokens)}"
        for r in results))
    say(f"[serve] aggregate: {report['tok_per_s']:.1f} tok/s, "
        f"ttft p50={report['ttft_ms']['p50']:.0f}ms "
        f"p95={report['ttft_ms']['p95']:.0f}ms, "
        f"occupancy={report['slot_occupancy']:.2f}, "
        f"slot_reuse={report['slot_reuse']}, "
        f"warmup={report['compile_s']*1e3:.0f}ms (kept out of wall_s), "
        f"moa_flops={report['moa_flops_total']:.4g}, "
        f"layout={'paged' if args.paged else 'dense-slot'}, "
        f"path={'cuda-graphs' if report['cuda_graphs'] else 'eager'}")
    gr = report["graphs"]
    if gr is not None:
        say(f"[serve] graphs: {gr['graphs']} captured in "
            f"{gr['capture_s']:.2f}s, pool={gr['pool_mb']:.1f}MB, "
            f"replays={gr['replays']}, eager first runs="
            f"{gr['eager_runs']}, launches/replay="
            f"{gr['launches_per_replay']}")
    if args.spec_decode:
        sp = report["spec"]
        say(f"[serve] spec: drafter={args.drafter} k={sp['k']}, "
            f"{sp['tokens_per_step']:.2f} tokens/step "
            f"(plain decode = 1.00), accept rate "
            f"{sp['accept_rate']:.2f}, accepted hist "
            f"{sp['accepted_hist']}, draft steps {sp['draft_steps']}")
    pg = report.get("paged")
    if pg is not None:
        say(_paged_line(pg))
    if "slo" in report:
        sl = report["slo"]
        say(f"[serve] slo ({report['scheduling']}): attainment "
            f"{sl['deadline_met']}/{sl['deadline_requests']} "
            f"({sl['attainment']:.2f}), goodput "
            f"{sl['goodput_tok_per_s']:.1f} tok/s, deadline ttft "
            f"p99={sl['deadline_ttft_ms']['p99']:.0f}ms, "
            f"preemptions={sl['preemptions']} "
            f"(spills={sl['spills']}, revivals={sl['revivals']}), "
            f"chunked ticks={sl['prefill_chunk_count']}")
    say(f"[serve] kernel launches (warmup included): "
        f"{ops.launch_counts()}")


def _parse_kill_schedule(spec: str):
    """``"step:replica,step:replica"`` → {replica: [steps]}."""
    schedule = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        try:
            step_s, rid_s = item.split(":")
            step, rid = int(step_s), int(rid_s)
        except ValueError:
            raise SystemExit(f"--kill: bad entry {item!r}; expected "
                             "STEP:REPLICA, e.g. 6:1")
        schedule.setdefault(rid, []).append(step)
    return schedule


def _run_replicas(args):
    """Replica-set serving on a deterministic StepClock: the chaos smoke
    (the reference's ``_run_replicas``).

    Kills from ``--kill`` are injected through per-replica
    FailureInjectors at the scheduled router steps; ``--reload-at`` saves
    the serving weights as a checkpoint mid-run so the watcher triggers a
    rolling drain → swap → rejoin. Exits non-zero if any request is lost,
    any reload drops an in-flight request, or (greedy) any token stream
    diverges from the failure-free fleet baseline.
    """
    from repro_torch.checkpoint import CheckpointManager, CheckpointWatcher
    from repro_torch.runtime import FailureInjector
    from repro_torch.serve.router import ReplicaSet

    if args.spec_decode or args.scheduling != "fifo":
        raise SystemExit("--replicas drives plain fifo engines tick-by-"
                         "tick; --spec-decode/--scheduling slo are "
                         "single-engine modes")
    device = resolve_device(args.device)
    cfg, model = _build(args)
    params = model.init(seed=args.seed, device=device)
    max_len = fit_max_len(
        args.max_len or (args.prompt_len + args.gen_len + 1) * 2,
        attn_backend=args.attn_backend or cfg.attn_backend, device=device,
        paged=args.paged, block_size=args.block_size)
    sampler = _sampler(args)
    make_workload = lambda: poisson_workload(  # noqa: E731
        n_requests=args.requests, vocab=cfg.vocab, rate_rps=args.rate,
        prompt_len_range=(min(4, args.prompt_len), args.prompt_len),
        gen_len_range=(min(2, args.gen_len), args.gen_len),
        sampler=sampler, seed=args.seed)
    kills = _parse_kill_schedule(args.kill)
    for rid in kills:
        if not 0 <= rid < args.replicas:
            raise SystemExit(f"--kill: replica {rid} out of range "
                             f"(0..{args.replicas - 1})")

    def fleet(chaos: bool, tmpdir):
        clock = StepClock(dt=args.dt or 1e-3)
        factory = lambda: ServeEngine(  # noqa: E731
            model, params, n_slots=args.slots, max_len=max_len,
            paged=args.paged, block_size=args.block_size,
            n_blocks=args.blocks or None,
            generator=torch.Generator(device=device).manual_seed(args.seed),
            clock=clock, attn_backend=args.attn_backend or None,
            device=device, cuda_graphs=False if args.eager else None)
        manager = watcher = None
        actions = {}
        if chaos and args.reload_at:
            manager = CheckpointManager(tmpdir)
            watcher = CheckpointWatcher(manager)
            actions[args.reload_at] = \
                lambda _rs: manager.save(1, params)
        rs = ReplicaSet(
            factory, n_replicas=args.replicas, clock=clock,
            failure_injectors={rid: FailureInjector(steps)
                               for rid, steps in kills.items()}
            if chaos else None,
            watcher=watcher,
            load_params=(lambda step: manager.restore(params)[0])
            if watcher else None)
        results, report = rs.run(make_workload(), actions=actions)
        rs.check()
        return results, report

    with tempfile.TemporaryDirectory() as tmpdir:
        base_results, base_report = fleet(False, tmpdir)
        results, report = fleet(True, tmpdir)
    print(f"[serve] arch={cfg.name} replicas={args.replicas} "
          f"slots={args.slots}/replica max_len={max_len} "
          f"requests={args.requests} rate={args.rate}/s "
          f"dt={args.dt or 1e-3} device={device}")
    print(f"[serve] chaos: kills={report['kills']} (schedule "
          f"{args.kill or 'none'}), deaths detected="
          f"{report['deaths_detected']}, requeues={report['requeues']}, "
          f"requeue latency p95="
          f"{report['requeue_latency_ms']['p95']:.0f}ms")
    print(f"[serve] reload: completed={report['reloads_completed']} "
          f"dropped={report['reload_dropped']} versions="
          f"{[r['param_version'] for r in report['replicas']]}")
    print(f"[serve] fleet: {report['completed']}/{report['requests']} "
          f"requests, {report['tok_per_s']:.1f} tok/s "
          f"(baseline {base_report['tok_per_s']:.1f}), router steps="
          f"{report['router_steps']}")
    failures = []
    if report["lost_requests"]:
        failures.append(f"{report['lost_requests']} requests lost")
    if report["reload_dropped"]:
        failures.append(f"reload dropped {report['reload_dropped']} "
                        "in-flight requests")
    if args.reload_at and not report["reloads_completed"]:
        failures.append("scheduled reload never completed")
    if sampler.greedy:
        diverged = [r.uid for r, b in zip(results, base_results)
                    if not np.array_equal(r.tokens, b.tokens)]
        if diverged:
            failures.append(f"greedy tokens diverged from failure-free "
                            f"baseline for uids {diverged}")
        else:
            print("[serve] greedy tokens bit-identical to failure-free "
                  "baseline")
    if failures:
        raise SystemExit("[serve] FAIL: " + "; ".join(failures))


def _paged_line(pg: dict) -> str:
    return (f"[serve] paged: {pg['n_blocks']}x{pg['block_size']}-token "
            f"blocks, backend={pg['attn_backend']}, "
            f"occupancy={pg['block_occupancy']:.2f}, "
            f"prefix hits={pg['prefix_hits']}/{pg['admissions']}, "
            f"cow={pg['cow_count']}, "
            f"resident={pg['resident_kv_bytes']:,}B "
            f"(dense equiv {pg['dense_equiv_kv_bytes']:,}B), "
            f"kv read/step gathered="
            f"{pg['gathered_kv_bytes_per_step']:,.0f}B "
            f"fused={pg['fused_kv_bytes_per_step']:,.0f}B")


def _mesh_rank(rank: int, args) -> None:
    """One rank of ``--mesh``: its ``DeviceMesh``, then the engine."""
    from repro_torch.launch.mesh import make_mesh, parse_mesh

    mesh = make_mesh(parse_mesh(args.mesh), device=args.device)
    _run_engine(args, mesh=mesh,
                say=print if rank == 0 else (lambda *a, **k: None))


def _run_mesh(args) -> None:
    """``--mesh``: check the request, then run every rank (a rank's
    failure fails the run)."""
    from repro_torch.launch.mesh import parse_mesh, run_ranks

    if args.replicas:
        raise SystemExit("--replicas drives plain fifo engines tick-by-"
                         "tick; --mesh is a single-engine mode")
    try:
        shape = parse_mesh(args.mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")
    device = resolve_device(args.device)
    backend = args.dist_backend \
        or ("nccl" if device.type == "cuda" else "gloo")
    n = math.prod(shape)
    if device.type == "cpu" and backend != "gloo":
        raise SystemExit(f"--dist-backend {backend} needs the GPU; a CPU "
                         "mesh runs over gloo")
    if device.type == "cuda":
        if backend == "nccl" and n > torch.cuda.device_count():
            raise SystemExit(
                f"--mesh {args.mesh} needs {n} ranks and this machine has "
                f"{torch.cuda.device_count()} GPU(s): NCCL refuses two ranks "
                "on one card; pass --dist-backend gloo to share cards")
        if backend == "gloo" and not args.eager:
            raise SystemExit("a gloo mesh cannot capture its collectives "
                             "in CUDA graphs: add --eager")
    run_ranks(shape, _mesh_rank, args, backend=backend,
              threads=1 if device.type == "cpu" else 0)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a registry arch through the port's "
                    "continuous-batching engine, or --static lockstep batch")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced CPU-runnable config")
    ap.add_argument("--static", action="store_true",
                    help="static-batch serve_batch path: one joint "
                         "prefill, then lockstep decode")
    ap.add_argument("--batch", type=int, default=4,
                    help="[--static] batch size")
    ap.add_argument("--layers", type=int, default=0,
                    help="override n_layers (depth only; 0 = the config's)")
    ap.add_argument("--param-dtype", default="",
                    choices=("", "float32", "bfloat16"),
                    help="stored weight type (default: the config's, "
                         "float32; bfloat16 halves a full-width model and "
                         "makes the cast at use a no-op)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the CPU "
                         "runs the plain PyTorch versions of the kernels)")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="upper bound of the prompt-length range, tokens")
    ap.add_argument("--gen-len", type=int, default=32,
                    help="upper bound of the generation-length range")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of workload requests")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (in-flight requests)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-slot context capacity, tokens (rounded up to "
                         "whole KV blocks, and on the GPU a dense-slot "
                         "cache to whole 16-token pages)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: shared block pool with "
                         "ref-counted prefix caching (default: dense-slot, "
                         "max_len tokens reserved a slot)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per physical KV page")
    ap.add_argument("--blocks", type=int, default=0,
                    help="pool size in pages (0 = dense equivalent "
                         "slots*max_len/block_size)")
    ap.add_argument("--attn-backend", default="",
                    choices=("", "auto", "torch", "kernel"),
                    help="attention backend: kernel (the CUDA kernels), "
                         "torch (plain PyTorch), auto (kernel on the GPU). "
                         "Default: the config's (auto)")
    ap.add_argument("--eager", action="store_true",
                    help="run every tick eagerly (no CUDA graphs; the CPU "
                         "always does)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the unmeasured warmup tick (one-time costs "
                         "then land in wall_s instead of compile_s)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: draft k tokens a tick, "
                         "verify them in one pass")
    ap.add_argument("--drafter", default="ngram?n=3",
                    help="[--spec-decode] drafter spec: ngram[?n=N] "
                         "(prompt lookup) or oracle[?accept=P] (the target "
                         "drafting for itself, a forced accept rate)")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="[--spec-decode] draft tokens per verify window")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill prompts longer than this in chunks of "
                         "this many tokens, interleaved with decode ticks "
                         "(0 = one shot; see repro_torch.launch.costing."
                         "prefill_chunk_guidance)")
    ap.add_argument("--scheduling", choices=["fifo", "slo"], default="fifo",
                    help="admission policy: fifo (arrival order) or slo "
                         "(priority + earliest TTFT deadline, with "
                         "preemption). slo swaps the workload for a "
                         "deadline-carrying bursty one")
    ap.add_argument("--deadline", type=float, default=0.25,
                    help="[--scheduling slo] burst requests' TTFT deadline, "
                         "seconds after arrival")
    ap.add_argument("--dt", type=float, default=0.0,
                    help="run the engine on a StepClock of this many "
                         "virtual seconds a clock read (deterministic "
                         "schedules); 0 = the wall clock (--replicas: "
                         "1e-3)")
    ap.add_argument("--mesh", default="",
                    help="serve on a DxM (or PxDxM) device mesh, one rank "
                         "a device: heads, ff, experts and vocab over "
                         "model, slots over data (the family's rules)")
    ap.add_argument("--dist-backend", default="", choices=("", "nccl",
                                                           "gloo"),
                    help="[--mesh] process-group backend (default: nccl on "
                         "the GPU, gloo on the CPU; gloo lets ranks share "
                         "a card)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through a fault-tolerant replica set of N "
                         "engines on a deterministic StepClock; 0 = one "
                         "engine, -1 = plan from the visible GPU count "
                         "(repro_torch.runtime.plan_replicas)")
    ap.add_argument("--kill", default="",
                    help="[--replicas] chaos schedule STEP:REPLICA[,...]: "
                         "each entry crashes that replica at that router "
                         "step through a FailureInjector; its requests "
                         "requeue after heartbeat detection")
    ap.add_argument("--reload-at", type=int, default=0,
                    help="[--replicas] router step at which to save the "
                         "weights as a checkpoint, triggering a rolling "
                         "watcher-driven reload (0 = no reload)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--greedy", action="store_true",
                    help="force greedy decode regardless of --temperature")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh:
        _run_mesh(args)
        return
    if args.replicas == -1:
        from repro_torch.runtime import plan_replicas
        device = resolve_device(args.device)
        args.replicas = plan_replicas(
            torch.cuda.device_count() if device.type == "cuda" else 1)
    if args.replicas:
        _run_replicas(args)
    elif args.static:
        _run_static(args)
    else:
        _run_engine(args)


if __name__ == "__main__":
    main()
