"""Per-request and aggregate serving metrics (copied from
``repro/serve/metrics.py``).

Units: times in **seconds** on the engine clock unless a key says ``_ms``
(milliseconds); rates in **tokens per second**; ``moa_flops`` in FLOPs as
priced by :func:`repro_torch.launch.costing.request_decode_cost` (or, for
a speculative run, ``spec_request_decode_cost``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = ["RequestMetrics", "aggregate", "paged_report", "slo_report",
           "spec_report"]


@dataclasses.dataclass
class RequestMetrics:
    """Lifecycle timestamps and derived latencies for one request.

    ``arrival_s <= admitted_s <= first_token_s <= finished_s``; the gap
    ``admitted_s - arrival_s`` is queueing delay (all slots busy), and
    ``first_token_s - admitted_s`` is the prefill time.
    """

    arrival_s: float
    admitted_s: float = 0.0
    first_token_s: float = 0.0
    finished_s: float = 0.0
    prompt_tokens: int = 0
    new_tokens: int = 0
    #: strategy-priced FLOPs of the request's decode steps (set when the
    #: engine finishes its run)
    moa_flops: float = 0.0
    #: prompt tokens whose prefill compute was skipped via a prefix-cache
    #: hit (paged engine, dense family; 0 elsewhere)
    cached_prompt_tokens: int = 0
    #: absolute engine-clock TTFT deadline copied from the request (None =
    #: no SLO on this request)
    deadline_s: Optional[float] = None
    #: times this request was preempted (slot taken away mid-generation
    #: and later revived; 0 under the FIFO policy)
    preempted: int = 0
    #: prefill chunks this request's prompt was split into (1 = one-shot)
    prefill_chunks: int = 1

    @property
    def ttft_s(self) -> float:
        """Time to first token: arrival → prefill logits ready (seconds)."""
        return self.first_token_s - self.arrival_s

    @property
    def decode_s(self) -> float:
        """Time spent in the decode loop after the first token (seconds)."""
        return self.finished_s - self.first_token_s

    @property
    def per_token_ms(self) -> float:
        """Mean decode latency per generated token (milliseconds).

        The first token is priced by ``ttft_s``, so this averages over the
        remaining ``new_tokens - 1`` decode steps.
        """
        steps = max(self.new_tokens - 1, 1)
        return 1e3 * self.decode_s / steps

    @property
    def tok_per_s(self) -> float:
        """Request-level generation rate over its full lifetime."""
        lifetime = max(self.finished_s - self.arrival_s, 1e-9)
        return self.new_tokens / lifetime

    @property
    def deadline_met(self) -> Optional[bool]:
        """True iff the first token beat the TTFT deadline (None when the
        request carries no deadline). Both sides are absolute engine-clock
        seconds, so queueing delay counts against the SLO."""
        if self.deadline_s is None:
            return None
        return self.first_token_s <= self.deadline_s

    def to_json(self) -> dict:
        out = {
            "arrival_s": self.arrival_s,
            "admitted_s": self.admitted_s,
            "ttft_ms": 1e3 * self.ttft_s,
            "per_token_ms": self.per_token_ms,
            "tok_per_s": self.tok_per_s,
            "moa_flops": self.moa_flops,
            "cached_prompt_tokens": self.cached_prompt_tokens,
            "preempted": self.preempted,
            "prefill_chunks": self.prefill_chunks,
        }
        if self.deadline_s is not None:
            out["deadline_s"] = self.deadline_s
            out["deadline_met"] = bool(self.deadline_met)
        return out


def _dist(values: List[float]) -> Dict[str, float]:
    """mean/p50/p95/p99 summary of a latency list (empty → zeros)."""
    if not values:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(values, np.float64)
    return {"mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99))}


def aggregate(results, *, n_slots: int, decode_steps: int,
              occupancy_sum: float, wall_s: float,
              compile_s: float = 0.0) -> dict:
    """Fleet-level summary over completed requests.

    ``occupancy_sum`` is the sum over decode steps of
    ``active_slots / n_slots``; divided by ``decode_steps`` it gives mean
    slot occupancy in [0, 1]. ``wall_s`` is total engine run time in
    seconds. ``compile_s`` is the time the engine's warmup tick took
    *before* the clock started (``ServeEngine.run(warmup=True)``: kernel
    builds, CUDA context, library handles, graph captures) — reported
    separately so it can never fold into ``wall_s`` and skew
    ``tok_per_s`` / TTFT.
    """
    total_new = sum(r.metrics.new_tokens for r in results)
    return {
        "n_requests": len(results),
        "n_slots": n_slots,
        "decode_steps": decode_steps,
        "wall_s": wall_s,
        "compile_s": compile_s,
        "total_new_tokens": total_new,
        "tok_per_s": total_new / max(wall_s, 1e-9),
        "ttft_ms": _dist([1e3 * r.metrics.ttft_s for r in results]),
        "per_token_ms": _dist([r.metrics.per_token_ms for r in results]),
        "slot_occupancy": occupancy_sum / max(decode_steps, 1),
        "moa_flops_total": sum(r.metrics.moa_flops for r in results),
    }


def paged_report(*, spec, n_slots: int, max_len: int, block_size: int,
                 n_blocks: int, admissions: int, prefix_hits: int,
                 shared_block_hits: int, cow_count: int,
                 block_occ_sum: float, decode_steps: int,
                 peak_blocks: int, attn_backend: str = "torch",
                 gathered_kv_bytes: int = 0,
                 fused_kv_bytes: int = 0) -> dict:
    """Paged-pool sub-report for the engine's aggregate.

    ``block_occupancy`` averages ``blocks_in_use / n_blocks`` over decode
    steps; ``prefix_hit_rate`` is the fraction of admissions that mapped at
    least one prompt block to an already-resident page.
    ``resident_kv_bytes`` prices the *peak* pages actually holding live
    request state — the number to compare against
    ``dense_equiv_kv_bytes = n_slots · max_len`` worth of statically
    reserved cache (``spec`` is a :class:`repro_torch.models.api.CacheSpec`).
    ``gathered_kv_bytes`` / ``fused_kv_bytes`` price the run's attention
    KV traffic under the two backends — the padded high-water gather
    stream vs. the live blocks the fused block-table kernel actually
    touches (both accumulated per tick from the same cursors, so
    ``fused <= gathered`` at every step; ``attn_backend`` records which
    one actually ran).
    """
    return {
        "block_size": block_size,
        "n_blocks": n_blocks,
        "admissions": admissions,
        "prefix_hits": prefix_hits,
        "prefix_hit_rate": prefix_hits / max(admissions, 1),
        "shared_block_hits": shared_block_hits,
        "cow_count": cow_count,
        "block_occupancy": block_occ_sum / max(decode_steps, 1),
        "peak_blocks_in_use": peak_blocks,
        "resident_kv_bytes": peak_blocks * spec.kv_block_bytes(block_size),
        "dense_equiv_kv_bytes": spec.dense_kv_bytes(n_slots, max_len),
        "attn_backend": attn_backend,
        "gathered_kv_bytes": gathered_kv_bytes,
        "fused_kv_bytes": fused_kv_bytes,
        "gathered_kv_bytes_per_step": gathered_kv_bytes
        / max(decode_steps, 1),
        "fused_kv_bytes_per_step": fused_kv_bytes / max(decode_steps, 1),
    }


def slo_report(results, *, wall_s: float, preemptions: int, spills: int,
               revivals: int, prefill_chunk_tokens: int = 0,
               prefill_chunk_count: int = 0) -> dict:
    """SLO sub-report for the engine's aggregate.

    ``attainment`` is the fraction of deadline-carrying requests whose
    first token beat their absolute TTFT deadline;
    ``goodput_tok_per_s`` counts only tokens generated by requests that
    *met* their deadline (tokens from missed-deadline requests are wasted
    work under the SLO lens) — requests without a deadline always count.
    ``preemptions`` is scheduler-level (slot taken away), ``spills`` /
    ``revivals`` are the engine-level state round-trips backing them
    (mid-prefill preemptions discard progress instead of spilling, so
    ``spills <= preemptions``).
    """
    with_deadline = [r for r in results if r.metrics.deadline_s is not None]
    met = [r for r in with_deadline if r.metrics.deadline_met]
    no_deadline = [r for r in results if r.metrics.deadline_s is None]
    good_tokens = sum(r.metrics.new_tokens for r in met + no_deadline)
    return {
        "deadline_requests": len(with_deadline),
        "deadline_met": len(met),
        "attainment": len(met) / max(len(with_deadline), 1),
        "goodput_tok_per_s": good_tokens / max(wall_s, 1e-9),
        "deadline_ttft_ms": _dist(
            [1e3 * r.metrics.ttft_s for r in with_deadline]),
        "preemptions": preemptions,
        "spills": spills,
        "revivals": revivals,
        "preempted_requests": sum(
            1 for r in results if r.metrics.preempted > 0),
        "prefill_chunk_tokens": prefill_chunk_tokens,
        "prefill_chunk_count": prefill_chunk_count,
    }


def spec_report(*, k: int, verify_ticks: int, emitted_tokens: int,
                slot_steps: float, accepted_hist, draft_steps: int) -> dict:
    """Speculative-decode sub-report for the engine's aggregate.

    ``tokens_per_step`` is **slot-step normalized**: emitted tokens over
    the sum of active slots across verify ticks, so plain decode scores
    exactly 1.0 and a fully-accepted window of ``k`` drafts scores
    ``k + 1`` — the "did the multiplexing gamble pay" number.
    ``accepted_hist[i]`` counts verify ticks (per slot) that accepted
    exactly ``i`` draft tokens; ``draft_steps`` is the drafter's model
    calls (0 for lookup drafters) — the overhead side of the bet.
    """
    hist = [int(c) for c in accepted_hist]
    total = sum(hist)
    return {
        "k": k,
        "verify_ticks": verify_ticks,
        "emitted_tokens": emitted_tokens,
        "tokens_per_step": emitted_tokens / max(slot_steps, 1e-9),
        "accepted_hist": hist,
        "accept_rate": (sum(i * c for i, c in enumerate(hist))
                        / max(total * k, 1)),
        "mean_accepted": sum(i * c for i, c in enumerate(hist))
                         / max(total, 1),
        "draft_steps": draft_steps,
        "draft_steps_per_tick": draft_steps / max(verify_ticks, 1),
    }
