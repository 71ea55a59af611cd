"""Per-request and aggregate serving metrics (``RequestMetrics``,
``aggregate`` and ``paged_report`` of ``repro/serve/metrics.py``).

Units: times in **seconds** on the engine clock unless a key says ``_ms``
(milliseconds); rates in **tokens per second**; ``moa_flops`` in FLOPs as
priced by :func:`repro_torch.launch.costing.request_decode_cost`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

__all__ = ["RequestMetrics", "aggregate", "paged_report"]


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
    builds, CUDA context, library handles) — reported separately so it can
    never fold into ``wall_s`` and skew ``tok_per_s`` / TTFT.
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
