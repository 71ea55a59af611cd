"""Synthetic open-loop workloads (copied from ``repro/serve/workload.py``;
the same seed gives the same requests in both packages): Poisson arrivals,
mixed prompt/gen lengths.

Open-loop means arrivals do not wait for the server (unlike a closed loop
where each client waits for its previous request): inter-arrival gaps are
exponential with rate ``rate_rps`` requests/second, so queueing shows up in
TTFT whenever the engine falls behind.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.request import Request
from repro_torch.serve.sampling import GREEDY, Sampler

__all__ = ["bursty_workload", "poisson_workload", "shared_prefix_workload"]


def poisson_workload(*, n_requests: int, vocab: int, rate_rps: float = 50.0,
                     prompt_len_range: Tuple[int, int] = (4, 32),
                     gen_len_range: Tuple[int, int] = (4, 16),
                     sampler: Sampler = GREEDY,
                     eos_id: Optional[int] = None,
                     seed: int = 0) -> List[Request]:
    """Generate ``n_requests`` requests with Poisson arrivals.

    Prompt and generation lengths are drawn uniformly (inclusive) from
    their ranges, token ids uniformly from ``[0, vocab)``. Deterministic
    for a fixed ``seed``. Units: ``rate_rps`` in requests/second, lengths
    in tokens, arrivals in seconds from engine start.
    """
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    requests = []
    for i in range(n_requests):
        p = int(rng.integers(prompt_len_range[0], prompt_len_range[1] + 1))
        g = int(rng.integers(gen_len_range[0], gen_len_range[1] + 1))
        prompt = tuple(int(t) for t in rng.integers(0, vocab, p))
        requests.append(Request(
            uid=i, prompt=prompt, max_new_tokens=g,
            arrival_s=float(arrivals[i]), sampler=sampler, eos_id=eos_id))
    return requests


def bursty_workload(*, vocab: int, n_long: int, n_burst: int,
                    long_prompt_len: int = 24, long_gen_len: int = 48,
                    burst_prompt_len: int = 8, burst_gen_len: int = 4,
                    burst_at_s: float = 0.05,
                    burst_deadline_s: float = 0.25,
                    long_deadline_s: Optional[float] = None,
                    sampler: Sampler = GREEDY,
                    eos_id: Optional[int] = None,
                    seed: int = 0) -> List[Request]:
    """The SLO-scheduling stress shape: long generations first, then a
    burst of short, tight-deadline requests.

    ``n_long`` long-generation requests arrive near t=0 (microsecond
    stagger keeps arrival order deterministic) with a generous deadline of
    ``long_deadline_s`` seconds after arrival (None = no deadline at all);
    once they occupy every slot, ``n_burst`` short requests land together
    at ``burst_at_s`` with deadlines ``burst_deadline_s`` seconds after
    arrival. FIFO queues the burst behind the long decodes and blows its
    p99 TTFT; an SLO scheduler preempts the longs (their first token is
    already banked) and revives them later. Deterministic per ``seed``;
    uids order longs before burst requests.
    """
    if n_long < 1 or n_burst < 1:
        raise ValueError("need at least one long and one burst request")
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(n_long):
        arrival = 1e-6 * i
        prompt = tuple(int(t) for t in rng.integers(0, vocab,
                                                    long_prompt_len))
        requests.append(Request(
            uid=i, prompt=prompt, max_new_tokens=long_gen_len,
            arrival_s=arrival, sampler=sampler, eos_id=eos_id,
            deadline_s=(None if long_deadline_s is None
                        else arrival + long_deadline_s)))
    for j in range(n_burst):
        arrival = burst_at_s + 1e-6 * j
        prompt = tuple(int(t) for t in rng.integers(0, vocab,
                                                    burst_prompt_len))
        requests.append(Request(
            uid=n_long + j, prompt=prompt, max_new_tokens=burst_gen_len,
            arrival_s=arrival, sampler=sampler, eos_id=eos_id,
            deadline_s=arrival + burst_deadline_s))
    return requests


def shared_prefix_workload(*, n_requests: int, vocab: int,
                           rate_rps: float = 50.0, n_prefixes: int = 2,
                           prefix_len: int = 16,
                           suffix_len_range: Tuple[int, int] = (0, 8),
                           gen_len_range: Tuple[int, int] = (4, 16),
                           sampler: Sampler = GREEDY,
                           eos_id: Optional[int] = None,
                           seed: int = 0) -> List[Request]:
    """Poisson workload whose prompts share system-prompt-style prefixes.

    ``n_prefixes`` distinct prefixes of ``prefix_len`` tokens are drawn
    once; each request takes one (round-robin over arrival order — the
    worst case for slot-affinity tricks, the best case for a shared
    physical prefix cache) and appends a random suffix of length drawn
    from ``suffix_len_range`` (0 allowed: identical prompts, which is what
    exercises shared-tail copy-on-write). Deterministic per ``seed``;
    arrival semantics as :func:`poisson_workload`.
    """
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    if n_prefixes < 1 or prefix_len < 1:
        raise ValueError("need at least one prefix of at least one token")
    rng = np.random.default_rng(seed)
    prefixes = [tuple(int(t) for t in rng.integers(0, vocab, prefix_len))
                for _ in range(n_prefixes)]
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    requests = []
    for i in range(n_requests):
        s = int(rng.integers(suffix_len_range[0], suffix_len_range[1] + 1))
        suffix = tuple(int(t) for t in rng.integers(0, vocab, s))
        g = int(rng.integers(gen_len_range[0], gen_len_range[1] + 1))
        requests.append(Request(
            uid=i, prompt=prefixes[i % n_prefixes] + suffix,
            max_new_tokens=g, arrival_s=float(arrivals[i]),
            sampler=sampler, eos_id=eos_id))
    return requests
