"""Continuous-batching serve engine with a paged KV pool — the port of
:mod:`repro.serve` (paged FIFO mode).

Public surface::

    from repro_torch.serve import (Request, Sampler, ServeEngine,
                                   poisson_workload)

    engine = ServeEngine(model, params, n_slots=4, max_len=96, paged=True)
    results, report = engine.run(poisson_workload(
        n_requests=8, rate_rps=50.0, vocab=model.cfg.vocab))
"""

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_pool import AdmissionPlan, BlockPool, blocks_needed
from repro_torch.serve.metrics import RequestMetrics, aggregate, paged_report
from repro_torch.serve.request import FinishReason, Request, RequestResult
from repro_torch.serve.sampling import GREEDY, Sampler, sample_batch
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.workload import poisson_workload, shared_prefix_workload

__all__ = [
    "AdmissionPlan", "BlockPool", "FinishReason", "GREEDY", "Request",
    "RequestMetrics", "RequestResult", "Sampler", "ServeEngine",
    "SlotScheduler", "aggregate", "blocks_needed", "paged_report",
    "poisson_workload", "sample_batch", "shared_prefix_workload",
]
