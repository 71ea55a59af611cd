"""Continuous-batching serve engine — the port of :mod:`repro.serve`: a
dense-slot cache or a paged KV pool, speculative decoding
(``ServeEngine(drafter=...)``, :mod:`repro_torch.serve.spec`), chunked
prefill and SLO scheduling with preemption
(``ServeEngine(scheduling="slo", prefill_chunk_tokens=...)``;
:class:`StepClock` makes it a deterministic simulator), live weight
reloads (``ServeEngine.reload_params``) and a fault-tolerant replica fleet
(:class:`ReplicaSet` of :class:`Replica` engines: heartbeats, requeues,
rolling reloads).

Public surface::

    from repro_torch.serve import (Request, Sampler, ServeEngine,
                                   poisson_workload)

    engine = ServeEngine(model, params, n_slots=4, max_len=96, paged=True)
    results, report = engine.run(poisson_workload(
        n_requests=8, rate_rps=50.0, vocab=model.cfg.vocab))
"""

from repro_torch.serve.clock import StepClock
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_pool import AdmissionPlan, BlockPool, blocks_needed
from repro_torch.serve.metrics import (RequestMetrics, aggregate,
                                       paged_report, slo_report, spec_report)
from repro_torch.serve.request import FinishReason, Request, RequestResult
from repro_torch.serve.sampling import GREEDY, Sampler, sample_batch
from repro_torch.serve.replica import DEAD, DRAINING, HEALTHY, Replica
from repro_torch.serve.router import ReplicaSet
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.spec import (Drafter, DraftModelDrafter, NgramDrafter,
                                    OracleDrafter, resolve_drafter,
                                    verify_accept)
from repro_torch.serve.workload import (bursty_workload, poisson_workload,
                                        shared_prefix_workload)

__all__ = [
    "AdmissionPlan", "BlockPool", "DEAD", "DRAINING", "Drafter",
    "DraftModelDrafter", "FinishReason", "GREEDY", "HEALTHY", "NgramDrafter",
    "OracleDrafter", "Replica", "ReplicaSet", "Request", "RequestMetrics",
    "RequestResult", "Sampler", "ServeEngine",
    "SlotScheduler", "StepClock", "aggregate", "blocks_needed",
    "bursty_workload", "paged_report", "poisson_workload", "resolve_drafter",
    "sample_batch", "shared_prefix_workload", "slo_report", "spec_report",
    "verify_accept",
]
