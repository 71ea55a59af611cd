"""The port's chunked prefill, SLO scheduling and preemption on the SSM
(mamba2) and hybrid (zamba2) families against ``repro.serve.ServeEngine``,
on the CPU.

The setting is ``test_torch_hybrid_serve.py``'s (smoke configs in f32
compute, the reference's parameters, seeded workloads; mamba2 dense-slot,
zamba2 in both layouts). Under a :class:`StepClock` both
engines read the clock the same number of times, so the schedule itself is
compared exactly: admission order, preemptions, spills and revivals, every
request's metrics and the ``slo`` report. Greedy tokens must be identical
(f32), to the reference's and to the port's own one-shot, unpreempted
runs; a spilled slot's recurrent state must come back bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro.serve import ServeEngine as JEngine
from repro.serve import StepClock as JClock
from repro.serve import bursty_workload as j_bursty
from repro.serve import poisson_workload as j_poisson
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import (ServeEngine, StepClock, bursty_workload,
                               poisson_workload)

ARCHS = {"mamba2": ("mamba2-370m", {}), "zamba2": ("zamba2-1.2b", {})}
#: (model, paged): mamba2 has no K/V to page
LAYOUTS = [("mamba2", False), ("zamba2", False), ("zamba2", True)]
LAYOUT_IDS = [f"{m}-{'paged' if p else 'dense'}" for m, p in LAYOUTS]
ENGINE = dict(n_slots=3, max_len=64, block_size=8)
_BUILT = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are tiny, and
    a pool of threads a process only contends with the other test
    workers' (restored after the file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(key):
    if key not in _BUILT:
        arch, upd = ARCHS[key]
        upd = dict(upd, compute_dtype="float32")
        jm = jbuild(dataclasses.replace(jsmoke(jget(arch)), **upd))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(dataclasses.replace(tsmoke(tget(arch)), **upd))
        tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
        _BUILT[key] = jm, jp, tm, tp
    return _BUILT[key]


def _poisson(fn, n=5, seed=1, prompt=(4, 12), gen=(3, 12)):
    return fn(n_requests=n, vocab=257, rate_rps=20.0,
              prompt_len_range=prompt, gen_len_range=gen, seed=seed)


def _same_tokens(a, b, ctx=""):
    assert [r.uid for r in a] == [r.uid for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens,
                                      err_msg=f"{ctx} uid {x.uid}")


def _run_both(key, jreq, treq, *, clock=None, **kw):
    """The reference's and the port's engine of the same settings on the
    same requests: ``((results, report, engine), ...)``."""
    jm, jp, tm, tp = _pair(key)
    jc = JClock(dt=clock) if clock else (lambda: 0.0)
    tc = StepClock(dt=clock) if clock else (lambda: 0.0)
    je = JEngine(jm, jp, clock=jc, attn_backend="jnp", **kw)
    te = ServeEngine(tm, tp, clock=tc, device="cpu", **kw)
    return je.run(jreq) + (je,), te.run(treq) + (te,)


BURST = dict(n_long=2, n_burst=4, long_prompt_len=16, long_gen_len=30,
             burst_prompt_len=8, burst_gen_len=4, burst_at_s=0.004,
             burst_deadline_s=0.02, seed=0)


# ---------------------------------------------------------------------------
# chunked prefill, SLO scheduling, preemption
# ---------------------------------------------------------------------------

LONG = dict(n=4, seed=3, prompt=(10, 40), gen=(3, 6))


@pytest.mark.parametrize("key,paged", LAYOUTS, ids=LAYOUT_IDS)
def test_chunked_prefill_equals_reference(key, paged):
    """Chunks of 16 tokens (``ssd_chunk`` 8, block 8 aligned): tokens and
    chunk counts equal the reference's chunked engine; mamba2's also equal
    the port's one-shot engine (its chunks continue the scan exactly)."""
    kw = dict(ENGINE, n_slots=2, paged=paged, prefill_chunk_tokens=16)
    (jr, jrep, _), (tr, trep, _) = _run_both(
        key, _poisson(j_poisson, **LONG), _poisson(poisson_workload, **LONG),
        **kw)
    _same_tokens(jr, tr)
    assert [r.metrics.prefill_chunks for r in tr] == \
        [r.metrics.prefill_chunks for r in jr]
    assert max(r.metrics.prefill_chunks for r in tr) > 1
    assert trep["decode_steps"] == jrep["decode_steps"]
    if key == "mamba2":
        _, _, tm, tp = _pair(key)
        one, _ = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu",
                             **dict(kw, prefill_chunk_tokens=None)).run(
            _poisson(poisson_workload, **LONG))
        _same_tokens(one, tr, "one-shot")


def test_chunk_alignment_refused():
    _, _, tm, tp = _pair("zamba2")
    with pytest.raises(ValueError, match="chunk alignment"):
        ServeEngine(tm, tp, device="cpu", prefill_chunk_tokens=12, **ENGINE)


@pytest.mark.parametrize("key,paged", LAYOUTS, ids=LAYOUT_IDS)
def test_slo_equals_reference(key, paged):
    """SLO scheduling with chunks on ``bursty_workload`` under a
    ``StepClock``: tokens, the admission log, every request's metrics and
    the ``slo`` report equal the reference's, with a preemption spilled
    and revived (the recurrent state restored bit for bit: the preempted
    request's tokens equal the FIFO one-shot run's)."""
    kw = dict(ENGINE, n_slots=2, paged=paged, scheduling="slo",
              prefill_chunk_tokens=8)
    (jr, jrep, je), (tr, trep, te) = _run_both(
        key, j_bursty(vocab=257, **BURST), bursty_workload(vocab=257,
                                                           **BURST),
        clock=1e-3, **kw)
    _same_tokens(jr, tr)
    assert trep["slo"] == jrep["slo"]
    assert trep["slo"]["preemptions"] > 0 and trep["slo"]["revivals"] > 0
    assert te.scheduler.admission_log == [tuple(e) for e in
                                          je.scheduler.admission_log]
    for a, b in zip(jr, tr):
        assert dataclasses.asdict(a.metrics) == dataclasses.asdict(b.metrics)
    _, _, tm, tp = _pair(key)
    fifo, _ = ServeEngine(tm, tp, clock=StepClock(dt=1e-3), device="cpu",
                          **dict(ENGINE, n_slots=2, paged=paged)).run(
        bursty_workload(vocab=257, **BURST))
    _same_tokens(fifo, tr, "fifo")


@pytest.mark.parametrize("key,paged", LAYOUTS, ids=LAYOUT_IDS)
def test_preempt_and_revive_restore_state(key, paged):
    """A decoding request spilled mid-run and revived into another slot:
    the recurrent state comes back bit for bit (the spill snapshot equals
    the revived slot's state before its next step) and every token equals
    the unpreempted run's."""
    _, _, tm, tp = _pair(key)
    reqs = _poisson(poisson_workload, n=2, gen=(12, 12))
    reqs = [dataclasses.replace(r, arrival_s=0.0) for r in reqs]
    want, _ = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu",
                          paged=paged, **ENGINE).run(reqs)
    e = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu", paged=paged,
                    **ENGINE)
    e.start_run()
    for r in reqs:
        e.submit(r)
    results = []
    for _ in range(4):
        e.tick(results)
    slot = min(e._inflight)
    skey = tm.state_key
    before = {n: t[:, slot].clone() for n, t in e.cache[skey].items()}
    e.preempt(slot)
    snap = next(iter(e._spilled.values()))["snap"]
    for n, t in before.items():
        assert torch.equal(snap[skey][n][:, 0], t)
    revived = []
    orig = e._revive

    def revive(s, req):
        orig(s, req)
        revived.append(s)
        for n, t in before.items():
            assert torch.equal(e.cache[skey][n][:, s], t)

    e._revive = revive
    while not e.scheduler.done:
        e.tick(results)
    got, _ = e.finish_run(results)
    assert revived
    _same_tokens(want, got)
