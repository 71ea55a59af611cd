"""The port's chunked prefill and SLO scheduling against the JAX reference,
on the CPU.

Both engines serve the same smoke config (f32 compute) with the same
parameters (the reference's ``PRNGKey(0)``, moved by
:mod:`repro_torch.interop`) and the same seeded workloads. Under a
:class:`StepClock` both are deterministic simulators that read the clock
the same number of times, so the schedule itself is compared exactly:
admission order, preemptions, spills and revivals, every request's metrics
and the ``slo`` report. Greedy tokens must be identical (f32), to the
reference's and to the port's own one-shot, unpreempted runs.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro.serve import ServeEngine as JEngine
from repro.serve import SlotScheduler as JScheduler
from repro.serve import StepClock as JClock
from repro.serve import bursty_workload as j_bursty
from repro.serve import poisson_workload as j_poisson
from repro.serve import Request as JRequest
from repro.serve import resolve_drafter as j_resolve
from repro.serve import shared_prefix_workload as j_shared
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import (Request, ServeEngine, SlotScheduler,
                               StepClock, bursty_workload, poisson_workload,
                               resolve_drafter, shared_prefix_workload)

_BUILT = {}
WORKLOADS = {"poisson": (j_poisson, poisson_workload),
             "shared": (j_shared, shared_prefix_workload),
             "bursty": (j_bursty, bursty_workload)}
BURST = dict(n_long=2, n_burst=4, long_prompt_len=16, long_gen_len=40,
             burst_prompt_len=8, burst_gen_len=4, burst_at_s=0.004,
             burst_deadline_s=0.02, seed=0)


def _pair(arch="llama3-8b", **upd):
    key = (arch, tuple(sorted(upd.items())))
    if key not in _BUILT:
        upd = dict({"compute_dtype": "float32"}, **upd)
        jm = jbuild(dataclasses.replace(jsmoke(jget(arch)), **upd))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(dataclasses.replace(tsmoke(tget(arch)), **upd))
        tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
        _BUILT[key] = jm, jp, tm, tp
    return _BUILT[key]


def _workloads(which, vocab, **kw):
    """The same requests from each package's generator (reference, port)."""
    return tuple(fn(vocab=vocab, **kw) for fn in WORKLOADS[which])


def _same_tokens(a, b, ctx=""):
    assert [r.uid for r in a] == [r.uid for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens,
                                      err_msg=f"{ctx} uid {x.uid}")


def _run_both(arch, which, wl_kw, *, clock=None, **engine_kw):
    """Reference and port engines of the same settings on the same
    workload, on a :class:`StepClock` of ``clock`` seconds a read (else a
    frozen clock); returns ``(results, report, engine, clock)`` of each."""
    jm, jp, tm, tp = _pair(arch)
    jreq, treq = _workloads(which, tm.cfg.vocab, **wl_kw)
    out = []
    for engine, model, params, reqs, kw, mk in (
            (JEngine, jm, jp, jreq, {"attn_backend": "jnp"}, JClock),
            (ServeEngine, tm, tp, treq, {"device": "cpu"}, StepClock)):
        c = mk(dt=clock) if clock else (lambda: 0.0)
        eng = engine(model, params, clock=c, **kw, **engine_kw)
        out.append(eng.run(reqs) + (eng, c))
    return out


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

POISSON_LONG = dict(n_requests=6, seed=3, prompt_len_range=(10, 60),
                    gen_len_range=(4, 8))


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_prefill_equals_reference_and_one_shot(arch, paged):
    """Chunked greedy tokens equal the reference's chunked engine and the
    port's one-shot engine (dense family and a dropless MoE, both
    layouts); chunk counts equal the reference's."""
    kw = dict(n_slots=2, max_len=96, paged=paged, block_size=8)
    # the MoE's reference compiles each (prefix, chunk) shape: fewer
    # requests keep the file short
    wl = POISSON_LONG if arch == "llama3-8b" else dict(
        POISSON_LONG, n_requests=3, gen_len_range=(3, 5))
    (jr, jrep, _, _), (tr, trep, _, _) = _run_both(
        arch, "poisson", wl, prefill_chunk_tokens=16, **kw)
    _same_tokens(jr, tr, "reference")
    assert [r.metrics.prefill_chunks for r in tr] == \
        [r.metrics.prefill_chunks for r in jr]
    assert max(r.metrics.prefill_chunks for r in tr) > 1
    assert trep["decode_steps"] == jrep["decode_steps"]
    _, _, tm, tp = _pair(arch)
    one_shot, _ = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu",
                              **kw).run(poisson_workload(vocab=tm.cfg.vocab,
                                                         **wl))
    _same_tokens(one_shot, tr, "one-shot")


def test_chunked_shared_prefix_starts_past_the_hit():
    """A prefix-hit chunked prefill starts its chunk cursor past the
    matched blocks: hits and cached tokens equal the reference's and the
    one-shot engine's, tokens identical."""
    wl = dict(n_requests=8, n_prefixes=2, prefix_len=24,
              suffix_len_range=(0, 8), seed=5)
    kw = dict(n_slots=2, max_len=96, paged=True, block_size=8)
    (jr, jrep, _, _), (tr, trep, _, _) = _run_both(
        "llama3-8b", "shared", wl, prefill_chunk_tokens=16, **kw)
    _same_tokens(jr, tr)
    assert trep["paged"]["prefix_hits"] == jrep["paged"]["prefix_hits"] > 0
    assert [r.metrics.cached_prompt_tokens for r in tr] == \
        [r.metrics.cached_prompt_tokens for r in jr]
    _, _, tm, tp = _pair()
    one_shot, rep = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu",
                                **kw).run(shared_prefix_workload(
                                    vocab=tm.cfg.vocab, **wl))
    _same_tokens(one_shot, tr)
    assert rep["paged"]["prefix_hits"] == trep["paged"]["prefix_hits"]


def test_short_prompts_skip_chunking():
    _, _, tm, tp = _pair()
    reqs = poisson_workload(n_requests=3, vocab=tm.cfg.vocab, seed=1,
                            prompt_len_range=(4, 8), gen_len_range=(3, 5))
    got, _ = ServeEngine(tm, tp, n_slots=2, max_len=32, clock=lambda: 0.0,
                         device="cpu", prefill_chunk_tokens=8).run(reqs)
    assert all(r.metrics.prefill_chunks == 1 for r in got)


CONSTRUCTOR_ERRORS = {
    "block-multiple": ({}, dict(paged=True, block_size=16,
                                prefill_chunk_tokens=8), "block_size"),
    "int8": ({"kv_cache_dtype": "int8"}, dict(prefill_chunk_tokens=8),
             "int8"),
    "capacity-limited-moe": ({"capacity_factor": 1.25},
                             dict(prefill_chunk_tokens=8), "chunked prefill"),
    "chunk-zero": ({}, dict(prefill_chunk_tokens=0), ">= 1"),
    "unknown-scheduling": ({}, dict(scheduling="edf"), "unknown scheduling"),
    "slo-with-drafter": ({}, dict(scheduling="slo", drafter="oracle"),
                         "incompatible"),
}


@pytest.mark.parametrize("case", list(CONSTRUCTOR_ERRORS))
def test_constructor_errors_equal_reference(case):
    """Each of the reference's constructor errors, raised by both."""
    upd, kw, match = CONSTRUCTOR_ERRORS[case]
    arch = "moonshot-v1-16b-a3b" if "moe" in case else "llama3-8b"
    jm, jp, tm, tp = _pair(arch, **upd)
    for engine, model, params, resolve, extra in (
            (JEngine, jm, jp, j_resolve, {}),
            (ServeEngine, tm, tp, resolve_drafter, {"device": "cpu"})):
        args = dict(kw)
        if "drafter" in args:
            args["drafter"] = resolve(args["drafter"], 2)
        with pytest.raises(ValueError, match=match):
            engine(model, params, n_slots=1, max_len=32, **args, **extra)


# ---------------------------------------------------------------------------
# SLO scheduling under the StepClock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 8], ids=["one-shot", "chunked"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_slo_schedule_equals_reference(paged, chunk):
    """The burst under ``scheduling="slo"``: admission order, every
    preemption, spills, revivals, each request's metrics, the ``slo``
    report and the clock reads equal the reference's; tokens identical,
    and identical to the port's FIFO run (spill and revive leave no
    trace)."""
    kw = dict(n_slots=2, max_len=64, paged=paged, block_size=8,
              prefill_chunk_tokens=chunk)
    (jr, jrep, je, jc), (tr, trep, te, tc) = _run_both(
        "llama3-8b", "bursty", BURST, clock=1e-3, scheduling="slo", **kw)
    _same_tokens(jr, tr)
    assert trep["slo"] == jrep["slo"]
    assert trep["slo"]["preemptions"] > 0
    assert trep["slo"]["revivals"] == trep["slo"]["spills"] > 0
    assert [r.metrics.to_json() for r in tr] == \
        [r.metrics.to_json() for r in jr]
    assert [r.to_json() for r in tr] == [r.to_json() for r in jr]
    assert te.scheduler.admission_log == je.scheduler.admission_log
    assert te.scheduler.preemption_log == je.scheduler.preemption_log
    assert tc.reads == jc.reads
    _, _, tm, tp = _pair()
    fifo, frep = ServeEngine(tm, tp, clock=StepClock(dt=1e-3), device="cpu",
                             **kw).run(bursty_workload(vocab=tm.cfg.vocab,
                                                       **BURST))
    _same_tokens(fifo, tr, "fifo")
    assert frep["slo"]["preemptions"] == 0
    assert trep["slo"]["attainment"] > frep["slo"]["attainment"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_inflight_preempt_revive_direct(paged):
    """Preempt a mid-decode request through the lifecycle methods: its
    state is spilled (dense-slot: the row; paged: the cursor, the pages
    staying pinned), the next admission revives the row (or the cursor and
    table) as it was, and the run's tokens equal an uninterrupted run's,
    with the preemption recorded."""
    _, _, tm, tp = _pair()
    toks = np.random.default_rng(0).integers(0, tm.cfg.vocab, 8)
    req = Request(uid=7, prompt=tuple(int(t) for t in toks),
                  max_new_tokens=8)
    kw = dict(n_slots=1, max_len=32, paged=paged, block_size=8,
              clock=lambda: 0.0, device="cpu")
    ref, _ = ServeEngine(tm, tp, **kw).run([req])
    eng = ServeEngine(tm, tp, **kw)
    eng.scheduler.submit(req)
    [(slot, r)] = eng.scheduler.admit_ready(0.0)
    eng._admit(slot, r, 0.0, [])
    for _ in range(3):
        eng._decode_tick([])
    pos = int(eng.cache["pos"][slot])
    row = {n: t[:, slot].clone() for n, t in eng.cache["layers"].items()}
    table = eng.cache["block_tables"][slot].clone() if paged else None
    eng.preempt(slot)
    assert req.uid in eng._spilled and not eng._inflight
    eng.scheduler.check()
    if paged:
        assert eng._pool.in_use > 0            # the pages stay pinned
        assert int(eng.cache["pos"][slot]) == 0
    with pytest.raises(KeyError):
        eng.preempt(slot)
    [(slot, r)] = eng.scheduler.admit_ready(0.0)
    eng._admit(slot, r, 0.0, [])               # the revival
    assert not eng._spilled and int(eng.cache["pos"][slot]) == pos
    if paged:
        assert np.array_equal(eng.cache["block_tables"][slot].numpy(),
                              table.numpy())
    else:
        for n, t in eng.cache["layers"].items():
            assert np.array_equal(t[:, slot].numpy(), row[n].numpy()), n
    eng.preempt(slot)                          # and once more, to the run
    results, report = eng.run([])
    np.testing.assert_array_equal(results[0].tokens, ref[0].tokens)
    assert results[0].metrics.preempted == 2
    if paged:
        assert eng._pool.in_use == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_midprefill_preempt_restarts_clean(paged):
    """A request preempted mid-chunked-prefill discards its progress,
    frees every page it held, and restarts from scratch with unchanged
    greedy output."""
    _, _, tm, tp = _pair()
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, 24)
    req = Request(uid=3, prompt=tuple(int(t) for t in toks),
                  max_new_tokens=6)
    kw = dict(n_slots=1, max_len=64, paged=paged, block_size=8,
              clock=lambda: 0.0, prefill_chunk_tokens=8, device="cpu")
    ref, _ = ServeEngine(tm, tp, **kw).run([req])
    eng = ServeEngine(tm, tp, **kw)
    eng.scheduler.submit(req)
    [(slot, r)] = eng.scheduler.admit_ready(0.0)
    eng._admit(slot, r, 0.0, [])
    assert slot in eng._prefilling
    eng._prefill_tick([])
    assert eng._prefilling[slot].done == 8
    eng.preempt(slot)
    assert not eng._prefilling and not eng._spilled
    if paged:
        assert eng._pool.in_use == 0
        eng._pool.check()
    eng.scheduler.check()
    results, _ = eng.run([])
    np.testing.assert_array_equal(results[0].tokens, ref[0].tokens)
    assert results[0].metrics.prefill_chunks == 3


# ---------------------------------------------------------------------------
# host pieces: workload, clock, request, scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [BURST, dict(n_long=4, n_burst=8,
                                            long_prompt_len=1024,
                                            long_gen_len=64,
                                            burst_prompt_len=32,
                                            burst_gen_len=8,
                                            long_deadline_s=5.0, seed=3)])
def test_bursty_workload_equals_reference(kw):
    want, got = _workloads("bursty", 128256, **kw)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert (a.uid, a.prompt, a.max_new_tokens, a.arrival_s, a.priority,
                a.deadline_s) == (b.uid, b.prompt, b.max_new_tokens,
                                  b.arrival_s, b.priority, b.deadline_s)
    with pytest.raises(ValueError, match="at least one"):
        bursty_workload(vocab=8, n_long=0, n_burst=1)


def test_step_clock_and_request_fields():
    c = StepClock(dt=2.0, start=1.0)
    assert c() == 1.0 and c() == 3.0 and c.reads == 2
    c.advance(10.0)
    assert c() == 15.0
    with pytest.raises(ValueError):
        c.advance(-1.0)
    with pytest.raises(ValueError):
        StepClock(dt=-1e-3)
    with pytest.raises(ValueError, match="deadline_s"):
        Request(uid=1, prompt=(1,), max_new_tokens=1, arrival_s=1.0,
                deadline_s=0.5)
    r = Request(uid=1, prompt=(1, 2), max_new_tokens=3, priority=2,
                deadline_s=0.5)
    assert (r.priority, r.deadline_s) == (2, 0.5)


def test_slo_scheduler_order_and_preempt_equal_reference():
    """Random priorities, deadlines and arrivals through both schedulers
    under the ``"slo"`` policy, with preemptions and ``admit_revivable``
    in between: every admission and preemption equal."""
    rs = np.random.default_rng(11)
    reqs = []
    for uid in range(24):
        arrival = float(rs.uniform(0, 1))
        dl = None if rs.random() < 0.3 else arrival + float(rs.uniform(0.1,
                                                                       2))
        reqs.append(dict(uid=uid, prompt=(1,) * int(rs.integers(1, 9)),
                         max_new_tokens=int(rs.integers(1, 8)),
                         arrival_s=arrival, priority=int(rs.integers(0, 3)),
                         deadline_s=dl))
    scheds = []
    for cls, req_cls in ((JScheduler, JRequest), (SlotScheduler, Request)):
        s = cls(3, 32, [8, 16], spec_margin=2, policy="slo")
        for kw in reqs:
            s.submit(req_cls(**kw))
        scheds.append(s)
    for t in np.linspace(0.0, 1.2, 25):
        got = [s.admit_ready(float(t), limit=2) for s in scheds]
        assert [(slot, r.uid) for slot, r in got[0]] == \
            [(slot, r.uid) for slot, r in got[1]]
        a, b = (s.ready_head(float(t)) for s in scheds)
        assert (a and a.uid) == (b and b.uid)
        if got[0] and rs.random() < 0.5:
            slot = got[0][0][0]
            for s in scheds:
                s.preempt(slot, float(t))
            revivable = {got[0][0][1].uid}
            a, b = (s.admit_revivable(float(t), revivable) for s in scheds)
            assert (a and (a[0], a[1].uid)) == (b and (b[0], b[1].uid))
        for s in scheds:
            for slot in list(s.active)[:1]:
                s.release(slot)
            s.check()
    assert scheds[0].admission_log == scheds[1].admission_log
    assert scheds[0].preemption_log == scheds[1].preemption_log
    with pytest.raises(ValueError, match="policy"):
        SlotScheduler(1, 8, policy="edf")
    with pytest.raises(ValueError, match="spec_margin"):
        SlotScheduler(1, 8, spec_margin=-1)
