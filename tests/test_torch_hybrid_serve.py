"""The port's serve engine on the SSM (mamba2) and hybrid (zamba2) families
against ``repro.serve.ServeEngine``, on the CPU.

Both engines serve the smoke configs in float32 compute with the same
parameters (the reference's ``PRNGKey(0)`` tree, moved by
:mod:`repro_torch.interop`) and the same seeded workloads, under a frozen
clock or a :class:`StepClock` (then both read the clock the same number of
times, so the schedule itself is compared). mamba2 is served dense-slot
(it has no K/V to page), zamba2 in both layouts, also with a tail of
Mamba-2 layers after its last shared block (greedily). The bar: identical greedy
tokens (f32, no tolerance), equal report counts and speculative
reports. The CUDA-graph path runs through a test double of the graph API
(as ``test_torch_graphs.py``'s): the captured engine equals the eager one
bit for bit, logits included. Chunked prefill, SLO scheduling and
preemption are ``test_torch_hybrid_slo.py``'s.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro.serve import DraftModelDrafter as JDraftModel
from repro.serve import ServeEngine as JEngine
from repro.serve import StepClock as JClock
from repro.serve import poisson_workload as j_poisson
from repro.serve import resolve_drafter as j_resolve
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import (DraftModelDrafter, ServeEngine, StepClock,
                               graphs, poisson_workload, resolve_drafter)

ARCHS = {"mamba2": ("mamba2-370m", {}),
         "zamba2": ("zamba2-1.2b", {}),
         "zamba2-tail": ("zamba2-1.2b", {"n_layers": 5, "attn_every": 2})}
#: (model, paged): mamba2 has no K/V to page; the zamba2 with a tail is
#: served greedily (its verify, chunks and spills are test_torch_hybrid.py's)
LAYOUTS = [("mamba2", False), ("zamba2", False), ("zamba2", True)]
GREEDY = LAYOUTS + [("zamba2-tail", True)]


def _ids(layouts):
    return [f"{m}-{'paged' if p else 'dense'}" for m, p in layouts]
REPORT_KEYS = ("n_requests", "decode_steps", "total_new_tokens",
               "slot_reuse", "moa_flops_total")
ENGINE = dict(n_slots=3, max_len=32, block_size=8)
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


def _run_both(key, jreq, treq, *, clock=None, jdrafter=None,
              tdrafter=None, **kw):
    """The reference's and the port's engine of the same settings on the
    same requests: ``((results, report, engine), ...)``."""
    jm, jp, tm, tp = _pair(key)
    jc = JClock(dt=clock) if clock else (lambda: 0.0)
    tc = StepClock(dt=clock) if clock else (lambda: 0.0)
    je = JEngine(jm, jp, clock=jc, attn_backend="jnp", drafter=jdrafter,
                 **kw)
    te = ServeEngine(tm, tp, clock=tc, device="cpu", drafter=tdrafter, **kw)
    return je.run(jreq) + (je,), te.run(treq) + (te,)


# ---------------------------------------------------------------------------
# greedy serving, both layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,paged", GREEDY, ids=_ids(GREEDY))
def test_greedy_equals_reference(key, paged):
    (jr, jrep, _), (tr, trep, _) = _run_both(
        key, _poisson(j_poisson), _poisson(poisson_workload), paged=paged,
        **ENGINE)
    _same_tokens(jr, tr)
    assert [r.slot for r in tr] == [r.slot for r in jr]
    for k in REPORT_KEYS:
        assert trep[k] == jrep[k], k
    if paged:
        for k in ("admissions", "prefix_hits", "peak_blocks_in_use",
                  "cow_count", "fused_kv_bytes", "gathered_kv_bytes"):
            assert trep["paged"][k] == jrep["paged"][k], k


def test_ssm_refuses_paged_engine():
    _, _, tm, tp = _pair("mamba2")
    with pytest.raises(ValueError, match="no KV cache to page"):
        ServeEngine(tm, tp, paged=True, device="cpu", **ENGINE)


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------


#: every layout with the oracle; the n-gram and the corrupted oracle each
#: on one recurrent layout of each family
SPEC = [(key, paged, "oracle") for key, paged in LAYOUTS] + [
    ("zamba2", True, "ngram?n=3"), ("mamba2", False, "oracle?accept=0.5"),
    ("zamba2", False, "oracle?accept=0.5")]


@pytest.mark.parametrize("key,paged,drafter", SPEC,
                         ids=[f"{i}-{d}" for i, (_, _, d) in
                              zip(_ids([c[:2] for c in SPEC]), SPEC)])
def test_spec_equals_reference(key, paged, drafter):
    """Tokens and ``report["spec"]`` equal the reference's; the oracle
    accepts every draft and its tokens equal the plain engine's."""
    (jr, jrep, _), (tr, trep, _) = _run_both(
        key, _poisson(j_poisson), _poisson(poisson_workload), paged=paged,
        jdrafter=j_resolve(drafter, 3), tdrafter=resolve_drafter(drafter, 3),
        **ENGINE)
    _same_tokens(jr, tr)
    assert trep["spec"] == jrep["spec"]
    for k in REPORT_KEYS:
        assert trep[k] == jrep[k], k
    if drafter == "oracle":
        assert trep["spec"]["accept_rate"] == 1.0
        _, _, tm, tp = _pair(key)
        plain, _ = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu",
                               paged=paged, **ENGINE).run(
            _poisson(poisson_workload))
        _same_tokens(plain, tr, "plain")


def test_spec_draft_model_recurrent_drafter():
    """A mamba2 draft model drafting for the zamba2 target (dense-slot): a
    recurrent drafter teacher-forced through its scanned verify and
    commit; tokens and the spec report equal the reference's."""
    jd, jdp, td, tdp = _pair("mamba2")
    (jr, jrep, _), (tr, trep, _) = _run_both(
        "zamba2", _poisson(j_poisson), _poisson(poisson_workload),
        paged=False, jdrafter=JDraftModel(jd, jdp, 3),
        tdrafter=DraftModelDrafter(td, tdp, 3), **ENGINE)
    _same_tokens(jr, tr)
    assert trep["spec"] == jrep["spec"]


# ---------------------------------------------------------------------------
# CUDA graphs through a test double of the graph API
# ---------------------------------------------------------------------------


class RecordingGraphs:
    """Test double of :class:`repro_torch.serve.graphs.TorchGraphs`: its
    capture records the body and runs nothing; its replay runs the body
    on the CPU tensors (``test_torch_graphs.py``'s)."""

    def supports(self, device):
        return True

    def new_stream(self, device):
        return None

    def new_pool(self):
        return None

    def on(self, stream):
        return contextlib.nullcontext()

    def capture(self, body, *, stream, pool):
        return body

    def bound_buffers(self, stream):
        return []

    def pool_bytes(self, pool):
        return 0


def _record(engine, out):
    """Every set of logits the engine samples or accepts, in order."""
    seed, sample, accept = engine._seed, engine._sample, engine._accept

    def _seed(slot, req, logits, *rest):
        out.append(logits.clone())
        return seed(slot, req, logits, *rest)

    def _sample(logits, *rest):
        out.append(logits.clone())
        return sample(logits, *rest)

    def _accept(logits, *rest):
        out.append(logits.clone())
        return accept(logits, *rest)

    engine._seed, engine._sample, engine._accept = _seed, _sample, _accept


@pytest.mark.parametrize("key,paged", LAYOUTS, ids=_ids(LAYOUTS))
@pytest.mark.parametrize("drafter", [None, "oracle?accept=0.5"])
def test_graphs_capture_equals_eager(monkeypatch, key, paged, drafter):
    """Captured (the double) against eager: tokens, reports and every
    logit bit for bit. The decode (or the scanned verify) is captured once
    per live-block bucket (dense-slot: once) at warmup; the exact-length
    prefills stay eager, so no prefill graph is made."""
    monkeypatch.setattr(graphs, "API", RecordingGraphs())
    _, _, tm, tp = _pair(key)
    runs = {}
    for cuda_graphs in (False, True):
        e = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu",
                        paged=paged, cuda_graphs=cuda_graphs,
                        drafter=resolve_drafter(drafter, 3)
                        if drafter else None, **ENGINE)
        logits = []
        _record(e, logits)
        results, report = e.run(_poisson(poisson_workload), warmup=True)
        runs[cuda_graphs] = results, report, logits, e
    (want, want_rep, want_lg, _), (got, rep, got_lg, e) = \
        runs[False], runs[True]
    _same_tokens(want, got)
    for k in REPORT_KEYS:
        assert rep[k] == want_rep[k], k
    assert rep.get("spec") == want_rep.get("spec")
    assert len(got_lg) == len(want_lg)
    for i, (a, b) in enumerate(zip(want_lg, got_lg)):
        assert torch.equal(a, b), i
    path = "verify" if drafter else "decode"
    assert {p for p, _ in e._graphs.captures} == {path}
    assert {hw for _, hw in e._graphs.captures} == \
        (set(e._hw_buckets()) if paged else {0})
    assert set(e._graphs.captures.values()) == {1}
