"""The port's speculative engine against the JAX reference's, on the CPU.

Both engines serve the same smoke config (f32 compute) with the same
parameters (the reference's ``PRNGKey(0)``, moved by
:mod:`repro_torch.interop`) and the same seeded workload, each with its own
drafter of one spec. Greedy requests: the port's tokens equal the
reference's, its ``report["spec"]`` equals the reference's field for field
(the same drafts, so the same accept histogram), its ``moa_flops`` equal
the reference's acceptance-aware pricing, and its tokens equal the port's
own plain (non-speculative) engine's. Temperature requests draw from a
``torch.Generator``, so their bar is the same run under one seed.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro.serve import DraftModelDrafter as JDraftModel
from repro.serve import Sampler as JSampler
from repro.serve import ServeEngine as JEngine
from repro.serve import poisson_workload as j_poisson
from repro.serve import resolve_drafter as j_resolve
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import (DraftModelDrafter, Request, Sampler,
                               ServeEngine, poisson_workload,
                               resolve_drafter)

ENGINE = dict(n_slots=3, max_len=48, block_size=8, clock=lambda: 0.0)
_BUILT = {}


def _pair(arch):
    if arch not in _BUILT:
        upd = {"compute_dtype": "float32"}
        jm = jbuild(dataclasses.replace(jsmoke(jget(arch)), **upd))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(dataclasses.replace(tsmoke(tget(arch)), **upd))
        tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
        _BUILT[arch] = jm, jp, tm, tp
    return _BUILT[arch]


def _workload(fn, vocab, n=6, temperature=0.0):
    """``fn``: either package's ``poisson_workload`` (each with its own
    sampler type)."""
    sampler = (Sampler if fn is poisson_workload else JSampler)(temperature)
    return fn(n_requests=n, rate_rps=100.0, vocab=vocab,
              prompt_len_range=(4, 12), gen_len_range=(3, 10),
              sampler=sampler, seed=1)


def _drafters(spec, k, jm, jp, tm, tp):
    if spec == "draft-model":
        return JDraftModel(jm, jp, k), DraftModelDrafter(tm, tp, k)
    return j_resolve(spec, k), resolve_drafter(spec, k)


def _same_tokens(a, b):
    for x, y in zip(a, b):
        assert x.uid == y.uid
        np.testing.assert_array_equal(x.tokens, y.tokens,
                                      err_msg=f"uid {x.uid}")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("spec", ["ngram?n=3", "oracle", "oracle?accept=0.5",
                                  "oracle?accept=0.0", "draft-model"])
def test_spec_engine_equals_reference(spec, k, paged):
    jm, jp, tm, tp = _pair("llama3-8b")
    jd, td = _drafters(spec, k, jm, jp, tm, tp)
    want, want_rep = JEngine(jm, jp, paged=paged, drafter=jd,
                             attn_backend="jnp", **ENGINE).run(
        _workload(j_poisson, jm.cfg.vocab))
    got, rep = ServeEngine(tm, tp, paged=paged, drafter=td, device="cpu",
                           **ENGINE).run(_workload(poisson_workload,
                                                   tm.cfg.vocab))
    _same_tokens(want, got)
    assert rep["spec"] == want_rep["spec"]
    assert rep["moa_flops_total"] == want_rep["moa_flops_total"]
    assert [r.metrics.moa_flops for r in got] == \
        [r.metrics.moa_flops for r in want]
    assert rep["decode_steps"] == want_rep["decode_steps"]
    if paged:   # the k-row margin reserves the reference's blocks
        drop = {"attn_backend"}       # "torch" here, "jnp" there
        assert {n: v for n, v in rep["paged"].items() if n not in drop} == \
            {n: v for n, v in want_rep["paged"].items() if n not in drop}
    plain, _ = ServeEngine(tm, tp, paged=paged, device="cpu",
                           **ENGINE).run(_workload(poisson_workload,
                                                   tm.cfg.vocab))
    _same_tokens(plain, got)
    if spec in ("oracle", "draft-model"):
        assert rep["spec"]["accept_rate"] == 1.0
    if spec == "oracle?accept=0.0":
        assert rep["spec"]["tokens_per_step"] == pytest.approx(1.0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_dropless_moe_spec_engine_equals_reference(paged):
    """The dropless MoE verifies exactly: oracle tokens equal the
    reference's and the port's plain engine's, accept rate 1."""
    jm, jp, tm, tp = _pair("moonshot-v1-16b-a3b")
    jd, td = _drafters("oracle", 3, jm, jp, tm, tp)
    want, want_rep = JEngine(jm, jp, paged=paged, drafter=jd,
                             attn_backend="jnp", **ENGINE).run(
        _workload(j_poisson, jm.cfg.vocab, n=4))
    got, rep = ServeEngine(tm, tp, paged=paged, drafter=td, device="cpu",
                           **ENGINE).run(_workload(poisson_workload,
                                                   tm.cfg.vocab, n=4))
    _same_tokens(want, got)
    assert rep["spec"] == want_rep["spec"]
    assert rep["spec"]["accept_rate"] == 1.0
    plain, _ = ServeEngine(tm, tp, paged=paged, device="cpu",
                           **ENGINE).run(_workload(poisson_workload,
                                                   tm.cfg.vocab, n=4))
    _same_tokens(plain, got)


def test_spec_temperature_deterministic_per_seed():
    """Seeded temperature spec decode reproduces itself exactly: every draw
    comes from the engine's generator and the oracle's numpy stream."""
    _, _, tm, tp = _pair("llama3-8b")

    def run_once():
        engine = ServeEngine(
            tm, tp, device="cpu", drafter=resolve_drafter(
                "oracle?accept=0.5", 2),
            generator=torch.Generator().manual_seed(3), **ENGINE)
        return engine.run(_workload(poisson_workload, tm.cfg.vocab, n=4,
                                    temperature=0.8))

    (r1, rep1), (r2, rep2) = run_once(), run_once()
    _same_tokens(r1, r2)
    assert rep1["spec"] == rep2["spec"]


def test_spec_margin_tightens_admission():
    """The scheduler reserves ``k`` rows past a request's worst case: a
    request that fits plain mode is refused when prompt + max_new + k
    overflows the slot."""
    _, _, tm, tp = _pair("llama3-8b")
    engine = ServeEngine(tm, tp, n_slots=1, max_len=16, device="cpu",
                         drafter=resolve_drafter("oracle", 3))
    engine.submit(Request(uid=0, prompt=(1, 2, 3, 4), max_new_tokens=9))
    with pytest.raises(ValueError, match="spec_margin"):
        engine.submit(Request(uid=1, prompt=(1, 2, 3, 4), max_new_tokens=10))
