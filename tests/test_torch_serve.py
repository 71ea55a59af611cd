"""The port's paged engine against ``repro.serve.ServeEngine(paged=True)``.

Both engines serve ``smoke_config(get_config("llama3-8b"))`` (bf16 compute)
with the same parameters (the reference's ``PRNGKey(0)`` tree, moved across
by :mod:`repro_torch.interop`) and the same seeded workloads, under a
frozen clock. The bar is the roadmap's: identical greedy tokens, and equal
paged-report counts (admissions, prefix hits, shared blocks, peak blocks,
gathered / fused KV bytes). The reference runs its gathered jnp attention;
the port, on CPU tensors, the plain versions of its kernels.

In float32 the tokens must be identical. In bf16 the two frameworks round
to bf16 after sums taken in different orders (and with their own sin, cos
and exp), so a logit can move by about one bf16 ulp of the hidden state;
there a divergence is accepted only at a real near-tie of the
reference's own logits (see :func:`_assert_same_greedy`).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro.serve import ServeEngine as JEngine
from repro.serve import poisson_workload as j_poisson
from repro.serve import shared_prefix_workload as j_shared
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.launch import serve as serve_cli
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import NgramDrafter, Sampler, ServeEngine
from repro_torch.serve import poisson_workload as t_poisson
from repro_torch.serve import shared_prefix_workload as t_shared

POOLS = {"bf16": {}, "int8": {"kv_cache_dtype": "int8"},
         "f32": {"compute_dtype": "float32"}}
ENGINE = dict(n_slots=3, max_len=64, paged=True, block_size=16,
              prompt_buckets=(32,))     # one prefill shape to trace
REPORT_KEYS = ("admissions", "prefix_hits", "shared_block_hits",
               "peak_blocks_in_use", "cow_count", "gathered_kv_bytes",
               "fused_kv_bytes", "resident_kv_bytes", "dense_equiv_kv_bytes")


def _workload(which, module_fns, vocab, **kw):
    poisson, shared = module_fns
    if which == "poisson":
        return poisson(n_requests=7, vocab=vocab, rate_rps=100.0,
                       prompt_len_range=(4, 30), gen_len_range=(3, 10),
                       seed=1, **kw)
    return shared(n_requests=7, vocab=vocab, rate_rps=100.0, n_prefixes=2,
                  prefix_len=16, suffix_len_range=(0, 6),
                  gen_len_range=(3, 8), seed=7, **kw)


#: a bf16 / int8 divergence must sit at a top-2 gap below this: the two
#: packages' bf16 logits differ by about one bf16 ulp of the hidden state
#: times the unembedding (~0.02 on these contexts), and an int8 cache adds
#: a quantization step wherever a code flips
NEAR_TIE = 0.05


def _assert_same_greedy(pool, jm, jp, requests, want, got):
    """Identical greedy tokens per request. Under bf16 compute a request
    may diverge, but only at a near-tie: on the shared context the
    reference's top-2 logits are within ``NEAR_TIE`` and each package
    picked one of those two."""
    import jax.numpy as jnp

    for req, a, b in zip(requests, want, got):
        if np.array_equal(a.tokens, b.tokens):
            continue
        assert pool != "f32", f"uid {a.uid}: f32 tokens differ"
        i = int(np.flatnonzero(a.tokens != b.tokens)[0])
        ctx = np.asarray(req.prompt + tuple(int(t) for t in a.tokens[:i]),
                         np.int32)[None]
        logits = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(ctx)}))
        top2 = np.argsort(logits[0, -1])[-2:]
        gap = float(logits[0, -1, top2[1]] - logits[0, -1, top2[0]])
        assert gap < NEAR_TIE, (a.uid, i, gap)
        assert {int(a.tokens[i]), int(b.tokens[i])} <= set(top2.tolist())


@pytest.fixture(scope="module")
def engines():
    """Per pool: the two models and parameter trees, plus a cache of the
    reference engine's runs (each is a JAX trace + compile on first use)."""
    out = {}
    for pool, upd in POOLS.items():
        jcfg = dataclasses.replace(jsmoke(jget("llama3-8b")), **upd)
        tcfg = dataclasses.replace(tsmoke(tget("llama3-8b")), **upd)
        jm = jbuild(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(tcfg)
        tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
        out[pool] = (jm, jp, tm, tp)
    return out


@pytest.mark.parametrize("pool,workload", [
    ("bf16", "poisson"), ("bf16", "shared_prefix"), ("int8", "poisson"),
    ("int8", "shared_prefix"), ("f32", "poisson")])
def test_greedy_tokens_and_paged_counts_match(engines, pool, workload):
    jm, jp, tm, tp = engines[pool]
    vocab = jm.cfg.vocab
    ref = JEngine(jm, jp, attn_backend="jnp", clock=lambda: 0.0, **ENGINE)
    want, want_rep = ref.run(_workload(workload, (j_poisson, j_shared),
                                       vocab))
    port = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu", **ENGINE)
    got, rep = port.run(_workload(workload, (t_poisson, t_shared), vocab))
    assert [r.uid for r in got] == [r.uid for r in want]
    _assert_same_greedy(pool, jm, jp,
                        _workload(workload, (t_poisson, t_shared), vocab),
                        want, got)
    for a, b in zip(want, got):
        assert b.tokens.shape == a.tokens.shape and b.slot == a.slot
        assert b.finish_reason.value == a.finish_reason.value
        assert b.metrics.cached_prompt_tokens == \
            a.metrics.cached_prompt_tokens
    for key in REPORT_KEYS:
        assert rep["paged"][key] == want_rep["paged"][key], key
    for key in ("n_requests", "decode_steps", "total_new_tokens",
                "slot_reuse"):
        assert rep[key] == want_rep[key], key
    if workload == "shared_prefix":
        assert rep["paged"]["prefix_hits"] > 0
    assert rep["paged"]["attn_backend"] == "torch"
    # every request priced as the reference prices it (same arithmetic)
    assert rep["moa_flops_total"] == want_rep["moa_flops_total"] > 0
    for a, b in zip(want, got):
        assert b.metrics.moa_flops == a.metrics.moa_flops
    port._pool.check()
    assert port._pool.in_use == 0


def test_temperature_sampling_is_deterministic_under_a_seed(engines):
    _, _, tm, tp = engines["bf16"]

    def run(seed):
        eng = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu",
                          generator=torch.Generator().manual_seed(seed),
                          **ENGINE)
        results, _ = eng.run(t_poisson(
            n_requests=4, vocab=tm.cfg.vocab, rate_rps=100.0,
            prompt_len_range=(4, 12), gen_len_range=(4, 8),
            sampler=Sampler(0.8), seed=3))
        return [r.tokens.tolist() for r in results]

    first = run(5)
    assert run(5) == first
    assert run(6) != first


def test_warmup_keeps_tokens(engines):
    """The warmup tick's writes land on the trash page: a warmed engine
    serves the same tokens as a cold one."""
    _, _, tm, tp = engines["int8"]
    reqs = lambda: _workload("poisson", (t_poisson, t_shared), tm.cfg.vocab)
    cold, _ = ServeEngine(tm, tp, clock=lambda: 0.0, device="cpu",
                          **ENGINE).run(reqs())
    warm, rep = ServeEngine(tm, tp, device="cpu", **ENGINE).run(
        reqs(), warmup=True)
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert rep["compile_s"] > 0 and rep["device"] == "cpu"


def test_unported_engine_modes_raise(engines):
    _, _, tm, tp = engines["bf16"]
    base = dict(n_slots=2, max_len=32, device="cpu")
    assert not ServeEngine(tm, tp, **base).paged    # dense-slot: ported
    # mesh serving is ported; SLO scheduling on a mesh is not
    with pytest.raises(ValueError, match="item 19"):
        ServeEngine(tm, tp, paged=True, **base, mesh=object(),
                    scheduling="slo")
    # speculative decoding, chunked prefill and SLO scheduling are ported
    for extra in ({"drafter": NgramDrafter(2)}, {"prefill_chunk_tokens": 16},
                  {"scheduling": "slo"}):
        eng = ServeEngine(tm, tp, paged=True, **base, **extra)
        assert (eng.drafter, eng._chunk, eng.scheduling) == (
            extra.get("drafter"), extra.get("prefill_chunk_tokens"),
            extra.get("scheduling", "fifo"))
    # weight reloads are ported: the engine reads the new tree
    eng = ServeEngine(tm, tp, paged=True, **base)
    fresh = interop.tree_map(torch.clone, tp)
    eng.reload_params(fresh)
    assert eng.params is fresh
    with pytest.raises(ValueError, match="kernel"):
        ServeEngine(tm, tp, paged=True, attn_backend="kernel", **base)


def test_serve_cli_on_cpu(capsys):
    serve_cli.main(["--arch", "llama3-8b", "--smoke", "--paged", "--device",
                    "cpu", "--requests", "3", "--prompt-len", "12",
                    "--gen-len", "4", "--no-warmup"])
    out = capsys.readouterr().out
    assert "[serve] aggregate:" in out and "backend=torch" in out
    assert out.count("[serve]   req ") == 3
