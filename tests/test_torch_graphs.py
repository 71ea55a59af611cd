"""The port's CUDA-graph engine path (``repro_torch.serve.graphs``) on the
CPU.

A CUDA graph cannot be captured here, so a test double of the graph API
stands in for ``torch.cuda``'s (:class:`RecordingGraphs`: its capture
records the body and runs nothing, its replay runs the body). What the
tests hold is everything around the graphs: the capture bodies (the
device-side ``prompt_len`` prefill and the paged write with device-side
``slot``), when each bucket is captured, that no body runs twice on live
state, the launch accounting, that the cache tensors keep their
addresses, and a weight reload under graphs (every graph dropped and
captured again at its next call). On the card ``chip_smoke.py`` holds
the real graphs to the eager engine bit for bit.

Tolerances: the captured and the eager engine run the same operations on
the same values, so tokens, reports and logits must be equal bit for bit
(no tolerance). Against the JAX reference, f32 tokens must be identical
(as in ``tests/test_torch_serve.py``), and prefill logits lie within
``test_torch_model.py``'s ``atol=1e-4`` (f32 reassociation through 2
layers, logits of order 1).
"""

import collections
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
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
from repro_torch.kernels import _build, ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import ServeEngine, StepClock, graphs
from repro_torch.serve import bursty_workload as t_bursty
from repro_torch.serve import resolve_drafter
from repro_torch.serve import poisson_workload as t_poisson
from repro_torch.serve import shared_prefix_workload as t_shared

POOLS = {"bf16": {}, "int8": {"kv_cache_dtype": "int8"},
         "f32": {"compute_dtype": "float32"}}
ENGINE = dict(n_slots=3, max_len=64, paged=True, block_size=16,
              clock=lambda: 0.0)
ATOL = 1e-4      # test_torch_model.py's: f32 reassociation, logits O(1)


class RecordingGraphs:
    """Test double of :class:`repro_torch.serve.graphs.TorchGraphs`: its
    capture records the body and runs nothing; its replay runs the body
    on the CPU tensors."""

    def __init__(self):
        self.captured = []

    def supports(self, device):
        return True

    def new_stream(self, device):
        return None

    def new_pool(self):
        return None

    def on(self, stream):
        return contextlib.nullcontext()

    def capture(self, body, *, stream, pool):
        self.captured.append(body)
        return body

    def bound_buffers(self, stream):
        return []

    def pool_bytes(self, pool):
        return 0


class PythonAtCapture(RecordingGraphs):
    """Like a real capture: the body's Python (the wrappers' counters too)
    runs once at capture, and a replay runs no Python."""

    def capture(self, body, *, stream, pool):
        out = body()
        return lambda: out


@pytest.fixture
def recording(monkeypatch):
    api = RecordingGraphs()
    monkeypatch.setattr(graphs, "API", api)
    return api


@pytest.fixture(scope="module")
def models():
    """Per pool: the reference's model and ``PRNGKey(0)`` parameters, and
    the port's model with the same parameters."""
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


def _workload(which, vocab, fns=(t_poisson, t_shared)):
    poisson, shared = fns
    if which == "poisson":
        return poisson(n_requests=7, vocab=vocab, rate_rps=100.0,
                       prompt_len_range=(4, 30), gen_len_range=(3, 10),
                       seed=1)
    return shared(n_requests=7, vocab=vocab, rate_rps=100.0, n_prefixes=2,
                  prefix_len=16, suffix_len_range=(0, 6),
                  gen_len_range=(3, 8), seed=7)


def _record_logits(engine, out):
    """Record each request's next-token logits by ``(uid, step)`` where
    the engine samples them (the first token in ``_seed``, each decode
    step's in ``_sample``)."""
    seed, sample = engine._seed, engine._sample

    def _seed(slot, req, logits, *rest):
        out[(req.uid, 0)] = logits[0, -1].clone()
        return seed(slot, req, logits, *rest)

    def _sample(logits, temps, greedy):
        for slot, inf in engine._inflight.items():
            out[(inf.request.uid, len(inf.generated))] = logits[slot].clone()
        return sample(logits, temps, greedy)

    engine._seed, engine._sample = _seed, _sample


def _cache_ptrs(engine):
    leaves = dict(engine.cache["layers"])
    leaves.update(block_tables=engine.cache["block_tables"],
                  pos=engine.cache["pos"])
    return {name: t.data_ptr() for name, t in leaves.items()}


# ---------------------------------------------------------------------------
# (a) the captured engine's tokens, reports and logits equal the eager one's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("workload", ["poisson", "shared_prefix"])
def test_captured_engine_equals_eager(models, recording, pool, workload):
    jm, jp, tm, tp = models[pool]
    runs = {}
    for cuda_graphs in (False, True):
        engine = ServeEngine(tm, tp, device="cpu", cuda_graphs=cuda_graphs,
                             **ENGINE)
        logits = {}
        _record_logits(engine, logits)
        results, report = engine.run(_workload(workload, tm.cfg.vocab))
        runs[cuda_graphs] = results, report, logits
    (want, want_rep, want_logits), (got, rep, got_logits) = \
        runs[False], runs[True]
    assert rep["cuda_graphs"] and not want_rep["cuda_graphs"]
    assert rep["graphs"]["replays"] > 0 and want_rep["graphs"] is None
    for key in set(rep) - {"cuda_graphs", "graphs"}:
        assert rep[key] == want_rep[key], key
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.uid, a.slot, a.finish_reason) == \
            (b.uid, b.slot, b.finish_reason)
    assert got_logits.keys() == want_logits.keys()
    for key, x in want_logits.items():
        assert torch.equal(got_logits[key], x), key
    if workload == "shared_prefix":
        assert rep["paged"]["prefix_hits"] > 0
    if pool == "f32":
        ref = JEngine(jm, jp, attn_backend="jnp", **ENGINE)
        jwant, _ = ref.run(_workload(workload, jm.cfg.vocab,
                                     (j_poisson, j_shared)))
        for a, b in zip(jwant, got):
            np.testing.assert_array_equal(a.tokens, b.tokens)


GRAPH_MODELS = [("llama3-8b", {}, False),
                ("moonshot-v1-16b-a3b", {}, False),
                ("moonshot-v1-16b-a3b", {"capacity_factor": 1.25}, False),
                ("moonshot-v1-16b-a3b", {}, True),
                ("moonshot-v1-16b-a3b", {"capacity_factor": 1.25}, True)]


@pytest.mark.parametrize("arch,upd,paged", GRAPH_MODELS,
                         ids=["llama3-dense", "moe-dense", "moe-cf1.25-dense",
                              "moe-paged", "moe-cf1.25-paged"])
def test_dense_slot_and_moe_capture_equals_eager(recording, arch, upd,
                                                 paged):
    """The dense-slot engine (and the MoE in both layouts) through the
    double: tokens, reports and every step's logits equal the eager
    engine's bit for bit. The dense-slot decode is one graph (bucket 0);
    a padded prefill is captured per bucket with its slot write, an
    exact-length one (capacity-limited MoE) stays eager."""
    tm = tbuild(dataclasses.replace(tsmoke(tget(arch)), **upd))
    tp = tm.init(seed=0, device="cpu")
    kw = dict(ENGINE, paged=paged, n_slots=4)
    runs = {}
    for cuda_graphs in (False, True):
        engine = ServeEngine(tm, tp, device="cpu", cuda_graphs=cuda_graphs,
                             **kw)
        logits = {}
        _record_logits(engine, logits)
        results, report = engine.run(_workload("poisson", tm.cfg.vocab),
                                     warmup=True)
        runs[cuda_graphs] = results, report, logits, engine
    (want, want_rep, want_logits, _), (got, rep, got_logits, eng) = \
        runs[False], runs[True]
    for key in set(rep) - {"cuda_graphs", "graphs", "compile_s", "wall_s"}:
        assert rep[key] == want_rep[key], key
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert got_logits.keys() == want_logits.keys()
    for key, x in want_logits.items():
        assert torch.equal(got_logits[key], x), key
    cache = eng._graphs
    decode = {hw for path, hw in cache.captures if path == "decode"}
    prefill = {b for path, b in cache.captures if path == "prefill"}
    assert decode == (set(eng._hw_buckets()) if paged else {0})
    assert prefill == (set(eng.scheduler.buckets) if eng._padded else set())
    assert set(cache.captures.values()) == {1}
    assert rep["graphs"]["replays"] > 0


# ---------------------------------------------------------------------------
# (b) when each bucket is captured; no body runs twice on live state
# ---------------------------------------------------------------------------


def test_warmup_captures_every_bucket_once(models, recording):
    _, _, tm, tp = models["bf16"]
    engine = ServeEngine(tm, tp, device="cpu", **ENGINE)
    engine.start_run(warmup=True)
    cache = engine._graphs
    keys = {("prefill", b) for b in engine.scheduler.buckets} | \
        {("decode", hw) for hw in engine._hw_buckets()}
    assert len(keys) == 7           # prompt buckets 8..64, blocks 1, 2, 4
    once = collections.Counter(dict.fromkeys(keys, 1))
    assert cache.captures == once and cache.eager_runs == once
    assert len(recording.captured) == len(keys) and not cache.replays
    _, report = engine.run(_workload("poisson", tm.cfg.vocab))
    assert cache.captures == once and cache.eager_runs == once
    assert report["graphs"]["replays"] == sum(cache.replays.values()) > 0
    assert set(cache.replays) <= keys


def test_first_tick_of_a_bucket_is_captured_once(models, recording):
    _, _, tm, tp = models["int8"]
    engines = [ServeEngine(tm, tp, device="cpu", cuda_graphs=g, **ENGINE)
               for g in (False, True)]
    for engine in engines:
        engine.start_run()
        for req in _workload("poisson", tm.cfg.vocab):
            engine.submit(req)
    eager, captured = engines
    results = [[], []]
    ticks = 0
    while not eager.scheduler.done:
        for engine, out in zip(engines, results):
            engine.tick(out)
        ticks += 1
        # a body run twice would advance a cursor twice
        for name in ("pos", "block_tables"):
            assert torch.equal(captured.cache[name], eager.cache[name]), \
                (ticks, name)
    assert captured.scheduler.done
    cache = captured._graphs
    assert set(cache.captures.values()) == {1}
    assert cache.eager_runs == cache.captures
    _, report = captured.finish_run(results[1])
    runs = cache.eager_runs + cache.replays     # each body run, by key
    assert report["paged"]["prefix_hits"] == 0
    assert sum(n for (path, _), n in runs.items() if path == "decode") \
        == report["decode_steps"]
    assert sum(n for (path, _), n in runs.items() if path == "prefill") \
        == report["paged"]["admissions"]


# ---------------------------------------------------------------------------
# (c) launch accounting
# ---------------------------------------------------------------------------


def _stub_decode(tokens, hw):
    """A decode body that only bumps the wrappers' counters, as the
    wrappers do where they launch: 3 ``dot_moa`` and 1 ``paged_attention``
    a step."""
    ops.dot_moa_cuda.launches += 3
    ops.paged_attention_cuda.launches += 1
    return torch.zeros((tokens.shape[0], 1, 5))


def _stub_cache(monkeypatch, api):
    monkeypatch.setattr(graphs, "API", api)
    return graphs.GraphCache(_stub_decode, None, n_slots=2, max_blocks=2,
                             max_bucket=16, device=torch.device("cpu"))


def test_capture_adds_no_launches_and_replay_adds_recorded(monkeypatch):
    cache = _stub_cache(monkeypatch, PythonAtCapture())
    toks = np.zeros((2, 1), np.int32)
    ops.reset_launch_counts()
    try:
        cache.decode(1, toks)       # the eager first run, then the capture
        counts = ops.launch_counts()
        assert counts["dot_moa"] == 3 and counts["paged_attention"] == 1
        assert cache._graphs[("decode", 1)].launches == dict(
            counts, dot_moa=3, paged_attention=1)
        for n in (2, 3):            # replays run no Python
            cache.decode(1, toks)
            counts = ops.launch_counts()
            assert counts["dot_moa"] == 3 * n
            assert counts["paged_attention"] == n
            assert sum(counts.values()) == 4 * n
        assert cache.replays[("decode", 1)] == 2
    finally:
        ops.reset_launch_counts()


def test_failed_capture_raises_and_restores_counts(monkeypatch):
    class Broken(PythonAtCapture):
        def capture(self, body, *, stream, pool):
            body()
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    cache = _stub_cache(monkeypatch, Broken())
    ops.reset_launch_counts()
    try:
        with pytest.raises(RuntimeError, match="capturing"):
            cache.decode(1, np.zeros((2, 1), np.int32))
        # the eager run's launches stay, the failed capture's are undone,
        # and nothing was kept to replay
        counts = ops.launch_counts()
        assert counts["dot_moa"] == 3 and counts["paged_attention"] == 1
        assert not cache._graphs and not cache.captures
    finally:
        ops.reset_launch_counts()


def test_workspace_refuses_to_grow_during_capture(monkeypatch):
    monkeypatch.setattr(_build, "_WORKSPACE", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="during CUDA graph capture"):
        _build.workspace(0, 7, 1024, 4)
    with pytest.raises(RuntimeError, match="dot_moa"):
        _build.workspace(0, 7, 1024, owner="dot_moa")
    # a pair that already covers the call is handed out, capturing or not
    ws, tk = torch.empty(256, dtype=torch.int32), torch.zeros(
        4, dtype=torch.int32)
    _build._WORKSPACE[(0, 7, "shared")] = ws, tk
    assert _build.workspace(0, 7, 1024, 4) == (ws, tk)
    assert [t.data_ptr() for t in _build.stream_workspaces(0, 7)] == \
        [ws.data_ptr(), tk.data_ptr()]
    assert _build.stream_workspaces(0, 8) == []


# ---------------------------------------------------------------------------
# (d) the prefill with a device-side prompt_len
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_device_prompt_len_prefill(kv):
    upd = dict(compute_dtype="float32",
               kv_cache_dtype="int8" if kv == "int8" else "bfloat16")
    jm = jbuild(dataclasses.replace(jsmoke(jget("llama3-8b")), **upd))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(dataclasses.replace(tsmoke(tget("llama3-8b")), **upd))
    tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    max_len, toks = 48, np.zeros((1, 32), np.int32)
    for p in (1, 21, 32):
        toks[0, :p] = np.random.default_rng(p).integers(0, 257, p)
        batch = {"tokens": torch.from_numpy(toks)}
        want, want_c = tm.prefill(tp, batch, max_len=max_len, prompt_len=p)
        got, got_c = tm.prefill(tp, batch, max_len=max_len,
                                prompt_len=torch.tensor(p,
                                                        dtype=torch.int32))
        assert torch.equal(got, want)
        assert got_c["pos"].dtype == torch.int32 and got_c["pos"].dim() == 0
        assert int(got_c["pos"]) == want_c["pos"] == p
        for name, leaf in want_c["layers"].items():
            assert torch.equal(got_c["layers"][name], leaf), name
        jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                           max_len=max_len, prompt_len=p)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# (e) static addresses, (f) the knob
# ---------------------------------------------------------------------------


def test_cache_tensors_keep_their_addresses(models, recording):
    _, _, tm, tp = models["bf16"]
    engine = ServeEngine(tm, tp, device="cpu", cuda_graphs=True, **ENGINE)
    ptrs, cache = _cache_ptrs(engine), engine.cache
    engine.start_run(warmup=True)
    for req in _workload("shared_prefix", tm.cfg.vocab):
        engine.submit(req)
    results = []
    while not engine.scheduler.done:
        engine.tick(results)
        assert engine.cache is cache and _cache_ptrs(engine) == ptrs
    _, report = engine.finish_run(results)
    assert report["paged"]["prefix_hits"] > 0
    assert report["paged"]["admissions"] == len(results) == 7
    assert engine._pool.in_use == 0          # every request released


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense-slot"])
def test_reload_under_graphs(models, recording, paged):
    """``reload_params`` on a captured engine. Each reload rebinds the
    weights to the new tree, so every graph is dropped and captured again
    at its next call; no tree is written (the caller's stays as it was)
    and the cache keeps its addresses. After each reload the engine serves
    as an eager engine built on the new weights, bit for bit (tokens and
    every step's logits)."""
    _, _, tm, tp = models["f32"]
    kw = dict(ENGINE, paged=paged)
    p1 = tm.init(seed=1, device="cpu")
    kept = interop.tree_map(torch.clone, tp)

    def served(engine):
        logits = {}
        _record_logits(engine, logits)
        results, _ = engine.run(_workload("poisson", tm.cfg.vocab))
        return [r.tokens.tolist() for r in results], logits

    def same(got, want):
        assert got[0] == want[0]
        assert got[1].keys() == want[1].keys()
        for key, x in want[1].items():
            assert torch.equal(got[1][key], x), key

    engine = ServeEngine(tm, tp, device="cpu", cuda_graphs=True, **kw)
    engine.run([], warmup=True)
    cache_ptrs = _cache_ptrs(engine) if paged else None
    for drops, new in enumerate((p1, kept), start=1):
        captures = sum(engine._graphs.captures.values())
        assert captures > 0
        engine.reload_params(new)
        assert engine._graphs.drops == drops and not engine._graphs._graphs
        assert engine.params is new
        same(served(engine), served(ServeEngine(tm, new, device="cpu",
                                                cuda_graphs=False, **kw)))
        assert sum(engine._graphs.captures.values()) == captures + len(
            engine._graphs._graphs)
        for (_, a), (_, b) in zip(interop.tree_leaves(tp),
                                  interop.tree_leaves(kept)):
            assert torch.equal(a, b)            # the caller's tree
        if paged:
            assert _cache_ptrs(engine) == cache_ptrs


def test_cuda_graphs_knob_on_the_cpu(models):
    _, _, tm, tp = models["bf16"]
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA"):
        ServeEngine(tm, tp, device="cpu", cuda_graphs=True, **ENGINE)
    for knob in (None, False):
        assert ServeEngine(tm, tp, device="cpu", cuda_graphs=knob,
                           **ENGINE)._graphs is None


def test_serve_cli_eager_flag(capsys):
    serve_cli.main(["--arch", "llama3-8b", "--smoke", "--paged", "--device",
                    "cpu", "--requests", "2", "--prompt-len", "12",
                    "--gen-len", "3", "--no-warmup", "--eager"])
    out = capsys.readouterr().out
    assert "path=eager" in out and "[serve] graphs:" not in out


# ---------------------------------------------------------------------------
# (g) the speculative verify, chunked prefill and SLO spills
# ---------------------------------------------------------------------------


def _record_verify(engine, out):
    """Record every verify tick's logits (in order) where the engine
    accepts them."""
    accept = engine._accept

    def _accept(logits, *rest):
        out.append(logits.clone())
        return accept(logits, *rest)

    engine._accept = _accept


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("warmup", [False, True])
def test_spec_capture_equals_eager(models, recording, paged, warmup):
    """The speculative engine through the double: tokens, reports and every
    verify tick's logits equal the eager engine's bit for bit. The verify
    is captured once per live-block bucket (dense-slot: once), at warmup
    or at a bucket's first tick, beside the prefill's graphs; no decode
    graph is made."""
    _, _, tm, tp = models["f32"]
    kw = dict(ENGINE, paged=paged)
    runs = {}
    for cuda_graphs in (False, True):
        engine = ServeEngine(tm, tp, device="cpu", cuda_graphs=cuda_graphs,
                             drafter=resolve_drafter("oracle?accept=0.5", 3),
                             **kw)
        ticks = []
        _record_verify(engine, ticks)
        results, report = engine.run(_workload("poisson", tm.cfg.vocab),
                                     warmup=warmup)
        runs[cuda_graphs] = results, report, ticks, engine
    (want, want_rep, want_ticks, _), (got, rep, got_ticks, eng) = \
        runs[False], runs[True]
    for key in set(rep) - {"cuda_graphs", "graphs", "compile_s", "wall_s"}:
        assert rep[key] == want_rep[key], key
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    # the warmup's verify is accepted once too
    assert len(got_ticks) == len(want_ticks) == \
        rep["spec"]["verify_ticks"] + warmup
    for i, (x, y) in enumerate(zip(want_ticks, got_ticks)):
        assert torch.equal(x, y), i
    cache = eng._graphs
    assert {path for path, _ in cache.captures} == {"prefill", "verify"}
    verify = {hw for path, hw in cache.captures if path == "verify"}
    if warmup:
        assert verify == (set(eng._hw_buckets()) if paged else {0})
    assert set(cache.captures.values()) == {1}
    assert cache.eager_runs == cache.captures
    assert sum(n for (path, _), n in (cache.eager_runs + cache.replays)
               .items() if path == "verify") == rep["decode_steps"] + (
        len(verify) if warmup else 0)


def test_verify_launches_recorded_and_replayed(monkeypatch):
    """A verify graph's launches are recorded at capture and added at each
    replay, as a decode graph's: here 7 ``dot_moa`` and 1
    ``paged_attention`` (T = k + 1) a verify."""
    def verify(tokens, hw):
        ops.dot_moa_cuda.launches += 7
        ops.paged_attention_cuda.launches += 1
        return torch.zeros((tokens.shape[0], tokens.shape[1], 5))

    monkeypatch.setattr(graphs, "API", PythonAtCapture())
    cache = graphs.GraphCache(_stub_decode, None, verify, n_slots=2,
                              max_blocks=2, max_bucket=16, window=4,
                              device=torch.device("cpu"))
    toks = np.zeros((2, 4), np.int32)
    ops.reset_launch_counts()
    try:
        assert cache.verify(2, toks).shape == (2, 4, 5)
        for n in (2, 3):
            cache.verify(2, toks)
            counts = ops.launch_counts()
            assert counts["dot_moa"] == 7 * n
            assert counts["paged_attention"] == n
        assert cache.report()["launches_per_replay"] == {
            "verify": {"dot_moa": 7, "paged_attention": 1}}
        with pytest.raises(RuntimeError):    # the window is fixed
            cache.verify(2, np.zeros((2, 3), np.int32))
    finally:
        ops.reset_launch_counts()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_slo_and_chunks_keep_cache_addresses(models, recording, paged):
    """Chunks, spills and revives run eagerly beside the graphs and
    reassign no cache tensor; the captured SLO run's tokens and schedule
    equal the eager one's."""
    _, _, tm, tp = models["f32"]
    kw = dict(n_slots=2, max_len=64, paged=paged, block_size=8,
              scheduling="slo", prefill_chunk_tokens=8)
    wl = dict(vocab=tm.cfg.vocab, n_long=2, n_burst=4, long_prompt_len=16,
              long_gen_len=40, burst_prompt_len=8, burst_gen_len=4,
              burst_at_s=0.004, burst_deadline_s=0.02, seed=0)
    runs = {}
    for cuda_graphs in (False, True):
        engine = ServeEngine(tm, tp, device="cpu", cuda_graphs=cuda_graphs,
                             clock=StepClock(dt=1e-3), **kw)
        leaves = dict(engine.cache["layers"], pos=engine.cache["pos"])
        if paged:
            leaves["block_tables"] = engine.cache["block_tables"]
        ptrs = {n: t.data_ptr() for n, t in leaves.items()}
        cache = engine.cache
        engine.start_run(warmup=True)
        for req in t_bursty(**wl):
            engine.submit(req)
        results = []
        while not engine.scheduler.done:
            engine.tick(results)
            assert engine.cache is cache
            assert {n: t.data_ptr() for n, t in leaves.items()} == ptrs
            assert all(engine.cache["layers"][n] is leaves[n]
                       for n in engine.cache["layers"])
        runs[cuda_graphs] = engine.finish_run(results)
    (want, want_rep), (got, rep) = runs[False], runs[True]
    assert rep["slo"] == want_rep["slo"] and rep["slo"]["preemptions"] > 0
    assert rep["slo"]["prefill_chunk_count"] > 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_capture_pauses_garbage_collection(monkeypatch):
    """A capture runs with the cyclic garbage collector paused (a
    collection that destroys another graph mid-capture invalidates it on
    the card), and the collector is back on afterwards."""
    import gc

    seen = []

    class Watching(RecordingGraphs):
        def capture(self, body, *, stream, pool):
            seen.append(gc.isenabled())
            return body

    monkeypatch.setattr(graphs, "API", Watching())
    cache = graphs.GraphCache(lambda toks, hw: torch.zeros(1), None, None,
                              n_slots=1, max_blocks=0, max_bucket=1,
                              window=1, device=torch.device("cpu"))
    assert gc.isenabled()
    cache.decode(0, np.zeros((1, 1), np.int32))
    assert seen == [False] and gc.isenabled()

