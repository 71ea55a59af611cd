"""The port's dense-slot engine (``ServeEngine(paged=False)``) and its MoE
serving against ``repro.serve.ServeEngine``, on the CPU.

Both engines serve the same smoke config in float32 compute with the same
parameters (the reference's ``PRNGKey(0)`` tree, moved across by
:mod:`repro_torch.interop`) and the same seeded workloads under a frozen
clock. The bar: identical greedy tokens (f32: no tolerance), the same
slots and finish reasons, equal report counts, and equal request pricing.

The capacity-limited MoE (``capacity_factor`` 1.25, below the dropless
``n_experts / top_k``) is the strict case: 4 slots with fewer requests
live, so idle slots (fed token 0) take expert capacity beside the live
ones, and a live request's tokens depend on every idle row's cursor and
cache evolving as the reference's do. Its prompts are prefilled at their
exact lengths (padding is not exact there).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import poisson_workload as j_poisson
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine
from repro_torch.serve import engine as tengine
from repro_torch.serve import poisson_workload as t_poisson

MODELS = {"llama3": ("llama3-8b", {}),
          "moonshot": ("moonshot-v1-16b-a3b", {}),
          "moonshot-cf1.25": ("moonshot-v1-16b-a3b",
                              {"capacity_factor": 1.25})}
REPORT_KEYS = ("n_requests", "decode_steps", "total_new_tokens",
               "slot_reuse", "moa_flops_total")
PAGED_KEYS = ("admissions", "prefix_hits", "shared_block_hits",
              "peak_blocks_in_use", "cow_count", "gathered_kv_bytes",
              "fused_kv_bytes")


@pytest.fixture(scope="module")
def models():
    out = {}
    for key, (arch, upd) in MODELS.items():
        upd = dict(compute_dtype="float32", **upd)
        jm = jbuild(dataclasses.replace(jsmoke(jget(arch)), **upd))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(dataclasses.replace(tsmoke(tget(arch)), **upd))
        tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
        out[key] = (jm, jp, tm, tp)
    return out


def _workload(fn, vocab, n=5, seed=1):
    return fn(n_requests=n, vocab=vocab, rate_rps=20.0,
              prompt_len_range=(4, 12), gen_len_range=(3, 12), seed=seed)


def _staggered(cls, vocab):
    """Three requests at 0 into four slots: slot 3 stays idle, and slot 0
    goes idle after 3 tokens while slots 1 and 2 run on, so an idle row
    precedes live ones in the capacity ranks."""
    rng = np.random.default_rng(4)
    return [cls(uid=i, prompt=tuple(int(t) for t in rng.integers(0, vocab,
                                                                 p)),
                max_new_tokens=g)
            for i, (p, g) in enumerate(((5, 3), (9, 12), (7, 10)))]


def _serve_both(models, key, *, paged, warmup, n=5, seed=1,
                staggered=False):
    jm, jp, tm, tp = models[key]
    kw = dict(n_slots=4, max_len=32, paged=paged, block_size=16,
              prompt_buckets=(16, 32), clock=lambda: 0.0)
    if staggered:
        jreqs = _staggered(JRequest, jm.cfg.vocab)
        treqs = _staggered(TRequest, tm.cfg.vocab)
    else:
        jreqs = _workload(j_poisson, jm.cfg.vocab, n, seed)
        treqs = _workload(t_poisson, tm.cfg.vocab, n, seed)
    ref = JEngine(jm, jp, attn_backend="jnp", **kw)
    want, want_rep = ref.run(jreqs, warmup=warmup)
    port = ServeEngine(tm, tp, device="cpu", **kw)
    got, rep = port.run(treqs, warmup=warmup)
    return (want, want_rep), (got, rep), port


def _assert_same(want, want_rep, got, rep):
    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=str(a.uid))
        assert (b.slot, b.finish_reason.value) == \
            (a.slot, a.finish_reason.value)
        assert b.metrics.moa_flops == a.metrics.moa_flops > 0
    for key in REPORT_KEYS:
        assert rep[key] == want_rep[key], key


@pytest.mark.parametrize("key", ["llama3", "moonshot"])
def test_dense_slot_engine_matches_reference(models, key):
    (want, want_rep), (got, rep), port = _serve_both(
        models, key, paged=False, warmup=True)
    _assert_same(want, want_rep, got, rep)
    assert "paged" not in rep and "paged" not in want_rep
    assert port._padded and not port.paged


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_capacity_limited_moe_with_idle_slots(models, paged):
    """Three requests in four slots (:func:`_staggered`): at every tick at
    least one slot is idle, its row routed beside the live ones and, once
    slot 0 is free, ahead of them."""
    (want, want_rep), (got, rep), port = _serve_both(
        models, "moonshot-cf1.25", paged=paged, warmup=True,
        staggered=True)
    _assert_same(want, want_rep, got, rep)
    assert not port._padded and not port.model.supports_padded_prefill
    assert rep["slot_occupancy"] < 1.0
    if paged:
        assert not port._prefix_share and not port._match_tail
        for key in PAGED_KEYS:
            assert rep["paged"][key] == want_rep["paged"][key], key
        assert port._pool.in_use == 0


def test_idle_cursor_passes_max_len(models):
    """A long-lived request beside idle slots: the idle cursors advance
    past ``max_len`` (their writes dropped), still as the reference's."""
    jm, jp, tm, tp = models["moonshot-cf1.25"]
    kw = dict(n_slots=3, max_len=16, paged=False, clock=lambda: 0.0)

    def reqs(fn):
        return fn(n_requests=2, vocab=jm.cfg.vocab, rate_rps=1e9,
                  prompt_len_range=(3, 4), gen_len_range=(11, 12), seed=6)

    ref = JEngine(jm, jp, attn_backend="jnp", **kw)
    want, want_rep = ref.run(reqs(j_poisson), warmup=True)
    port = ServeEngine(tm, tp, device="cpu", **kw)
    got, rep = port.run(reqs(t_poisson), warmup=True)
    _assert_same(want, want_rep, got, rep)
    # the idle slot's cursor went past max_len: its writes were dropped
    assert int(port.cache["pos"][2]) > 16
    np.testing.assert_array_equal(port.cache["pos"].numpy(),
                                  np.asarray(ref.cache["pos"]))


def test_write_slot_read_slot_round_trip(models):
    """``_write_slot(_read_slot(cache, s), s)`` restores the row bit for
    bit (int8 cache and scales), through the eager and the device-slot
    forms alike, and a written prefill reads back unchanged."""
    _, _, tm, tp = models["llama3"]
    tm = tbuild(dataclasses.replace(tm.cfg, kv_cache_dtype="int8"))
    cache = tm.init_cache(3, 16, device="cpu")
    cache["pos"] = torch.tensor([5, 9, 2], dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    for name, leaf in cache["layers"].items():
        leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=g)
                   if leaf.dtype == torch.int8
                   else torch.rand(leaf.shape, generator=g))
    before = {n: t.clone() for n, t in cache["layers"].items()}
    snap = tengine._read_slot(cache, 1)
    assert snap["layers"]["k"].shape[1] == 1 and int(snap["pos"]) == 9
    other = tengine._read_slot(cache, 2)
    tengine._write_slot(cache, other, 1)               # clobber row 1
    assert torch.equal(cache["layers"]["k"][:, 1], before["k"][:, 2])
    tengine._write_slot(cache, snap, torch.tensor([1]))   # device slot
    for name, leaf in cache["layers"].items():
        assert torch.equal(leaf, before[name]), name
    assert cache["pos"].tolist() == [5, 9, 2]
    tengine._write_slot(cache, snap, 0)
    again = tengine._read_slot(cache, 0)
    for name in snap["layers"]:
        assert torch.equal(again["layers"][name], snap["layers"][name])
    assert int(again["pos"]) == 9


def test_repeated_scatter_targets_take_the_last_write():
    """``last_of_equal``: every write to a repeated target carries the last
    one's value, as the reference's scatter (JAX on the CPU) leaves it."""
    import jax.numpy as jnp

    from repro_torch.layers.attention import last_of_equal

    blk = torch.tensor([3, 0, 3, 0, 5, 3])
    off = torch.tensor([1, 1, 1, 2, 1, 1])
    assert last_of_equal(blk, off).tolist() == [5, 1, 5, 3, 4, 5]
    vals = torch.arange(6.0)
    got = torch.zeros((8, 4))
    got[blk, off] = vals[last_of_equal(blk, off)]
    want = jnp.zeros((8, 4)).at[jnp.asarray(blk.numpy()),
                                jnp.asarray(off.numpy())].set(
        jnp.arange(6.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _kernel_route(monkeypatch):
    """Resolve ``auto`` as the GPU does (the paged-attention kernel) in
    the engine's length checks alone: the layers still run the plain
    versions on the CPU."""
    monkeypatch.setattr(
        tengine, "resolve_attn_backend",
        lambda backend, device: "torch" if backend == "torch" else "kernel")


def test_fit_max_len_on_the_kernel_route(models, monkeypatch):
    """On the kernel route a dense-slot cache (the engine's, or an oracle
    drafter's beside a paged target) is walked in ``DENSE_PAGE``-token
    pages: ``fit_max_len`` rounds the CLI's default lengths up to whole
    pages, and the engine refuses at construction a length it could not
    walk, and an oracle over a pool of other blocks."""
    from repro_torch.serve import resolve_drafter

    _, _, tm, tp = models["llama3"]
    oracle = lambda: resolve_drafter("oracle", 3)  # noqa: E731
    fit = lambda n, **kw: tengine.fit_max_len(  # noqa: E731
        n, attn_backend="auto", device="cpu", **kw)
    # the CPU walks no pages: nothing changes there
    assert fit(194) == 194 and fit(200, drafter=oracle()) == 200
    _kernel_route(monkeypatch)
    assert fit(194) == 208 and fit(208) == 208
    assert fit(200, drafter=oracle()) == 208
    assert fit(194, paged=True) == 208
    assert fit(196, paged=True, block_size=4) == 196
    assert fit(196, paged=True, block_size=4, drafter=oracle()) == 208
    assert fit(200, paged=True, block_size=8,
               drafter=resolve_drafter("ngram?n=3", 3)) == 200
    assert tengine.fit_max_len(194, attn_backend="torch",
                               device="cpu") == 194
    kw = dict(n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="pages of 16 tokens"):
        ServeEngine(tm, tp, max_len=194, **kw)
    with pytest.raises(ValueError, match="pages of 16 tokens"):
        ServeEngine(tm, tp, max_len=200, paged=True, block_size=8,
                    drafter=oracle(), **kw)
    with pytest.raises(ValueError, match="not 8"):
        ServeEngine(tm, tp, max_len=208, paged=True, block_size=8,
                    drafter=oracle(), **kw)
    assert ServeEngine(tm, tp, max_len=208, **kw).max_len == 208
    assert ServeEngine(tm, tp, max_len=200, paged=True, block_size=8,
                       **kw).max_len == 200
    assert ServeEngine(tm, tp, max_len=194, attn_backend="torch",
                       **kw).max_len == 194


@pytest.mark.parametrize("extra", [[], ["--spec-decode", "--drafter",
                                        "oracle"], ["--replicas", "2"]],
                         ids=["dense-slot", "spec-oracle", "replicas"])
def test_serve_cli_default_lengths_on_the_kernel_route(monkeypatch, capsys,
                                                       extra):
    """The CLI's default lengths ((64 + 32 + 1) * 2 = 194, 200 with a
    speculative margin) on a dense-slot engine: the kernel route serves
    them at 208, a whole number of pages, where the CPU keeps them."""
    from repro_torch.launch import serve as cli

    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
            "--requests", "3"] + extra
    cli.main(argv)
    plain = 200 if extra[:1] == ["--spec-decode"] else 194
    assert f"max_len={plain} " in capsys.readouterr().out
    _kernel_route(monkeypatch)
    cli.main(argv)
    assert "max_len=208 " in capsys.readouterr().out
