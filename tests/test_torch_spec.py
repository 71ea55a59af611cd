"""The port's speculative verify, acceptance rule, drafters and spec costing
against the JAX reference, on the CPU.

Both packages build the smoke config of llama3-8b or of moonshot-v1-16b-a3b
(dropless: the smoke capacity factor 8.0 is at least its ``n_experts /
top_k``); the reference's parameters
(``PRNGKey(0)``) cross into the port through :mod:`repro_torch.interop`,
and every cache, token and logit is made from a seeded numpy generator.

Tolerances. f32 compute (the f32 and int8 pools): logits within
``test_torch_model.py``'s ``atol=1e-4`` (f32 reassociation through 2
layers, logits of order 1), against the reference's verify and against the
port's own T sequential decode steps. bf16 compute (the bf16 pool): the
two packages round to bf16 after sums taken in different orders, so a
logit moves by about one bf16 ulp of the hidden state through the
unembedding: within ``test_torch_serve.py``'s 0.05. Greedy acceptance, the
n-gram lookup and the costing are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.launch import costing as jcost
from repro.models.api import build_model as jbuild
from repro.serve import NgramDrafter as JNgram
from repro.serve import resolve_drafter as j_resolve
from repro.serve import verify_accept as j_accept
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.launch import costing as tcost
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import (NgramDrafter, OracleDrafter, ServeEngine,
                               resolve_drafter, verify_accept)

ATOL = 1e-4      # test_torch_model.py's: f32 reassociation, logits O(1)
BF16_ATOL = 0.05  # test_torch_serve.py's bf16 bound: one ulp of the hidden
POOLS = {"f32": {"compute_dtype": "float32"},
         "int8": {"compute_dtype": "float32", "kv_cache_dtype": "int8"},
         "bf16": {}}
ARCHS = ["llama3-8b", "moonshot-v1-16b-a3b"]
_BUILT = {}


def _pair(arch, pool, **extra):
    """The reference's model and ``PRNGKey(0)`` parameters, and the port's
    model with the same parameters (module-cached)."""
    key = (arch, pool, tuple(sorted(extra.items())))
    if key not in _BUILT:
        upd = dict(POOLS[pool], **extra)
        jm = jbuild(dataclasses.replace(jsmoke(jget(arch)), **upd))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(dataclasses.replace(tsmoke(tget(arch)), **upd))
        tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
        _BUILT[key] = jm, jp, tm, tp
    return _BUILT[key]


def _random_layers(leaves: dict, seed: int) -> dict:
    """Random cache contents in each leaf's type (int8 codes, f32 scales)."""
    rs = np.random.default_rng(seed)
    out = {}
    for name, leaf in leaves.items():
        shape, dt = leaf.shape, np.asarray(leaf).dtype
        if dt == np.int8:
            out[name] = rs.integers(-127, 128, shape).astype(np.int8)
        elif name.endswith("_scale"):
            out[name] = rs.uniform(0.01, 0.05, shape).astype(np.float32)
        else:
            out[name] = (0.5 * rs.standard_normal(shape)).astype(dt)
    return out


def _caches(jm, tm, paged: bool):
    """The same staggered cache in both packages: slots at cursors 5, 19
    and 30 of ``max_len`` 32 (dense-slot: the last slot's window runs past
    the end, whose rows are dropped); paged, the third slot idle on an
    all-trash table at cursor 0, as the engine leaves a freed slot."""
    n_slots, max_len, bs = 3, 32, 8
    if paged:
        jc = jm.init_paged_cache(n_slots, 12, bs, max_len // bs)
        tables = np.asarray([[3, 7, 1, 0], [2, 5, 9, 11], [0, 0, 0, 0]],
                            np.int32)
        pos = np.asarray([5, 19, 0], np.int32)
    else:
        jc = jm.init_cache(n_slots, max_len)
        tables = None
        pos = np.asarray([5, 19, 30], np.int32)
    layers = _random_layers(jc["layers"], seed=7)
    jcache = {"layers": {n: jnp.asarray(a) for n, a in layers.items()},
              "pos": jnp.asarray(pos)}
    tcache = (tm.init_paged_cache(n_slots, 12, bs, max_len // bs,
                                  device="cpu") if paged
              else tm.init_cache(n_slots, max_len, device="cpu"))
    for n, a in interop.from_numpy(layers, device="cpu").items():
        tcache["layers"][n].copy_(a)
    tcache["pos"] = torch.from_numpy(pos.copy())
    if paged:
        jcache["block_tables"] = jnp.asarray(tables)
        tcache["block_tables"].copy_(torch.from_numpy(tables))
    return jcache, tcache


def _clone(cache):
    return interop.tree_map(torch.clone, cache)


# ---------------------------------------------------------------------------
# verify logits: the reference's verify, and the port's own decode steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_logits(arch, paged, pool, T):
    """``verify_step`` / ``paged_verify_step`` on a staggered cache: the
    port's logits equal the reference's, and its own T sequential decode
    steps; the written rows equal the reference's; ``pos`` stays, and a
    full-window commit lands on the sequential cursor."""
    jm, jp, tm, tp = _pair(arch, pool)
    atol = BF16_ATOL if pool == "bf16" else ATOL
    jcache, tcache = _caches(jm, tm, paged)
    toks = np.random.default_rng(T).integers(0, tm.cfg.vocab, (3, T),
                                             dtype=np.int32)
    live = [0, 1] if paged else [0, 1, 2]
    if paged:
        jl, jc, _ = jm.paged_verify_step(jp, jcache, jnp.asarray(toks),
                                         live_blocks=4)
        tl, tc, aux = tm.paged_verify_step(tp, _clone(tcache),
                                           torch.from_numpy(toks),
                                           live_blocks=4)
    else:
        jl, jc, _ = jm.verify_step(jp, jcache, jnp.asarray(toks))
        tl, tc, aux = tm.verify_step(tp, _clone(tcache),
                                     torch.from_numpy(toks))
    assert aux is None and tl.shape == (3, T, tm.cfg.vocab)
    np.testing.assert_allclose(tl[live].float().numpy(),
                               np.asarray(jl, np.float32)[live], atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for name, leaf in jc["layers"].items():
        want = np.asarray(leaf.astype(jnp.float32) if leaf.dtype != jnp.int8
                          else leaf)
        got = tc["layers"][name].float().numpy()
        if paged:   # the trash page 0 is garbage to live slots
            want, got = want[:, 1:], got[:, 1:]
        if leaf.dtype == jnp.int8:
            # round-half-even of nearly equal values may step by one code
            assert np.abs(got - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                       err_msg=name)
    # the port's own T decode steps from the same cache
    seq = _clone(tcache)
    step = tm.paged_decode_step if paged else tm.decode_step
    for i in range(T):
        lg, seq = step(tp, seq, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(tl[live, i].float().numpy(),
                                   lg[live, 0].float().numpy(), atol=atol,
                                   rtol=0, err_msg=f"step {i}")
    committed = tm.commit_verified(tc, torch.full((3,), T,
                                                  dtype=torch.int32))
    np.testing.assert_array_equal(committed["pos"].numpy()[live],
                                  seq["pos"].numpy()[live])


def test_verify_lockstep_cursor_equals_reference():
    """A dense-slot cache with one 0-d cursor for the whole batch (as
    ``init_cache`` makes it): the verify broadcasts it, and the commit
    turns it into the reference's ``(B,)`` cursor."""
    jm, jp, tm, tp = _pair("llama3-8b", "f32")
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    layers = _random_layers(jc["layers"], seed=3)
    jc = {"layers": {n: jnp.asarray(a) for n, a in layers.items()},
          "pos": jnp.asarray(5, jnp.int32)}
    for n, a in interop.from_numpy(layers, device="cpu").items():
        tc["layers"][n].copy_(a)
    tc["pos"] = torch.tensor(5, dtype=torch.int32)
    toks = np.asarray([[3, 1, 4], [1, 5, 9]], np.int32)
    jl, jv, jaux = jm.verify_step(jp, jc, jnp.asarray(toks))
    tl, tv, taux = tm.verify_step(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    keep = np.asarray([2, 3], np.int32)
    want = jm.commit_verified(jv, jnp.asarray(keep), jaux)["pos"]
    got = tm.commit_verified(tv, torch.from_numpy(keep), taux)["pos"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_verify_out_of_range_rows_are_dropped():
    """A dense-slot window past ``max_len`` writes nothing there and
    leaves every other row of the slot as the in-range rows put it (the
    reference drops such rows); a slot wholly past the end writes
    nothing."""
    _, _, tm, tp = _pair("llama3-8b", "f32")
    cache = tm.init_cache(2, 8, device="cpu")
    for leaf in cache["layers"].values():
        leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator()
                               .manual_seed(0)))
    before = _clone(cache)
    cache["pos"] = torch.tensor([6, 9], dtype=torch.int32)
    toks = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    tm.verify_step(tp, cache, toks)
    for name, leaf in cache["layers"].items():
        old = before["layers"][name]
        assert torch.equal(leaf[:, 0, :6], old[:, 0, :6]), name
        assert not torch.equal(leaf[:, 0, 6:], old[:, 0, 6:]), name
        assert torch.equal(leaf[:, 1], old[:, 1]), name
    assert cache["pos"].tolist() == [6, 9]


def test_capacity_limited_moe_refuses_verify():
    """A capacity-limited MoE has no exact multi-token verify: its verify,
    paged verify and a drafter engine raise the reference's ValueError."""
    jm, _, tm, tp = _pair("moonshot-v1-16b-a3b", "f32", capacity_factor=1.25)
    assert not jm.supports_spec_decode and not tm.supports_spec_decode
    assert not tm.supports_chunked_prefill
    toks = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="verify"):
        tm.verify_step(tp, tm.init_cache(2, 16, device="cpu"), toks)
    with pytest.raises(ValueError, match="verify"):
        tm.paged_verify_step(tp, tm.init_paged_cache(2, 5, 8, 2,
                                                     device="cpu"), toks)
    for paged in (False, True):
        with pytest.raises(ValueError, match="supports_spec_decode"):
            ServeEngine(tm, tp, n_slots=2, max_len=32, paged=paged,
                        block_size=8, device="cpu",
                        drafter=OracleDrafter(2))
    assert _pair("moonshot-v1-16b-a3b", "f32")[2].supports_spec_decode


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_accept_greedy_rows_equal_reference(seed):
    """Greedy rows: ``out`` and ``n_acc`` equal the reference's bit for
    bit, on random logits with planted ties (argmax takes the first) and
    drafts that match the argmax up to a random point."""
    rs = np.random.default_rng(seed)
    B, T, V = 6, 4, 11
    logits = rs.standard_normal((B, T, V)).astype(np.float32)
    logits[0, 1, [2, 5]] = logits[0, 1].max() + 1.0     # a tie
    g = logits.argmax(-1)
    draft = rs.integers(0, V, (B, T - 1)).astype(np.int32)
    for b in range(B):
        n = rs.integers(0, T)
        draft[b, :n] = g[b, :n]
    args = (np.zeros((B,), np.float32), np.ones((B,), bool))
    jo, jn = j_accept(jnp.asarray(logits), jnp.asarray(draft),
                      *map(jnp.asarray, args), jax.random.PRNGKey(0))
    to, tn = verify_accept(torch.from_numpy(logits), torch.from_numpy(draft),
                           *map(torch.from_numpy, args), None)
    assert to.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_verify_accept_temperature_degenerate():
    """With the target distribution collapsed onto single tokens,
    temperature acceptance is forced, as in the reference's test: matching
    drafts accepted, a mismatch rejected with the residual sample equal to
    the target token; a greedy row beside them stays exact."""
    vocab, peak = 7, 200.0
    g = torch.tensor([[1, 2, 3], [4, 5, 6], [0, 1, 2]])
    logits = peak * torch.nn.functional.one_hot(g, vocab).float()
    draft = torch.tensor([[1, 2], [0, 5], [0, 3]], dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)
    out, n_acc = verify_accept(logits, draft, torch.tensor([0.7, 0.7, 0.0]),
                               torch.tensor([False, False, True]), gen)
    assert n_acc.tolist() == [2, 0, 1]
    assert out[0].tolist() == [1, 2, 3]
    assert int(out[1, 0]) == 4
    assert out[2].tolist() == [0, 1, 2]


def test_verify_accept_temperature_is_seeded():
    rs = np.random.default_rng(4)
    logits = torch.from_numpy(rs.standard_normal((4, 3, 9)).astype(
        np.float32))
    draft = torch.from_numpy(rs.integers(0, 9, (4, 2)).astype(np.int32))
    temps, greedy = torch.full((4,), 0.9), torch.zeros((4,), dtype=bool)
    runs = [verify_accept(logits, draft, temps, greedy,
                          torch.Generator().manual_seed(s))
            for s in (5, 5)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------


def test_ngram_lookups_equal_reference():
    """The reference's own cases, then random histories over a small
    vocabulary (many repeats), each against the reference's drafter."""
    d = NgramDrafter(3, max_ngram=2)
    assert d.propose({0: [7, 8, 9, 1, 2, 3, 7, 8]})[0] == [9, 1, 2]
    assert d.propose({1: [1, 2, 3]})[1] == [3, 3, 3]
    rs = np.random.default_rng(0)
    for k, n in ((1, 1), (3, 2), (4, 3)):
        hists = {s: rs.integers(0, 5, rs.integers(1, 30)).tolist()
                 for s in range(20)}
        assert NgramDrafter(k, max_ngram=n).propose(hists) == \
            JNgram(k, max_ngram=n).propose(hists)


def test_resolve_drafter_specs_and_errors():
    assert isinstance(resolve_drafter("ngram?n=2", 3), NgramDrafter)
    oracle = resolve_drafter("oracle?accept=0.25&seed=7", 2)
    assert isinstance(oracle, OracleDrafter)
    assert (oracle.k, oracle.accept_prob) == (2, 0.25)
    assert resolve_drafter("ngram", 3).max_ngram == \
        j_resolve("ngram", 3).max_ngram == 3
    for spec, match in (("mystery", "unknown drafter"),
                        ("ngram?depth=2", "unknown keys"),
                        ("ngram?n", "bad drafter spec")):
        for resolve in (resolve_drafter, j_resolve):
            with pytest.raises(ValueError, match=match):
                resolve(spec, 2)
    with pytest.raises(ValueError, match="k must be >= 1"):
        NgramDrafter(0)
    with pytest.raises(ValueError, match="accept_prob"):
        OracleDrafter(2, accept_prob=1.5)


def test_oracle_corruption_draws_as_the_reference():
    """``accept_prob < 1`` corrupts from ``np.random.default_rng(seed)``:
    the same draws as the reference's, so the same accept pattern."""
    t, j = OracleDrafter(3, accept_prob=0.5, seed=3), \
        j_resolve("oracle?accept=0.5&seed=3", 3)
    for _ in range(5):
        np.testing.assert_array_equal(t._corrupt_rng.random(3),
                                      j._corrupt_rng.random(3))


# ---------------------------------------------------------------------------
# spec costing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b"])
def test_spec_and_chunk_costing_equal_reference(arch):
    """Every spec and chunk estimator gives the reference's numbers, on the
    full config and its smoke, under the tree and LOA strategies."""
    for smoke in (False, True):
        for moa in (None, "loa?approx_bits=4"):
            j, t = jget(arch), tget(arch)
            if smoke:
                j, t = jsmoke(j), tsmoke(t)
            if moa:
                j, t = (dataclasses.replace(c, moa=moa) for c in (j, t))
            ctx = [5, 9, 14, 30]
            assert tcost.spec_request_decode_cost(t, k=3, tick_contexts=ctx) \
                == jcost.spec_request_decode_cost(j, k=3, tick_contexts=ctx)
            for a in (0.0, 0.3, 1.0):
                assert tcost.expected_accepted_len(4, a) == \
                    jcost.expected_accepted_len(4, a)
                assert tcost.spec_decode_cost(
                    t, k=3, accept_prob=a, s_attn=64.0, draft_cfg=t) == \
                    jcost.spec_decode_cost(j, k=3, accept_prob=a, s_attn=64.0,
                                           draft_cfg=j)
            for draft in (None, t):
                assert tcost.spec_break_even_accept(
                    t, k=2, s_attn=128.0, draft_cfg=draft) == \
                    jcost.spec_break_even_accept(
                        j, k=2, s_attn=128.0,
                        draft_cfg=None if draft is None else j)
            assert tcost.prefill_chunk_guidance(
                t, n_slots=4, max_len=512, mean_context=200.0,
                block_size=16) == jcost.prefill_chunk_guidance(
                j, n_slots=4, max_len=512, mean_context=200.0, block_size=16)
    with pytest.raises(ValueError, match="k must be >= 1"):
        tcost.spec_decode_cost(t, k=0, accept_prob=1.0, s_attn=1.0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_serve_cli_spec_and_slo_lines(capsys):
    """``--spec-decode`` prints the reference's ``[serve] spec:`` line, and
    ``--scheduling slo`` (with chunks, on a StepClock) its ``[serve] slo``
    line."""
    from repro_torch.launch import serve as serve_cli

    base = ["--arch", "llama3-8b", "--smoke", "--paged", "--device", "cpu",
            "--no-warmup"]
    serve_cli.main(base + ["--requests", "3", "--prompt-len", "12",
                           "--gen-len", "6", "--spec-decode", "--drafter",
                           "oracle", "--spec-k", "2"])
    out = capsys.readouterr().out
    assert "[serve] spec: drafter=oracle k=2" in out
    assert "accept rate 1.00" in out
    serve_cli.main(base + ["--requests", "5", "--prompt-len", "32",
                           "--gen-len", "12", "--scheduling", "slo",
                           "--prefill-chunk", "16", "--dt", "1e-3",
                           "--deadline", "0.02"])
    out = capsys.readouterr().out
    assert "[serve] slo (slo): attainment" in out
    assert out.count("[serve]   req ") == 5
    with pytest.raises(SystemExit, match="block-size"):
        serve_cli.main(base + ["--prefill-chunk", "12"])
