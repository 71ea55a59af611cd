"""The port's MoE layer and MoE model against the JAX reference, on the CPU.

The same inputs, made with numpy, go through ``repro.layers.moe`` /
``repro.models.moe_transformer`` and their ports. The reference runs its jnp
strategy routes; the port's ``batched_dot`` runs its plain route (each
expert through the unbatched plain ``dot``), as the CPU does.

Tolerances. f32 compute: the two frameworks' matmuls sum in other orders,
so activations agree to f32 reassociation (~1e-6 relative); layer outputs
of order 1 are held within ``atol=1e-5`` and model logits, through 2
layers, within ``test_torch_model.py``'s ``atol=1e-4``. Routing (expert
ids, capacity slots, keep mask) must be equal: the inputs are drawn so no
router probability lies within 1e-4 of the k-th/(k+1)-th boundary. LOA on
int32 operands is exact arithmetic: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.layers import moe as jmoe
from repro.models.api import build_model as jbuild
from repro.moa import resolve as jresolve
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.kernels import ops, ref
from repro_torch.layers import moe as tmoe
from repro_torch.models.api import build_model as tbuild
from repro_torch.moa import resolve as tresolve

LAYER_ATOL = 1e-5   # f32 reassociation, outputs O(1)
MODEL_ATOL = 1e-4   # test_torch_model.py's: through 2 layers, logits O(1)
STRATEGIES = ["tree", "serial?chunk=16", "loa?approx_bits=2&chunk=16"]


def _layer_params(rng, d, f, E, integer=False):
    if integer:       # LOA: small integers, exact in f32 and int32
        def w(*shape):
            return rng.integers(-3, 4, shape).astype(np.float32)
    else:
        def w(*shape):
            return (rng.standard_normal(shape) * shape[-2] ** -0.5
                    ).astype(np.float32)
    return {"router": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f),
            "w_down": w(E, f, d)}


def _both(params, x, spec, integer=False, **kw):
    """``(reference, port)`` outputs of ``moe_forward``: f32 compute, or
    int32 for an integer-only strategy (LOA)."""
    jdt, tdt = ((jnp.int32, torch.int32) if integer
                else (jnp.float32, torch.float32))
    jy, jaux = jmoe.moe_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), compute_dtype=jdt,
        strategy=None if spec is None else jresolve(spec), **kw)
    ty, taux = tmoe.moe_forward(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), compute_dtype=tdt,
        strategy=None if spec is None else tresolve(spec), **kw)
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


def _jax_routing(params, x, *, n_experts, top_k, capacity_factor):
    """The reference's routing of ``x`` (its own lines, jnp route)."""
    xt = jnp.asarray(x).reshape(1, -1, x.shape[-1])
    probs = jax.nn.softmax(xt @ jnp.asarray(params["router"]), axis=-1)
    _, ids = jax.lax.top_k(probs, top_k)
    tg = xt.shape[1]
    cap = max(int(tg * top_k / n_experts * capacity_factor), 1)
    flat = ids.reshape(1, tg * top_k)
    onehot = jax.nn.one_hot(flat, n_experts, dtype=jnp.int32)
    slot = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=-1)
    return np.asarray(ids), np.asarray(slot), np.asarray(slot < cap)


def _clear_margin(params, x, top_k):
    """The smallest gap between the k-th and (k+1)-th router probability
    of any token (the draws keep it above the routing tolerance)."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ params["router"]
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    s = -np.sort(-p, axis=-1)
    return float((s[:, top_k - 1] - s[:, top_k]).min())


@pytest.mark.parametrize("spec", STRATEGIES + [None])
def test_moe_forward_matches_reference(spec):
    integer = spec is not None and spec.startswith("loa")
    rng = np.random.default_rng(0)
    d, f, E, k = 32, 48, 8, 2
    params = _layer_params(rng, d, f, E, integer)
    if integer:
        x = rng.integers(-3, 4, (2, 8, d)).astype(np.float32)
    else:
        x = rng.standard_normal((2, 8, d)).astype(np.float32)
    (jy, jaux), (ty, taux) = _both(params, x, spec, integer, n_experts=E,
                                   top_k=k, capacity_factor=8.0)
    assert ty.shape == jy.shape == x.shape
    np.testing.assert_allclose(ty, jy, atol=0 if integer else LAYER_ATOL,
                               rtol=0)
    assert taux == pytest.approx(jaux, abs=1e-6)


def test_capacity_drops_match_reference():
    """At capacity_factor 1.25 choices are dropped (asserted); ids, slots
    and the keep mask equal the reference's, and the outputs agree."""
    rng = np.random.default_rng(3)
    d, f, E, k, cf = 32, 48, 8, 2, 1.25
    params = _layer_params(rng, d, f, E)
    x = rng.standard_normal((1, 12, d)).astype(np.float32)
    assert _clear_margin(params, x, k) > 1e-4
    ids, slot, keep = _jax_routing(params, x, n_experts=E, top_k=k,
                                   capacity_factor=cf)
    xt = torch.from_numpy(x).reshape(1, 12, d)
    r = tmoe.route(xt @ torch.from_numpy(params["router"]), n_experts=E,
                   top_k=k, capacity_factor=cf)
    assert r.capacity == int(12 * k / E * cf) == 3
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert not keep.all()                       # some choices dropped
    for spec in ("tree", "serial?chunk=16"):
        (jy, jaux), (ty, taux) = _both(params, x, spec, n_experts=E,
                                       top_k=k, capacity_factor=cf)
        np.testing.assert_allclose(ty, jy, atol=LAYER_ATOL, rtol=0)
        assert taux == pytest.approx(jaux, abs=1e-6)


def test_top_k_ties_keep_the_lower_expert_first():
    """Equal router probabilities: the lower expert index comes first and
    claims capacity first, as ``lax.top_k``."""
    E, k = 8, 3
    logits = np.zeros((1, 4, E), np.float32)
    logits[0, :, [1, 4, 6]] = 2.0                 # a three-way tie
    logits[0, 2, [0, 7]] = 2.0                    # five-way on token 2
    r = tmoe.route(torch.from_numpy(logits), n_experts=E, top_k=k,
                   capacity_factor=1.0)
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), k)
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(jids))
    assert r.expert_ids[0, 0].tolist() == [1, 4, 6]
    assert r.expert_ids[0, 2].tolist() == [0, 1, 4]
    # capacity 1: tokens 0 and 1 claim experts 1/4/6 in order
    assert r.capacity == 1
    assert r.keep[0, :3].all() and not r.keep[0, 3:6].any()


def test_aux_loss_matches_reference():
    rng = np.random.default_rng(5)
    params = _layer_params(rng, 16, 24, 4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    (_, jaux), (_, taux) = _both(params, x, "tree", n_experts=4, top_k=2,
                                 capacity_factor=1.25, group_size=5)
    assert taux == pytest.approx(jaux, abs=1e-6) and taux > 0


@pytest.mark.parametrize("spec", STRATEGIES)
def test_batched_dot_matches_vmap_of_dot(spec):
    """The port's ``batched_dot`` against the reference's ``jax.vmap(
    strat.dot, in_axes=(1, 0), out_axes=1)`` on ``(G, E, C, K)`` operands,
    the expert contractions' shapes (integers for LOA: exact)."""
    rng = np.random.default_rng(9)
    if spec.startswith("loa"):
        a = rng.integers(0, 16, (2, 4, 3, 32), dtype=np.int32)
        b = rng.integers(0, 8, (4, 32, 5), dtype=np.int32)
    else:
        a = rng.standard_normal((2, 4, 3, 32)).astype(np.float32)
        b = rng.standard_normal((4, 32, 5)).astype(np.float32)
    js, ts = jresolve(spec), tresolve(spec)
    want = jax.vmap(lambda x, w: js.dot(x, w), in_axes=(1, 0),
                    out_axes=1)(jnp.asarray(a), jnp.asarray(b))
    got = ts.batched_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == want.shape == (2, 4, 3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=0 if spec.startswith("loa") else 1e-5,
                               rtol=0)


def test_batched_dot_plain_route_is_member_by_member():
    """``batched_dot`` is ``vmap(dot, in_axes=(1, 0), out_axes=1)``: each
    member bit for bit the unbatched plain ``dot``, for every route."""
    rng = np.random.default_rng(7)
    for spec, dt in (("tree", torch.float32), ("serial?chunk=8",
                                               torch.float32),
                     ("loa?approx_bits=3&chunk=8", torch.int32)):
        strat = tresolve(spec)
        if dt == torch.int32:
            a = torch.from_numpy(rng.integers(0, 16, (2, 3, 4, 24),
                                              dtype=np.int32))
            b = torch.from_numpy(rng.integers(0, 8, (3, 24, 5),
                                              dtype=np.int32))
        else:
            a = torch.from_numpy(rng.standard_normal((2, 3, 4, 24))
                                 .astype(np.float32))
            b = torch.from_numpy(rng.standard_normal((3, 24, 5))
                                 .astype(np.float32))
        got = strat.batched_dot(a, b)
        assert got.shape == (2, 3, 4, 5)
        for e in range(3):
            assert torch.equal(got[:, e], strat.dot(a[:, e], b[e])), spec


def test_batched_ops_dispatch_on_cpu():
    """``ops.dot_moa`` on 3-D CPU operands is the plain batched version."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((4, 3, 40)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4, 40, 6)).astype(np.float32))
    got = ops.dot_moa(a, b, block_k=16)
    want = torch.stack([ref.dot_moa_ref(a[e], b[e], block_k=16)
                        for e in range(4)])
    assert torch.equal(got, want)
    assert ops.launch_counts()["dot_moa"] == 0


# ---------------------------------------------------------------------------
# the MoE model
# ---------------------------------------------------------------------------


def _model_pair(**updates):
    upd = dict(compute_dtype="float32", **updates)
    jcfg = dataclasses.replace(jsmoke(jget("moonshot-v1-16b-a3b")), **upd)
    tcfg = dataclasses.replace(tsmoke(tget("moonshot-v1-16b-a3b")), **upd)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg)
    tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return _model_pair()


def _tokens(shape, seed=0, vocab=257):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def test_moe_param_tree_and_own_initializer(pair):
    jm, jp, tm, tp = pair
    want = {p: tuple(np.shape(a)) for p, a in
            interop.tree_leaves(jax.tree.map(np.asarray, jp))}
    own = tbuild(tm.cfg).init(seed=0, device="cpu")
    assert {p: tuple(t.shape) for p, t in interop.tree_leaves(own)} == want
    assert own["layers"]["moe"]["w_gate"].dtype == tm.cfg.pdtype
    # per-layer draws: each layer its own values, all at 1/sqrt(fan_in)
    wg = own["layers"]["moe"]["w_gate"]
    assert not torch.equal(wg[0], wg[1])
    assert float(wg.std()) == pytest.approx(tm.cfg.d_model ** -0.5 * 0.88,
                                            rel=0.1)


def test_moe_forward_logits_and_aux(pair):
    jm, jp, tm, tp = pair
    toks = _tokens((2, 12))
    jl, jaux = jm._forward_with_aux(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.forward_with_aux(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_ATOL,
                               rtol=0)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-5)


def test_moe_prefill_decode_and_paged_decode(pair):
    """prefill (padded, dropless), then dense-slot and paged decode steps
    from the same prefill, against the reference's."""
    jm, jp, tm, tp = pair
    max_len, p = 32, 11
    toks = np.zeros((1, 16), np.int32)
    toks[0, :p] = _tokens((p,), 1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=max_len,
                        prompt_len=p)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        max_len=max_len, prompt_len=p)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_ATOL,
                               rtol=0)
    for name, leaf in tc["layers"].items():
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(jc["layers"][name]),
                                   atol=MODEL_ATOL, rtol=0)
    # dense-slot decode: the prefill cache is the batch-1 cache
    tcache = {"layers": {k: v.clone() for k, v in tc["layers"].items()},
              "pos": torch.tensor(p, dtype=torch.int32)}
    jcache = jc
    for step in range(3):
        nxt = _tokens((1, 1), 10 + step)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=MODEL_ATOL, rtol=0)
    assert int(tcache["pos"]) == int(jcache["pos"]) == p + 3
    # paged decode: the same prefill's K/V in pool pages 1.. of slot 0
    bs, nb = 8, max_len // 8
    jpool = jm.init_paged_cache(1, nb + 1, bs, nb)
    tpool = tm.init_paged_cache(1, nb + 1, bs, nb, device="cpu")
    for name, leaf in tc["layers"].items():
        tpool["layers"][name][:, 1:] = leaf[:, 0].reshape(
            (leaf.shape[0], nb, bs) + tuple(leaf.shape[3:]))
    jpool = dict(jpool, layers=jax.tree.map(
        lambda x: jnp.asarray(x.numpy()), tpool["layers"]))
    table = np.arange(1, nb + 1, dtype=np.int32)[None]
    jpool["block_tables"] = jnp.asarray(table)
    jpool["pos"] = jnp.asarray([p], jnp.int32)
    tpool["block_tables"] = torch.from_numpy(table.copy())
    tpool["pos"] = torch.tensor([p], dtype=torch.int32)
    for step in range(3):
        nxt = _tokens((1, 1), 10 + step)
        jl, jpool = jm.paged_decode_step(jp, jpool, jnp.asarray(nxt))
        tl, tpool = tm.paged_decode_step(tp, tpool, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=MODEL_ATOL, rtol=0)


def test_capacity_limited_model_gates(pair):
    """Below the dropless regime padded and suffix prefill are refused, as
    the reference's ``Model`` refuses them; an exact-length prefill still
    matches the reference."""
    jm, jp, _, tp = pair
    tcfg = dataclasses.replace(pair[2].cfg, capacity_factor=1.25)
    jcfg = dataclasses.replace(jm.cfg, capacity_factor=1.25)
    tm, jm2 = tbuild(tcfg), jbuild(jcfg)
    assert not tm.supports_padded_prefill and not jm2.supports_padded_prefill
    assert pair[2].supports_padded_prefill
    with pytest.raises(ValueError, match="expert-capacity"):
        tm.prefill_suffix(tp, {"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                          prefix={"k": None}, prompt_len=8)
    toks = _tokens((1, 13), 4)
    jl, _ = jm2.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=16)
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_ATOL,
                               rtol=0)


def test_dense_decode_drops_writes_past_max_len():
    """An idle slot's cursor at or past ``max_len`` writes nothing (JAX
    drops the scatter) and attends over every position, as the
    reference's ``attention_decode``."""
    from repro.layers import attention as jattn
    from repro_torch.layers import attention as tattn

    rng = np.random.default_rng(11)
    B, L, H, D, d = 3, 8, 2, 8, 16
    params = {n: (rng.standard_normal((d, H * D)) * d ** -0.5
                  ).astype(np.float32) for n in ("wq", "wk", "wv")}
    params["wo"] = (rng.standard_normal((H * D, d)) * 0.2).astype(np.float32)
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    cache = {n: rng.standard_normal((B, L, H, D)).astype(np.float32)
             for n in ("k", "v")}
    pos = np.array([3, 8, 11], np.int32)
    kw = dict(n_heads=H, n_kv_heads=H, head_dim=D, rope_theta=1e4)
    jy, jc = jattn.attention_decode(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(pos),
        compute_dtype=jnp.float32, **kw)
    tcache = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    ty, tc = tattn.attention_decode(
        {n: torch.from_numpy(v) for n, v in params.items()},
        torch.from_numpy(x), tcache, torch.from_numpy(pos),
        compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=LAYER_ATOL,
                               rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=LAYER_ATOL, rtol=0)
        # rows 1 and 2 (cursors 8 and 11) are untouched, bit for bit
        assert np.array_equal(tc[n].numpy()[1:], cache[n][1:])
