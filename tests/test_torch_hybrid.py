"""The port's SSM (mamba2) and hybrid (zamba2) models against the JAX
reference, on the CPU.

Both packages build the smoke config of ``mamba2-370m`` or of
``zamba2-1.2b`` in float32 compute, the zamba2 smoke also with a tail
(``n_layers=5, attn_every=2``: two applications of the shared block and one
Mamba-2 layer after them); the reference's parameters (``PRNGKey(0)``)
cross into the port through :mod:`repro_torch.interop`, and every token,
cache and pool is drawn from a seeded numpy generator and given to both.
The port's steps update its cache in place; the reference's return a new
one, and the two are compared leaf by leaf.

Tolerance: logits and caches within ``atol=1e-4`` (test_torch_model.py's:
f32 reassociation through a few layers, logits of order 1; the SSD's
products are contracted in different orders, see test_torch_ssd.py).
Cursors, block tables and greedy choices are exact. The port's aligned
chunked prefill equals its one-shot prefill bit for bit in bf16 compute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.models.api import build_model as tbuild

ATOL = 1e-4
ARCHS = {"mamba2": ("mamba2-370m", {}),
         "zamba2": ("zamba2-1.2b", {}),
         "zamba2-tail": ("zamba2-1.2b", {"n_layers": 5, "attn_every": 2})}
HYBRIDS = ["zamba2", "zamba2-tail"]
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


def _pair(key, **extra):
    """The reference's model and ``PRNGKey(0)`` parameters, and the port's
    model with the same parameters (module-cached)."""
    ck = (key, tuple(sorted(extra.items())))
    if ck not in _BUILT:
        arch, upd = ARCHS[key]
        upd = dict(upd, compute_dtype="float32", **extra)
        jm = jbuild(dataclasses.replace(jsmoke(jget(arch)), **upd))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(dataclasses.replace(tsmoke(tget(arch)), **upd))
        tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
        _BUILT[ck] = (jm, jp, tm, tp)
    return _BUILT[ck]


def _tokens(shape, seed, vocab=257):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _to_torch(tree):
    return interop.from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _close(got, want, atol=ATOL):
    """Every leaf of the port's tree (``snap`` excepted) against the
    reference's: integer leaves equal, float leaves within ``atol``."""
    want = jax.tree.map(np.asarray, want)
    got = {k: v for k, v in got.items() if k != "snap"} \
        if isinstance(got, dict) else got
    gl, wl = dict(interop.tree_leaves(got)), dict(interop.tree_leaves(want))
    assert sorted(gl) == sorted(wl)
    for path, g in gl.items():
        w = wl[path]
        g = g.float().numpy() if isinstance(g, torch.Tensor) and \
            g.is_floating_point() else np.asarray(g)
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w.astype(np.float32), rtol=0,
                                       atol=atol, err_msg=path)


def _random_state(cfg, batch, seed, conv_bf16=False):
    """A nonzero recurrent state of every layer. The conv history is f32
    unless ``conv_bf16`` (the engines' caches hold it in bf16): both
    packages then store each step's conv inputs unrounded, and an f32
    reassociation difference cannot flip a bf16 rounding that the next
    step would read."""
    rng = np.random.default_rng(seed)
    H, P, N = cfg.d_inner // cfg.headdim, cfg.headdim, cfg.d_state
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    h = (0.1 * rng.standard_normal((cfg.n_layers, batch, H, P, N))
         ).astype(np.float32)
    conv = rng.standard_normal((cfg.n_layers, batch, cfg.d_conv - 1,
                                conv_dim)).astype(np.float32)
    if conv_bf16:
        conv = np.asarray(jnp.asarray(conv, jnp.bfloat16))
    return {"h": h, "conv": conv}


def _dense_cache(key, batch, max_len, seed, conv_bf16=False):
    """A dense-slot cache with per-slot cursors, random states and K/V."""
    jm = _pair(key)[0]
    cfg = jm.cfg
    rng = np.random.default_rng(seed)
    cache = {"pos": rng.integers(3, max_len - 6, (batch,)).astype(np.int32)}
    if cfg.family == "ssm":
        cache["layers"] = _random_state(cfg, batch, seed, conv_bf16)
        return cache
    cache["ssm"] = _random_state(cfg, batch, seed, conv_bf16)
    n_apps = cfg.n_layers // cfg.attn_every
    shape = (n_apps, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache["kv"] = {n: rng.standard_normal(shape).astype(np.float32)
                   for n in ("k", "v")}
    return cache


def _paged_cache(key, batch, seed, bs=4, max_blocks=6):
    """A paged cache: a random pool, each slot's table a private
    permutation of pages, per-slot cursors inside the table."""
    cfg = _pair(key)[0].cfg
    rng = np.random.default_rng(seed)
    n_apps = cfg.n_layers // cfg.attn_every
    n_phys = batch * max_blocks + 1
    shape = (n_apps, n_phys, bs, cfg.n_kv_heads, cfg.head_dim)
    tables = (1 + rng.permutation(batch * max_blocks)).reshape(
        batch, max_blocks).astype(np.int32)
    return {"ssm": _random_state(cfg, batch, seed),
            "kv": {n: rng.standard_normal(shape).astype(np.float32)
                   for n in ("k", "v")},
            "block_tables": tables,
            "pos": rng.integers(2, bs * max_blocks - 8,
                                (batch,)).astype(np.int32)}


def _both(cache_np):
    """The same cache for the reference (jnp) and the port (tensors)."""
    return (jax.tree.map(jnp.asarray, cache_np),
            interop.from_numpy(cache_np, device="cpu"))


# ---------------------------------------------------------------------------
# build, parameters, cache layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-370m"])
def test_build_model_full_and_smoke(arch):
    """``build_model`` builds both families at full width and in smoke,
    with the reference's cache layout summary and gates."""
    for t_cfg, j_cfg in ((tget(arch), jget(arch)),
                         (tsmoke(tget(arch)), jsmoke(jget(arch)))):
        tm, jm = tbuild(t_cfg), jbuild(j_cfg)
        assert dataclasses.asdict(tm.cache_spec()) == \
            dataclasses.asdict(jm.cache_spec())
        assert tm.cache_spec().pageable == jm.cache_spec().pageable
        for prop in ("supports_padded_prefill", "supports_chunked_prefill",
                     "prefill_chunk_alignment", "supports_spec_decode"):
            assert getattr(tm, prop) == getattr(jm, prop), prop


def test_hybrid_int8_kv_stays_in_compute_dtype():
    """An int8 ``kv_cache_dtype`` on the hybrid keeps its K/V in the
    compute type, as the reference's cache does."""
    cfg = dataclasses.replace(tsmoke(tget("zamba2-1.2b")),
                              kv_cache_dtype="int8")
    jcfg = dataclasses.replace(jsmoke(jget("zamba2-1.2b")),
                               kv_cache_dtype="int8")
    tm, jm = tbuild(cfg), jbuild(jcfg)
    cache = tm.init_cache(2, 8, device="cpu")
    assert set(cache["kv"]) == {"k", "v"}
    assert cache["kv"]["k"].dtype == cfg.cdtype
    assert dataclasses.asdict(tm.cache_spec()) == \
        dataclasses.asdict(jm.cache_spec())


@pytest.mark.parametrize("key", list(ARCHS))
def test_param_tree_and_init(key):
    jm, jp, tm, tp = _pair(key)
    want = {p: tuple(a.shape) for p, a in
            interop.tree_leaves(jax.tree.map(np.asarray, jp))}
    own = tbuild(tm.cfg).init(seed=0, device="cpu")
    assert {p: tuple(t.shape) for p, t in interop.tree_leaves(own)} == want
    assert {p: tuple(t.shape) for p, t in interop.tree_leaves(tp)} == want


def test_ssm_refuses_paged_cache():
    tm = _pair("mamba2")[2]
    with pytest.raises(ValueError, match="no KV cache to page"):
        tm.init_paged_cache(2, 9, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="padded"):
        tm.prefill(_pair("mamba2")[3], {"tokens": torch.zeros(
            (1, 8), dtype=torch.int32)}, max_len=16, prompt_len=5)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(ARCHS))
def test_forward(key):
    jm, jp, tm, tp = _pair(key)
    toks = _tokens((2, 13), 0)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("key", list(ARCHS))
def test_prefill_every_leaf(key):
    jm, jp, tm, tp = _pair(key)
    toks = _tokens((2, 11), 1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    assert tc["pos"] == int(jc["pos"])
    _close({k: v for k, v in tc.items() if k != "pos"},
           {k: v for k, v in jc.items() if k != "pos"})


@pytest.mark.parametrize("key", list(ARCHS))
@pytest.mark.parametrize("conv_bf16", [False, True])
def test_decode_step(key, conv_bf16):
    """Two steps from a random dense-slot cache with per-slot cursors (the
    conv history also in bf16, as the engines hold it)."""
    jm, jp, tm, tp = _pair(key)
    jc, tc = _both(_dense_cache(key, 3, 24, seed=2, conv_bf16=conv_bf16))
    for step in range(2):
        toks = _tokens((3, 1), 10 + step)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(toks))
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        _close(tc, jc)


@pytest.mark.parametrize("key", HYBRIDS)
def test_paged_decode_step(key):
    """Two steps against a random pool through permuted block tables."""
    jm, jp, tm, tp = _pair(key)
    jc, tc = _both(_paged_cache(key, 3, seed=3))
    for step in range(2):
        toks = _tokens((3, 1), 20 + step)
        jl, jc = jm.paged_decode_step(jp, jc, jnp.asarray(toks),
                                      live_blocks=6)
        tl, _ = tm.paged_decode_step(tp, tc, torch.from_numpy(toks),
                                     live_blocks=6)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        _close(tc, jc)


# ---------------------------------------------------------------------------
# speculative verify and commit
# ---------------------------------------------------------------------------


LAYOUTS = [("mamba2", False), ("zamba2", False), ("zamba2", True),
           ("zamba2-tail", False), ("zamba2-tail", True)]


@pytest.mark.parametrize("key,paged", LAYOUTS)
def test_verify_and_commit(key, paged):
    """A T = 3 verify and the commit at every ``keep`` from 0 (all
    rejected, or idle) to 3: logits, the snapshots and the committed cache
    against the reference's; the verify's logits also against T sequential
    decode steps of the port."""
    jm, jp, tm, tp = _pair(key)
    B, T = 4, 3
    cache = _paged_cache(key, B, seed=4) if paged \
        else _dense_cache(key, B, 24, seed=4)
    jc, tc = _both(cache)
    toks = _tokens((B, T), 30)
    if paged:
        jl, jc, jaux = jm.paged_verify_step(jp, jc, jnp.asarray(toks),
                                            live_blocks=6)
        tl, tc, taux = tm.paged_verify_step(tp, tc, torch.from_numpy(toks),
                                            live_blocks=6)
    else:
        jl, jc, jaux = jm.verify_step(jp, jc, jnp.asarray(toks))
        tl, tc, taux = tm.verify_step(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    state_key = tm.state_key
    np.testing.assert_array_equal(tc["pos"].numpy(), cache["pos"])
    _close(taux, jaux[state_key])
    keep = np.asarray((0, 3, 1, 2), np.int32)
    jc = jm.commit_verified(jc, jnp.asarray(keep), jaux)
    tc = tm.commit_verified(tc, torch.from_numpy(keep), taux)
    _close(tc, jc)
    # the verify is T decode steps, bit for bit
    _, seq = _both(cache)
    step = (lambda c, t: tm.paged_decode_step(tp, c, t, live_blocks=6)) \
        if paged else (lambda c, t: tm.decode_step(tp, c, t))
    for t in range(T):
        lg, seq = step(seq, torch.from_numpy(toks[:, t:t + 1]))
        assert torch.equal(lg[:, 0], tl[:, t])


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(ARCHS))
def test_prefill_chunk(key):
    """A chunk continued from a one-shot prefill's state (and, hybrid, its
    prefix K/V), against the reference's."""
    jm, jp, tm, tp = _pair(key)
    pre_toks, toks = _tokens((1, 8), 5), _tokens((1, 8), 6)
    _, jpre = jm.prefill(jp, {"tokens": jnp.asarray(pre_toks)}, max_len=8)
    tpre = _to_torch(jpre)
    if tm.cfg.family == "ssm":
        jl, jout = jm.prefill_chunk(jp, {"tokens": jnp.asarray(toks)},
                                    state=jpre)
        tl, tout = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(toks)},
                                    state=tpre)
    else:
        jstate = {"ssm": jpre["ssm"], "pos": jpre["pos"]}
        tstate = {"ssm": tpre["ssm"], "pos": tpre["pos"]}
        jl, jout = jm.prefill_chunk(jp, {"tokens": jnp.asarray(toks)},
                                    state=jstate, prefix_kv=jpre["kv"])
        tl, tout = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(toks)},
                                    state=tstate, prefix_kv=tpre["kv"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    _close(tout, jout)


@pytest.mark.parametrize("key", ["mamba2", "zamba2-tail"])
def test_chunked_prefill_equals_one_shot_bf16(key):
    """bf16 compute: three ``ssd_chunk``-aligned chunks from a zeroed
    state give the one-shot prefill's logits and recurrent state bit for
    bit. The hybrid's chunks attend with ``full_attention`` where the
    one-shot prefill runs the chunked flash twin, so only what precedes
    its first softmax·V is held bit for bit: the first group's states and
    the first application's K/V."""
    arch, upd = ARCHS[key]
    cfg = dataclasses.replace(tsmoke(tget(arch)), **upd)
    tm = tbuild(cfg)
    tp = tm.init(seed=1, device="cpu")
    toks = torch.from_numpy(_tokens((1, 24), 7))
    one_logits, one = tm.prefill(tp, {"tokens": toks}, max_len=24)
    state = tm.init_cache(1, 24, device="cpu")
    skey = tm.state_key
    state = {skey: state[skey], "pos": state["pos"]}
    kv_parts = []
    for c in range(3):
        chunk = {"tokens": toks[:, 8 * c:8 * (c + 1)]}
        if cfg.family == "ssm":
            logits, state = tm.prefill_chunk(tp, chunk, state=state)
        else:
            prefix = ({n: torch.cat([p[n] for p in kv_parts], dim=2)
                       for n in ("k", "v")} if kv_parts else
                      {n: torch.zeros((one["kv"][n].shape[0], 1, 0)
                                      + tuple(one["kv"][n].shape[3:]),
                                      dtype=cfg.cdtype) for n in ("k", "v")})
            logits, out = tm.prefill_chunk(tp, chunk, state=state,
                                           prefix_kv=prefix)
            kv_parts.append(out["kv"])
            state = {"ssm": out["ssm"], "pos": out["pos"]}
    assert int(state["pos"]) == 24
    exact = cfg.n_layers if cfg.family == "ssm" else cfg.attn_every
    for n in ("h", "conv"):
        assert torch.equal(state[skey][n][:exact],
                           one[skey][n][:exact].to(state[skey][n].dtype))
    if cfg.family == "ssm":
        assert torch.equal(logits, one_logits)
    else:
        for n in ("k", "v"):
            assert torch.equal(
                torch.cat([p[n] for p in kv_parts], dim=2)[0],
                one["kv"][n][0])
