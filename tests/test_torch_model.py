"""The port's dense model against the JAX reference, on the CPU.

Both packages build ``smoke_config(get_config("llama3-8b"))`` with
``compute_dtype="float32"``; the reference's parameters (``PRNGKey(0)``)
cross into the port through :mod:`repro_torch.interop`. The reference runs
its usual jnp paths; the port's kernels run their plain versions on CPU
tensors. Logits are compared within f32 reassociation error: XLA's and
PyTorch's CPU matmuls sum in different orders, through 2 layers, on
logits of order 1 — hence ``atol=1e-4``.
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

ATOL = 1e-4      # f32 reassociation through 2 layers, logits O(1)


def _configs(**updates):
    j = dataclasses.replace(jsmoke(jget("llama3-8b")),
                            compute_dtype="float32", **updates)
    t = dataclasses.replace(tsmoke(tget("llama3-8b")),
                            compute_dtype="float32", **updates)
    return j, t


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    tm = tbuild(tcfg)
    tp = tm.load_params(interop.from_numpy(np_params, device="cpu"))
    return jm, jp, tm, tp, np_params


def _tokens(shape, seed=0, vocab=257):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _cache_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b",
                                  "moonshot-v1-16b-a3b", "zamba2-1.2b"])
def test_config_fields_and_counts_match(arch):
    """Same fields, defaults and values, same analytic counts."""
    j, t = jget(arch), tget(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    assert jsmoke(j).param_count() == tsmoke(t).param_count()
    assert dataclasses.asdict(tsmoke(t))["moa"] == jsmoke(j).moa


def test_config_validation():
    t = tget("llama3-8b")
    with pytest.raises(ValueError, match="attn_backend"):
        dataclasses.replace(t, attn_backend="pallas")
    with pytest.raises(ValueError, match="unknown MOA strategy"):
        dataclasses.replace(t, moa="bogus")
    with pytest.raises(ValueError, match="MOA site"):
        dataclasses.replace(t, moa_overrides={"nowhere": "tree"})


def test_param_tree_shapes_and_count(pair):
    jm, jp, tm, tp, np_params = pair
    want = {p: tuple(a.shape) for p, a in interop.tree_leaves(np_params)}
    got = {p: tuple(t.shape) for p, t in interop.tree_leaves(tp)}
    assert got == want
    assert tm.param_count() == sum(a.size for _, a in
                                   interop.tree_leaves(np_params))
    assert tm.cfg.param_count() == jm.cfg.param_count()  # norms excluded
    names = {n for n, _ in tm.named_parameters()}
    assert "layers.attn.wq" in names and len(names) == len(want)
    # the port's own initializer builds the same tree
    own = tbuild(tm.cfg).init(seed=0, device="cpu")
    assert {p: tuple(t.shape) for p, t in interop.tree_leaves(own)} == want


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_round_trip(param_dtype):
    jcfg, tcfg = _configs(param_dtype=param_dtype)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, jp)
    tp = interop.from_numpy(np_params, device="cpu")
    back = interop.to_numpy(tp)
    for (pa, a), (pb, b) in zip(interop.tree_leaves(np_params),
                                interop.tree_leaves(back)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_truncated_normal_draws_in_flat_chunks(monkeypatch):
    """A tensor larger than ``DRAW_ELEMS`` is drawn that many elements at a
    time along its flat index, also where one row of its leading axis
    alone holds more: every value within 2 stddev, the chunks not repeats
    of one another, the same seed the same tensor; a tensor within the
    limit is one draw. ``meta`` draws nothing, at llama3-405b's MLP stack
    (872 M elements a row)."""
    from repro_torch.layers import common

    def draw(shape, dtype=torch.bfloat16):
        return common.truncated_normal_init(
            torch.Generator().manual_seed(3), shape, 0.5, dtype)

    whole = draw((2, 4, 5))
    monkeypatch.setattr(common, "DRAW_ELEMS", 7)
    got = draw((2, 4, 5))
    assert got.shape == (2, 4, 5) and got.dtype == torch.bfloat16
    assert torch.equal(got, draw((2, 4, 5)))
    assert float(got.float().abs().max()) <= 1.0
    flat = got.view(-1)
    assert not torch.equal(flat[:7], flat[7:14])
    assert not torch.equal(got, whole)
    assert torch.equal(draw((7,), torch.float32),
                       draw((40,), torch.float32)[:7])
    monkeypatch.undo()
    cfg = dataclasses.replace(tget("llama3-405b"), n_layers=1)
    meta = tbuild(cfg).abstract_params()
    assert meta["layers"]["mlp"]["w_gate"].shape == (1, 16384, 53248)
    assert meta["layers"]["mlp"]["w_gate"].is_meta


def test_other_families_not_ported():
    """Every family of the registry builds; what stays refused is what the
    reference refuses: a family no module serves, and serving an encoder
    (no decode step) or a VLM (the engine feeds token-only prompts)."""
    from repro_torch.serve import ServeEngine

    assert tbuild(tsmoke(tget("moonshot-v1-16b-a3b"))).cfg.family == "moe"
    for arch, match in (("hubert-xlarge", "encoder-only arch"),
                        ("llava-next-34b", "vlm serving is not supported")):
        tm = tbuild(tsmoke(tget(arch)))
        assert tm.cfg.family == jbuild(jsmoke(jget(arch))).cfg.family
        with pytest.raises(ValueError, match=match):
            ServeEngine(tm, tm.init(seed=0, device="cpu"), n_slots=1,
                        max_len=16, device="cpu")
    bogus = dataclasses.replace(tsmoke(tget("llama3-8b")), family="bogus")
    with pytest.raises(ValueError, match="unknown family"):
        tbuild(bogus)
    with pytest.raises(ValueError, match="unknown family"):
        jbuild(dataclasses.replace(jsmoke(jget("llama3-8b")),
                                   family="bogus"))


# ---------------------------------------------------------------------------
# forward, prefill, suffix prefill, paged decode
# ---------------------------------------------------------------------------


def test_forward_logits(pair):
    jm, jp, tm, tp, _ = pair
    toks = _tokens((2, 24))
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_prefill_and_suffix(kv):
    jcfg, tcfg = _configs(kv_cache_dtype="int8" if kv == "int8"
                          else "bfloat16")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg)
    tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    max_len, p = 48, 21
    toks = np.zeros((1, 32), np.int32)
    toks[0, :p] = _tokens((p,), seed=3)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=max_len,
                        prompt_len=p)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        max_len=max_len, prompt_len=p)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    assert tc["pos"] == int(jc["pos"])
    jk, tk = _cache_np(jc["layers"]), interop.to_numpy(tc["layers"])
    assert set(jk) == set(tk)
    for name in jk:
        assert jk[name].shape == tk[name].shape
        if name in ("k", "v") and kv == "int8":
            # round-half-even quantization of nearly equal values: a code
            # may step by one where a value sits on a rounding boundary
            assert np.abs(jk[name].astype(int) - tk[name]).max() <= 1
        else:
            np.testing.assert_allclose(tk[name], jk[name].astype(np.float32),
                                       atol=ATOL, rtol=0)

    # suffix prefill behind the first 16 positions, cached in compute type
    P = 16
    prefix_np = {"k": np.asarray(jc["layers"]["k"])[:, :, :P],
                 "v": np.asarray(jc["layers"]["v"])[:, :, :P]}
    if kv == "int8":
        from repro.layers.attention import dequantize_kv
        prefix_np = {n: np.asarray(dequantize_kv(
            jnp.asarray(prefix_np[n]),
            jnp.asarray(np.asarray(jc["layers"][n + "_scale"])[:, :, :P]),
            jnp.float32)) for n in ("k", "v")}
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :p - P] = toks[0, P:p]
    jl2, jc2 = jm.prefill_suffix(
        jp, {"tokens": jnp.asarray(suffix)},
        prefix={n: jnp.asarray(a) for n, a in prefix_np.items()},
        prompt_len=p)
    tl2, tc2 = tm.prefill_suffix(
        tp, {"tokens": torch.from_numpy(suffix)},
        prefix=interop.from_numpy(prefix_np, device="cpu"), prompt_len=p)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL,
                               rtol=0)
    assert tc2["pos"] == int(jc2["pos"]) == p
    if kv != "int8":     # an int8 prefix attends to dequantized K/V
        # the suffix computes the full prefill's last-position logits
        np.testing.assert_allclose(tl2.numpy(), tl.numpy(), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_decode_step(kv):
    """One paged decode step from the same pool: logits and every written
    page agree. Slot 2 is idle with its cursor far past the table (the
    engine never rewinds an idle slot's cursor between ticks): the
    reference's gather clamps to the last column — the trash page — and
    the port must land the write there too instead of raising."""
    jcfg, tcfg = _configs(kv_cache_dtype="int8" if kv == "int8"
                          else "bfloat16")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg)
    tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    n_slots, bs, max_blocks, n_phys = 3, 8, 4, 10
    jc = jm.init_paged_cache(n_slots, n_phys, bs, max_blocks)
    rs = np.random.default_rng(7)
    layers = {}
    for name, leaf in jc["layers"].items():
        shape = leaf.shape
        if name in ("k", "v") and kv == "int8":
            layers[name] = rs.integers(-127, 128, shape).astype(np.int8)
        elif name.endswith("_scale"):
            layers[name] = rs.uniform(0.01, 0.05, shape).astype(np.float32)
        else:
            layers[name] = rs.standard_normal(shape).astype(np.float32)
    tables = np.asarray([[3, 7, 1, 0], [2, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([17, 9, 40], np.int32)
    toks = _tokens((n_slots, 1), seed=8)
    jcache = {"layers": {n: jnp.asarray(a) for n, a in layers.items()},
              "block_tables": jnp.asarray(tables), "pos": jnp.asarray(pos)}
    tcache = tm.init_paged_cache(n_slots, n_phys, bs, max_blocks,
                                 device="cpu")
    for n, a in interop.from_numpy(layers, device="cpu").items():
        tcache["layers"][n].copy_(a)
    tcache["block_tables"].copy_(torch.from_numpy(tables))
    tcache["pos"].copy_(torch.from_numpy(pos))
    for live in (None, 4):
        jl, jc2 = jm.paged_decode_step(jp, jcache, jnp.asarray(toks),
                                       live_blocks=live)
        tl, tc2 = tm.paged_decode_step(
            tp, {**tcache, "layers": {n: t.clone() for n, t in
                                      tcache["layers"].items()},
                 "pos": tcache["pos"].clone()},
            torch.from_numpy(toks), live_blocks=live)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tc2["pos"].numpy(),
                                      np.asarray(jc2["pos"]))
        for n in layers:
            j, t = np.asarray(jc2["layers"][n]), tc2["layers"][n].numpy()
            live_pages = [3, 7, 1, 2, 5]       # the trash page 0 is garbage
            if layers[n].dtype == np.int8:
                assert np.abs(j[:, live_pages].astype(int)
                              - t[:, live_pages]).max() <= 1
            else:
                np.testing.assert_allclose(t[:, live_pages],
                                           j[:, live_pages], atol=ATOL,
                                           rtol=0)
            # the idle slot wrote into the trash page, nowhere else
            untouched = [i for i in range(n_phys) if i not in
                         (0, 3, 7, 1, 2, 5)]
            np.testing.assert_array_equal(t[:, untouched],
                                          layers[n][:, untouched])
