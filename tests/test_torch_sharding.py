"""The port's sharding layer against the reference's: rules, param and
cache specs, batch specs, ``parse_mesh``, and the local-shard slicer.

Pure: the reference's specs come from its own functions on a stand-in
mesh (``axis_names``, ``devices.shape``), with ``NamedSharding`` swapped
for the bare spec, so nothing needs more than the one CPU device or
reaches the reference's ``constrain``.
"""

import itertools

import jax
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import SHAPES
from repro.launch import steps as ref_steps
from repro.models.api import build_model as ref_build
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.launch.mesh import mesh_axis_names, parse_mesh
from repro_torch.models.api import build_model
from repro_torch.parallel import sharding

ARCHS = ("llama3-8b", "moonshot-v1-16b-a3b", "zamba2-1.2b", "mamba2-370m")
MESHES = ((1, 1), (1, 2), (2, 1), (2, 4), (2, 2, 2))


def stand_in(shape):
    """A mesh-shaped object: the reference's ``Mesh`` attributes only."""
    class _Devices:
        pass

    class _Mesh:
        axis_names = mesh_axis_names(shape)
        devices = _Devices()

    _Mesh.devices.shape = tuple(shape)
    return _Mesh


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's shardings as bare specs on a stand-in mesh."""
    bare = lambda mesh, spec: tuple(spec)
    monkeypatch.setattr(ref_steps, "NamedSharding", bare)
    monkeypatch.setattr(ref_sharding, "NamedSharding", bare)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _models(arch):
    ref = ref_build(ref_registry.smoke_config(ref_registry.ARCHS[arch]))
    port = build_model(registry.smoke_config(registry.ARCHS[arch]))
    return ref, port


def _ref_caches(model, n_slots, max_len, block_size):
    dense = jax.eval_shape(lambda: model.init_cache(n_slots, max_len))
    dense["pos"] = jax.ShapeDtypeStruct((n_slots,), "int32")
    out = {False: dense}
    if model.cache_spec().pageable:
        nb = n_slots * max_len // block_size
        out[True] = jax.eval_shape(lambda: model.init_paged_cache(
            n_slots, nb + 1, block_size, max_len // block_size))
    return out


def _port_caches(model, n_slots, max_len, block_size):
    meta = torch.device("meta")
    dense = model.init_cache(n_slots, max_len, device=meta)
    dense["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=meta)
    out = {False: dense}
    if model.cache_spec().pageable:
        nb = n_slots * max_len // block_size
        out[True] = model.init_paged_cache(
            n_slots, nb + 1, block_size, max_len // block_size, device=meta)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_reference(arch, bare_specs):
    """Every parameter leaf's spec (serve rules, and the FSDP upgrade under
    the default rules) and every cache leaf's spec, in both layouts and at
    2 and 3 slots, equal the reference's on every mesh."""
    ref, port = _models(arch)
    ref_params = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    port_params = port.abstract_params()
    ref_axes = ref_steps.infer_param_axes(ref_params)
    port_axes = steps.infer_param_axes(port_params)
    assert _flat(port_axes) == _flat(ref_axes)
    family = port.cfg.family
    checked = 0
    for shape in MESHES:
        mesh = stand_in(shape)
        base_ref = ref_sharding.serve_rules_for(family)
        base = sharding.serve_rules_for(family)
        assert base.rules == base_ref.rules
        rules_ref = ref_sharding.replicate_uneven_kv_heads(
            base_ref, ref.cfg.n_kv_heads, mesh)
        rules = sharding.replicate_uneven_kv_heads(
            base, port.cfg.n_kv_heads, mesh)
        assert rules.rules == rules_ref.rules
        for r_ref, r, fsdp in ((rules_ref, rules, False),
                               (ref_sharding.DEFAULT_RULES,
                                sharding.DEFAULT_RULES, True)):
            want = _flat(ref_steps.build_shardings(
                ref_params, ref_axes, mesh, r_ref, fsdp=fsdp))
            got = _flat(steps.build_shardings(port_params, port_axes, mesh,
                                              r, fsdp=fsdp))
            assert got == want, (shape, fsdp)
            checked += len(got)
        for n_slots in (2, 3):
            ref_c = _ref_caches(ref, n_slots, 32, 8)
            port_c = _port_caches(port, n_slots, 32, 8)
            assert set(ref_c) == set(port_c)
            for paged in ref_c:
                want = _flat(ref_sharding.serve_cache_shardings(
                    ref_c[paged], mesh, rules_ref, paged=paged))
                got = _flat(sharding.serve_cache_shardings(
                    port_c[paged], mesh, rules, paged=paged))
                assert got == want, (shape, n_slots, paged)
                checked += len(got)
    assert checked > 100


def test_serve_rule_assertions():
    """The reference parity matrix's spec assertions, on the port's specs:
    ``wq`` and ``w_gate`` shard over ``model`` (dense), the MoE's expert
    ``w_gate`` and its cache ``k`` too, zamba2's shared ``wq`` is
    replicated; slots go over ``data`` (3 slots on data=2 replicate)."""
    mesh = stand_in((2, 4))

    def specs(arch):
        _, port = _models(arch)
        rules = sharding.replicate_uneven_kv_heads(
            sharding.serve_rules_for(port.cfg.family), port.cfg.n_kv_heads,
            mesh)
        p = port.abstract_params()
        return port, rules, steps.build_shardings(
            p, steps.infer_param_axes(p), mesh, rules)

    _, _, s = specs("llama3-8b")
    assert "model" in s["layers"]["attn"]["wq"]
    assert "model" in s["layers"]["mlp"]["w_gate"]
    port, rules, s = specs("moonshot-v1-16b-a3b")
    assert "model" in s["layers"]["moe"]["w_gate"]
    cache = _port_caches(port, 2, 32, 8)[False]
    assert "model" in sharding.serve_cache_shardings(
        cache, mesh, rules)["layers"]["k"]
    _, _, s = specs("zamba2-1.2b")
    assert all(e is None for e in s["shared_attn"]["wq"])
    port, rules, _ = specs("llama3-8b")
    for n_slots, want in ((2, "data"), (3, None)):
        c = sharding.serve_cache_shardings(
            _port_caches(port, n_slots, 32, 8)[False], mesh, rules)
        assert c["pos"] == (want,)


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("mesh_shape", ((2, 4), (2, 2, 2), (16, 1)))
def test_rules_for_and_batch_specs_equal_reference(shape_name, mesh_shape,
                                                   bare_specs):
    """``rules_for`` (long-context decode's batch-1 override, uneven kv
    heads) and the batch / cache specs of a train batch and a decode
    cache equal the reference's."""
    mesh = stand_in(mesh_shape)
    shape = SHAPES[shape_name]
    for arch in ("llama3-8b", "zamba2-1.2b"):
        ref_cfg = ref_registry.ARCHS[arch]
        cfg = registry.ARCHS[arch]
        want = ref_steps.rules_for(ref_cfg, shape, mesh,
                                   ref_sharding.DEFAULT_RULES)
        got = steps.rules_for(cfg, shape, mesh, sharding.DEFAULT_RULES)
        assert got.rules == want.rules
        b = shape.global_batch
        ref_batch = {
            "tokens": jax.ShapeDtypeStruct((b, 64), "int32"),
            "labels": jax.ShapeDtypeStruct((b, 64), "int32"),
            "cache": {"k": jax.ShapeDtypeStruct((2, b, 64, 8, 16), "bfloat16"),
                      "k_scale": jax.ShapeDtypeStruct((2, b, 64, 8),
                                                      "float32"),
                      "pos": jax.ShapeDtypeStruct((), "int32")},
            "frames": jax.ShapeDtypeStruct((b, 64, 32), "float32")}
        port_batch = {"tokens": _meta(ref_batch["tokens"]),
                      "labels": _meta(ref_batch["labels"]),
                      "cache": {k: _meta(v)
                                for k, v in ref_batch["cache"].items()},
                      "frames": _meta(ref_batch["frames"])}
        assert _flat(steps.batch_specs(port_batch, mesh, got)) == _flat(
            ref_steps.batch_specs(ref_batch, mesh, want))


def _meta(sds):
    return torch.empty(sds.shape, device="meta")


def test_state_axes_equal_reference():
    _, port = _models("moonshot-v1-16b-a3b")
    params = port.abstract_params()
    state = {"params": params, "opt": {"m": params, "v": params,
                                       "count": torch.zeros(())},
             "step": torch.zeros(()), "err": params}
    axes = steps.state_axes(state)
    assert axes["opt"]["count"] == () and axes["step"] == ()
    assert axes["err"] == axes["params"] == axes["opt"]["m"] \
        == steps.infer_param_axes(params)
    ref_state = {"params": {"a": jax.ShapeDtypeStruct((2, 3), "float32")}}
    assert ref_steps.state_axes(ref_state) == steps.state_axes(
        {"params": {"a": torch.empty((2, 3), device="meta")}})


def test_rules_table_and_dedupe():
    assert sharding.DEFAULT_RULES.rules == ref_sharding.DEFAULT_RULES.rules
    assert sharding.DEFAULT_RULES.lookup("batch") == ("pod", "data")
    assert sharding.DEFAULT_RULES.lookup("no_such_axis") is None
    r2 = sharding.DEFAULT_RULES.with_overrides(kv_seq="data", batch=None)
    assert r2.rules == ref_sharding.DEFAULT_RULES.with_overrides(
        kv_seq="data", batch=None).rules
    assert sharding.DEFAULT_RULES.lookup("kv_seq") is None
    for spec in (("model", None, "model"), (("pod", "data"), "data"),
                 (None, ("data", "model"), "model")):
        assert sharding._dedupe(spec) == tuple(
            ref_sharding._dedupe(jax.sharding.PartitionSpec(*spec)))
        assert steps._dedupe_spec(spec) == sharding._dedupe(spec)
    mesh = stand_in((2, 4))
    for shape, spec in (((3, 32), ("data", "model")), ((4, 6),
                                                        ("data", "model")),
                        ((8, 16), (("data", "model"), None))):
        want = tuple(ref_sharding._drop_indivisible(
            shape, jax.sharding.PartitionSpec(*spec), mesh))
        assert sharding._drop_indivisible(shape, spec, mesh) == want
        assert steps._divisible_spec(shape, spec, mesh) == want
    names = ("batch", "seq", "vocab")
    for m in (None, mesh, stand_in((2, 2, 2))):
        assert sharding.logical_to_spec(names, sharding.DEFAULT_RULES, m) \
            == tuple(ref_sharding.logical_to_spec(
                names, ref_sharding.DEFAULT_RULES, m))
        assert sharding.constraint_spec(names, mesh=m) == tuple(
            ref_sharding.constraint_spec(names, mesh=m))
    tree = {"a": ("vocab", "embed"), "b": {"c": ("batch", None)}}
    assert sharding.param_shardings(tree, mesh) == {
        "a": ("model", None), "b": {"c": ("data", None)}}
    with pytest.raises(ValueError, match="requires an active or explicit"):
        sharding.param_shardings(tree)
    with sharding.activate(mesh, sharding.DEFAULT_RULES):
        assert sharding.active_context()[0] is mesh
        assert sharding.param_shardings(tree)["b"]["c"] == ("data", None)
    assert sharding.active_context() == (None, None)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_local_shards_reassemble(mesh_shape):
    """Every rank's ``local_shard`` of a tensor, put back where its
    placements say, rebuilds the tensor; the local shape agrees."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = stand_in(mesh_shape)
    names = mesh_axis_names(mesh_shape)
    sizes = dict(zip(names, mesh_shape))
    t = torch.arange(8 * 16 * 4, dtype=torch.float32).reshape(8, 16, 4)
    for spec in ((None, "model", None), ("data", None, "model"),
                 ((tuple(a for a in ("pod", "data") if a in sizes)
                   or None), "model", None), (None, None, None)):
        spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)
        rebuilt = torch.full_like(t, float("nan"))
        for coord in itertools.product(*(range(s) for s in mesh_shape)):
            coords = dict(zip(names, coord))
            piece = sharding.local_shard(t, spec, mesh, coords)
            assert tuple(piece.shape) == sharding.local_shape(
                t.shape, spec, mesh, coords)
            assert piece.is_contiguous()
            idx = sharding._slices(tuple(t.shape), spec, mesh, coords)
            rebuilt[idx] = piece
        assert torch.equal(rebuilt, t)

    class _DM:      # a DeviceMesh's attributes for ``placements``
        mesh_dim_names = names
        mesh = torch.zeros(mesh_shape)

    got = sharding.placements(("data", None, "model"), _DM)
    want = tuple(Shard(0) if n == "data" else Shard(2) if n == "model"
                 else Replicate() for n in names)
    assert got == want
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_shard(torch.zeros(3, 2), ("model", None),
                             stand_in((1, 2)), {"data": 0, "model": 0})


def test_parse_mesh():
    assert parse_mesh("2x4") == (2, 4)
    assert parse_mesh("2X4") == (2, 4)
    assert parse_mesh("2x2x2") == (2, 2, 2)
    assert mesh_axis_names((2, 4)) == ("data", "model")
    assert mesh_axis_names((2, 2, 2)) == ("pod", "data", "model")
    for bad in ("", "8", "2x0", "axb", "1x2x3x4", "-1x2"):
        with pytest.raises(ValueError, match="bad mesh spec"):
            parse_mesh(bad)
