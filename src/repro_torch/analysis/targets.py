"""Enumerate serve-path audit targets: families × dense/paged × mesh modes
— the port of ``repro/analysis/targets.py``.

Each family module's ``SERVE_AUDIT`` table (phases, KV stack key,
paged / suffix / chunk capability) becomes :class:`~repro_torch.analysis.
graph_audit.AuditTarget` records over the callables the engine runs: the
:class:`~repro_torch.models.api.Model` entry points, the engine's slot and
pool helpers, ``sample_batch`` and ``verify_accept``. Where the reference
traces abstract operands, a target here builds concrete ones at smoke
size (``make_args``, fresh for each run, since the bodies write their
cache in place). Names are the reference's (``"dense/paged_decode_fused
@mesh"``), so :func:`repro_torch.launch.costing.serve_target_cost` keys
them unchanged. ``paged_*`` runs the gather route (``attn_backend=
"torch"``) and ``paged_*_fused`` the kernel route (on the CPU under
:func:`repro_torch.kernels.ops.interpret`: the entry points run their
plain versions).

Mesh targets run on a (data=1, model=1) :class:`AuditMesh` in this
process, under the engine's mesh context and placement
(:class:`repro_torch.serve.mesh.MeshPlacement`): every leaf's spec is
the full table's (nothing is dropped on size-1 axes), so the coverage
and determinism rules see what a larger mesh would place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.analysis.graph_audit import AuditTarget
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.parallel.sharding import constraint_spec
from repro_torch.serve.engine import (_clear_slot, _cow_copy, _gather_prefix,
                                      _paged_write, _read_paged_slot,
                                      _read_slot, _restore_paged_slot,
                                      _write_slot)
from repro_torch.serve.mesh import MeshPlacement
from repro_torch.serve.sampling import sample_batch
from repro_torch.serve.spec import verify_accept

__all__ = ["SMOKE_BY_FAMILY", "SERVE_FAMILIES", "AUDIT_SHAPE", "AuditMesh",
           "make_audit_mesh", "build_family_targets", "enumerate_targets"]

#: family → smallest real config of that family (smoke-shrunk)
SMOKE_BY_FAMILY = {
    "dense": "llama3-8b",
    "moe": "moonshot-v1-16b-a3b",
    "ssm": "mamba2-370m",
    "hybrid": "zamba2-1.2b",
}
SERVE_FAMILIES = tuple(SMOKE_BY_FAMILY)

#: the one shape every target runs at — shared with the cost audit so
#: ``serve_target_cost`` predictions are keyed the way targets are built
AUDIT_SHAPE = dict(slots=2, max_len=32, window=4, block_size=8,
                   prefill_len=16)

_CACHE_AXES = ("batch", "kv_seq", "kv_heads_cache", "head_dim")
_POOL_AXES = (None, None, "kv_heads_cache", "head_dim")

#: each slot's cursor in the targets' caches (below every window's end)
_CURSORS = (8, 5)


class AuditMesh:
    """A (data=1, model=1) mesh of this process: the attributes of a
    ``DeviceMesh`` the placement reads, with no process group (a one-rank
    axis runs no collective)."""

    mesh_dim_names = ("data", "model")

    def __init__(self):
        self.mesh = torch.zeros((1, 1), dtype=torch.int64)

    def get_coordinate(self):
        return [0, 0]

    def get_group(self, axis: str):
        return None


def make_audit_mesh() -> AuditMesh:
    return AuditMesh()


def _norm_spec(spec, ndim: int) -> tuple:
    """A spec as a comparable tuple of ``ndim`` entries (1-tuples
    unwrapped)."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


def build_family_targets(family: str, *, mesh=None, device="cpu",
                         model=None, params=None, phases=None,
                         slots: int = 2, max_len: int = 32, window: int = 4,
                         block_size: int = 8, prefill_len: int = 16
                         ) -> List[AuditTarget]:
    """All serve-path targets of one family on one mesh mode, on
    ``device``: the family's smoke config with seeded parameters, or
    ``model`` and its ``params`` (the card's full-width model). ``phases``
    keeps only the targets of those phases."""
    dev = torch.device(device)
    if model is None:
        model = build_model(smoke_config(get_config(SMOKE_BY_FAMILY[family])))
        params = model.init(seed=0, device=dev)
    cfg = model.cfg
    hooks = model._mod.SERVE_AUDIT
    kv_key, state_key = hooks["kv_key"], model.state_key
    tag = "@mesh" if mesh is not None else ""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def ints(*shape, high=cfg.vocab):
        return torch.randint(0, high, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    rules = shard = None
    specs: Optional[Dict[str, tuple]] = None
    placement = None
    if mesh is not None:
        placement = MeshPlacement(mesh, model, None, n_slots=slots)
        rules, shard = placement.rules, placement.shard
        specs = {f"params.{p}": tuple(s) for p, s in
                 tree_leaves(placement.param_specs)}

    def dense_cache():
        cache = dict(model.init_cache(slots, max_len, device=dev))
        cache["pos"] = torch.tensor(_CURSORS[:slots], dtype=torch.int32,
                                    device=dev)
        return cache

    max_blocks = max_len // block_size
    n_blocks = slots * max_blocks

    def paged_cache():
        cache = model.init_paged_cache(slots, n_blocks + 1, block_size,
                                       max_blocks, device=dev)
        cache["block_tables"].copy_(1 + torch.arange(
            n_blocks, dtype=torch.int32, device=dev).reshape(slots,
                                                             max_blocks))
        cache["pos"].copy_(torch.tensor(_CURSORS[:slots], dtype=torch.int32))
        return cache

    def layout(cache, paged: bool):
        """``(specs, kv_specs)`` of a target whose cache is ``cache``."""
        if placement is None:
            return None, ()
        meta = tree_map(lambda t: t.to("meta"), cache)
        cache_specs = placement.cache_specs(meta, paged=paged)
        all_specs = dict(specs)
        all_specs.update({f"cache.{p}": tuple(s)
                          for p, s in tree_leaves(cache_specs)})
        want = []
        if kv_key is not None:
            axes = _POOL_AXES if paged else _CACHE_AXES
            for name in ("k", "v"):
                ndim = cache[kv_key][name].dim()
                want.append((f"cache.{kv_key}.{name}", (None,) + _norm_spec(
                    constraint_spec(axes, rules, mesh), ndim - 1)))
        return ({p: _norm_spec(s, len(s)) for p, s in all_specs.items()},
                tuple(want))

    d_specs, d_kv = layout(dense_cache(), False)

    def mk(phase, fn, make_args, *, donate=(), det=True, context=None,
           paged=False):
        sp, kv = (layout(paged_cache(), True) if paged
                  else (d_specs, d_kv))
        return AuditTarget(
            name=f"{family}/{phase}{tag}", family=family, fn=fn,
            make_args=make_args, donate=tuple(donate), kv_key=kv_key,
            state_key=state_key,
            deterministic=det, mesh=mesh, rules=rules, shard=shard,
            specs=sp, kv_specs=kv if donate else (), context=context)

    targets: List[AuditTarget] = []
    ph = hooks["phases"]

    if "prefill" in ph:
        if model.supports_padded_prefill:
            def prefill(p, t, pl):
                return model.prefill(p, {"tokens": t}, max_len=max_len,
                                     prompt_len=pl)

            targets.append(mk("prefill", prefill, lambda: (
                params, ints(slots, prefill_len),
                torch.tensor(prefill_len - 3, dtype=torch.int32,
                             device=dev))))
        else:
            def prefill(p, t):
                return model.prefill(p, {"tokens": t}, max_len=max_len)

            targets.append(mk("prefill", prefill, lambda: (
                params, ints(slots, prefill_len))))

    if "decode" in ph:
        targets.append(mk("decode", model.decode_step, lambda: (
            params, dense_cache(), ints(slots, 1)), donate=(1,)))

    if "verify" in ph and model.supports_spec_decode:
        targets.append(mk("verify", model.verify_step, lambda: (
            params, dense_cache(), ints(slots, window)), donate=(1,)))

    if "commit" in ph and model.supports_spec_decode:
        def commit_args():
            cache = dense_cache()
            _, cache, aux = model.verify_step(params, cache,
                                              ints(slots, window))
            keep = torch.tensor([2, 1][:slots], dtype=torch.int32,
                                device=dev)
            return cache, keep, aux

        targets.append(mk("commit", lambda c, k, a: model.commit_verified(
            c, k, a), commit_args, donate=(0,)))

    def pre_cache():
        """A batch-1 prefill's cache: what the engine installs."""
        return model.prefill(params, {"tokens": ints(1, prefill_len)},
                             max_len=max_len)[1]

    targets.append(mk("write_slot", _write_slot, lambda: (
        dense_cache(), pre_cache(), 1), donate=(0,)))
    targets.append(mk("read_slot", _read_slot, lambda: (dense_cache(), 1)))

    if hooks.get("prefill_chunk"):
        def chunk_state():
            cache1 = model.init_cache(1, max_len, device=dev)
            return {state_key: cache1[state_key],
                    "pos": torch.tensor(prefill_len, dtype=torch.int32,
                                        device=dev)}

        if family == "ssm":
            targets.append(mk(
                "prefill_chunk", lambda p, t, st: model.prefill_chunk(
                    p, {"tokens": t}, state=st),
                lambda: (params, ints(1, prefill_len), chunk_state())))
        else:
            def chunk_prefix():
                kv = dense_cache()[kv_key]
                return {name: torch.randn(
                    (kv[name].shape[0], 1, prefill_len)
                    + tuple(kv[name].shape[3:]), generator=gen).to(
                        dev, cfg.cdtype) for name in ("k", "v")}

            targets.append(mk(
                "prefill_chunk", lambda p, t, st, pre: model.prefill_chunk(
                    p, {"tokens": t}, state=st, prefix_kv=pre),
                lambda: (params, ints(1, prefill_len), chunk_state(),
                         chunk_prefix())))

    if family == "dense":
        # the engine's samplers are family-independent: audited once; the
        # policy is the engine's host state (its all-greedy test included)
        def policy():
            temps = torch.zeros((slots,), dtype=torch.float32)
            greedy = torch.ones((slots,), dtype=torch.bool)
            return temps.to(dev), greedy.to(dev)

        def logits(*shape):
            return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

        targets.append(mk(
            "sample", functools.partial(sample_batch, all_greedy=True),
            lambda: (logits(slots, cfg.vocab), *policy(), None), det=False))
        targets.append(mk(
            "accept", functools.partial(verify_accept, all_greedy=True),
            lambda: (logits(slots, window, cfg.vocab),
                     ints(slots, window - 1), *policy(), None), det=False))

    if not hooks["paged"]:
        return _keep(targets, phases)

    # ---- paged layout ------------------------------------------------------
    def mkp(phase, fn, make_args, **kw):
        return mk(f"paged_{phase}", fn, make_args, paged=True, **kw)

    tokens1 = lambda: ints(slots, 1)                      # noqa: E731
    gather = build_model(dataclasses.replace(cfg, attn_backend="torch"))
    fused = build_model(dataclasses.replace(cfg, attn_backend="kernel"))
    targets.append(mkp("decode", gather.paged_decode_step, lambda: (
        params, paged_cache(), tokens1()), donate=(1,)))
    # the engine's live-block bucket: the first ``hw`` table columns
    hw = max(max_blocks // 2, 1)
    targets.append(mkp("decode_hw", functools.partial(
        gather.paged_decode_step, live_blocks=hw), lambda: (
            params, paged_cache(), tokens1()), donate=(1,)))
    targets.append(mkp("decode_fused", fused.paged_decode_step, lambda: (
        params, paged_cache(), tokens1()), donate=(1,),
        context=ops.interpret))
    if model.supports_spec_decode:
        targets.append(mkp("verify", gather.paged_verify_step, lambda: (
            params, paged_cache(), ints(slots, window)), donate=(1,)))
        targets.append(mkp("verify_fused", fused.paged_verify_step, lambda: (
            params, paged_cache(), ints(slots, window)), donate=(1,),
            context=ops.interpret))

    def ids(*values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    targets.append(mkp("gather_prefix", functools.partial(
        _gather_prefix, cdtype=cfg.cdtype), lambda: (
            paged_cache()[kv_key], ids(1, 2))))

    # the prefill scatter: ``nb`` written blocks of a batch-1 prefill
    nb = 2

    def write_args():
        pre = pre_cache()
        pre_kv, pre_state = model.split_prefill_cache(pre)
        pre_kv = {name: leaf[:, :, :nb * block_size]
                  for name, leaf in pre_kv.items()}
        return (paged_cache(), pre_kv, pre_state, ids(3, 4),
                ids(*range(1, max_blocks + 1)), 1,
                torch.tensor(nb * block_size, dtype=torch.int32, device=dev))

    targets.append(mkp("write", functools.partial(_paged_write,
                                                  kv_key=kv_key),
                       write_args, donate=(0,)))
    targets.append(mkp("cow_copy", functools.partial(_cow_copy,
                                                     kv_key=kv_key),
                       lambda: (paged_cache(), 2, n_blocks, 1, 0),
                       donate=(0,)))
    targets.append(mkp("clear_slot", _clear_slot,
                       lambda: (paged_cache(), 1), donate=(0,)))
    has_ssm = family == "hybrid"
    read_paged = functools.partial(_read_paged_slot, has_ssm=has_ssm)
    targets.append(mkp("read_slot", read_paged,
                       lambda: (paged_cache(), 1)))

    def restore_args():
        cache = paged_cache()
        snap = _clone(read_paged(cache, 0))
        return cache, snap, ids(*range(1, max_blocks + 1)), 1

    targets.append(mkp("restore_slot", _restore_paged_slot, restore_args,
                       donate=(0,)))

    if hooks["suffix_prefill"]:
        def suffix_args():
            prefix = _gather_prefix(paged_cache()[kv_key], ids(1, 2),
                                    cdtype=cfg.cdtype)
            return (params, ints(1, prefill_len), prefix,
                    nb * block_size + prefill_len)

        targets.append(mkp(
            "suffix_prefill", lambda p, t, pre, pl: model.prefill_suffix(
                p, {"tokens": t}, prefix=pre, prompt_len=pl), suffix_args))
    return _keep(targets, phases)


def _keep(targets, phases):
    if phases is None:
        return targets
    return [t for t in targets
            if t.name.split("/", 1)[1].split("@", 1)[0] in phases]


def enumerate_targets(families: Sequence[str] = SERVE_FAMILIES,
                      mesh_modes: Sequence[str] = ("none", "mesh"),
                      **kwargs) -> List[AuditTarget]:
    """The full matrix: families × dense/paged × mesh/no mesh."""
    out: List[AuditTarget] = []
    for mode in mesh_modes:
        mesh = make_audit_mesh() if mode == "mesh" else None
        for family in families:
            out.extend(build_family_targets(family, mesh=mesh, **kwargs))
    return out
