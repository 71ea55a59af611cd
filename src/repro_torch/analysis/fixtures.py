"""Deliberately broken audit targets and sources: every rule's proof of
life — the port of ``repro/analysis/fixtures.py``.

A gate that never fires cannot be told from one wired up wrong, so each
rule has a minimal fixture here that must produce that violation, and the
lint rules near-misses that must stay clean (``tests/test_torch_analysis.
py``, ``tests/test_torch_cost_audit.py``). The graph fixtures' bodies live
in this file on purpose: their ops resolve to ``src/repro_torch/analysis/
fixtures.py``, which is on no allowlist, so the upcast fixture exercises
the real site attribution.
"""

from __future__ import annotations

import functools
import textwrap
from typing import Callable, Dict, Tuple

import torch

from repro_torch.analysis.graph_audit import AuditTarget
from repro_torch.launch.mesh import fake_world
from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import RankShard

__all__ = ["GRAPH_FIXTURES", "LINT_FIXTURES", "CLEAN_LINT_FIXTURES",
           "COST_FIXTURES", "unbounded_while", "drifting_cost",
           "product_loop"]

_KV_SHAPE = (2, 2, 32, 2, 16)          # (stack, slots, max_len, Hk, D)
_KV_WANT = (None, "data", None, "model", None)


def _bf16_44():
    return torch.arange(16, dtype=torch.float32).reshape(4, 4).to(
        torch.bfloat16) / 16


def _cache():
    return {"layers": {"k": torch.zeros(_KV_SHAPE, dtype=torch.bfloat16),
                       "v": torch.zeros(_KV_SHAPE, dtype=torch.bfloat16)},
            "pos": torch.zeros((2,), dtype=torch.int32)}


def _mesh():
    from repro_torch.analysis.targets import make_audit_mesh

    return make_audit_mesh()


def bad_host_read() -> AuditTarget:
    """``.item()`` inside a tick body → no-host-transfer."""

    def fn(x):
        return x + x.sum().item()

    return AuditTarget(name="fixture/host-read", family="dense", fn=fn,
                       make_args=lambda: (_bf16_44(),))


def bad_data_shape() -> AuditTarget:
    """A boolean mask index (an output sized by the data) →
    no-host-transfer."""

    def fn(x):
        return x[x > 0.5]

    return AuditTarget(name="fixture/data-shape", family="dense", fn=fn,
                       make_args=lambda: (_bf16_44(),))


def bad_rebound_leaf() -> AuditTarget:
    """A donated cache whose leaf is replaced, not written →
    donation-honored."""

    def fn(cache):
        cache["layers"]["k"] = cache["layers"]["k"] + 1
        return cache

    return AuditTarget(name="fixture/rebound-leaf", family="dense", fn=fn,
                       make_args=lambda: (_cache(),), donate=(0,),
                       kv_key="layers")


def bad_cache_copy() -> AuditTarget:
    """The whole KV leaf materialized by a functional update, then copied
    back → donation-honored (a copy of the cache every tick)."""

    def fn(cache):
        k = cache["layers"]["k"]
        k.copy_(torch.where(k > 0, k, k + 1))
        return cache

    return AuditTarget(name="fixture/cache-copy", family="dense", fn=fn,
                       make_args=lambda: (_cache(),), donate=(0,),
                       kv_key="layers")


def bad_upcast() -> AuditTarget:
    """A bf16 → f32 widening issued here (no allowlisted site) →
    f32-upcast-allowlist."""

    def fn(x):
        return torch.sum(x.float())

    return AuditTarget(name="fixture/upcast", family="dense", fn=fn,
                       make_args=lambda: (_bf16_44(),))


def bad_rng() -> AuditTarget:
    """A random draw on a deterministic target → determinism."""

    def fn(x):
        return x + torch.rand(x.shape).to(x.dtype)

    return AuditTarget(name="fixture/rng", family="dense", fn=fn,
                       make_args=lambda: (_bf16_44(),), deterministic=True)


def bad_model_spec() -> AuditTarget:
    """A model-axis spec on a bitwise-reproducible (ssm) family →
    determinism."""
    return AuditTarget(name="fixture/model-spec", family="ssm",
                       fn=lambda x: x * 2, make_args=lambda: (_bf16_44(),),
                       mesh=_mesh(), specs={"params.w": (None, "model")})


def bad_model_collective() -> AuditTarget:
    """A row-parallel sum over ``model`` on a bitwise-reproducible (ssm)
    family → determinism."""

    def fn(x):
        return collectives.reduce_partial(x.clone(), "model")

    return AuditTarget(name="fixture/model-collective", family="ssm", fn=fn,
                       make_args=lambda: (_bf16_44(),), mesh=_mesh(),
                       shard=RankShard(group=None, size=2, rank=0),
                       specs={}, context=functools.partial(fake_world, 2))


def bad_missing_spec() -> AuditTarget:
    """A KV leaf with no placement spec on a mesh →
    kv-constraint-coverage (missing)."""
    return AuditTarget(name="fixture/missing-spec", family="dense",
                       fn=lambda cache: cache, make_args=lambda: (_cache(),),
                       donate=(0,), kv_key="layers", mesh=_mesh(), specs={},
                       kv_specs=(("cache.layers.k", _KV_WANT),))


def bad_mismatched_spec() -> AuditTarget:
    """A KV leaf placed other than the table says →
    kv-constraint-coverage (mismatch)."""
    return AuditTarget(name="fixture/mismatched-spec", family="dense",
                       fn=lambda cache: cache, make_args=lambda: (_cache(),),
                       donate=(0,), kv_key="layers", mesh=_mesh(),
                       specs={"cache.layers.k": (None, None, "model", None,
                                                 None)},
                       kv_specs=(("cache.layers.k", _KV_WANT),))


#: rule id (with a variant after ``/``) → fixture builder
GRAPH_FIXTURES: Dict[str, Callable[[], AuditTarget]] = {
    "no-host-transfer": bad_host_read,
    "no-host-transfer/data-shape": bad_data_shape,
    "donation-honored": bad_rebound_leaf,
    "donation-honored/copy": bad_cache_copy,
    "f32-upcast-allowlist": bad_upcast,
    "determinism": bad_rng,
    "determinism/model-spec": bad_model_spec,
    "determinism/model-collective": bad_model_collective,
    "kv-constraint-coverage": bad_missing_spec,
    "kv-constraint-coverage/mismatch": bad_mismatched_spec,
}


def unbounded_while() -> AuditTarget:
    """A loop whose trip count the data decides (a ``while`` on a value
    read back from the device): its product site repeats after a host
    read → audit-unbounded-loop."""

    def fn(x):
        s = x.float()
        while float(s.abs().sum()) < 1e6:
            s = s @ s + 1
        return s

    return AuditTarget(name="fixture/unbounded-while", family="dense",
                       fn=fn, make_args=lambda: (_bf16_44(),))


def product_loop(n: int) -> Tuple[AuditTarget, float]:
    """``n`` 4×4 products in a Python loop, and their FLOPs: an eager
    loop counts every trip."""

    def fn(x):
        for _ in range(n):
            x = x @ x
        return x

    target = AuditTarget(name="fixture/product-loop", family="dense", fn=fn,
                         make_args=lambda: (torch.eye(4) * 0.5,))
    return target, n * 2.0 * 4 * 4 * 4


def drifting_cost() -> Tuple[AuditTarget, Dict[str, float]]:
    """A 4×4 product (128 FLOPs) against a prediction 25 % low →
    audit-cost-drift."""
    target, flops = product_loop(1)
    return (AuditTarget(name="fixture/cost-drift", family="dense",
                        fn=target.fn, make_args=target.make_args),
            {"flops": flops * 0.75})


#: cost rule id → fixture builder
COST_FIXTURES: Dict[str, Callable] = {
    "audit-unbounded-loop": unbounded_while,
    "audit-cost-drift": drifting_cost,
}


def _src(text: str) -> str:
    return textwrap.dedent(text).lstrip()


#: lint rule id → (pretend repo-relative path, source) that must trip it
LINT_FIXTURES: Dict[str, Tuple[str, str]] = {
    "lint-compile-in-init": ("src/repro_torch/serve/_fixture.py", _src("""
        import torch

        class Engine:
            def __init__(self, fn):
                self.step = torch.compile(fn)
    """)),
    "lint-compile-in-init/capture": ("src/repro_torch/launch/_fixture.py",
                                     _src("""
        import torch

        class Runner:
            def __init__(self, fn, x):
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self.out = fn(x)
    """)),
    "lint-sync-in-loop": ("src/repro_torch/serve/_fixture.py", _src("""
        def tick_loop(engine, requests):
            out = []
            for r in requests:
                out.append(engine.step(r).item())
            return out
    """)),
    "lint-torch-in-loop": ("src/repro_torch/serve/_fixture.py", _src("""
        import torch

        def detok(logits_list):
            toks = []
            for logits in logits_list:
                toks.append(torch.argmax(logits))
            return toks
    """)),
    "lint-stale-allow": ("src/repro_torch/serve/_fixture.py", _src("""
        import torch

        # torch-audit: allow(lint-compile-in-init)
        def build(fn):
            return torch.compile(fn)
    """)),
}

#: near-misses that must stay clean (scoping and suppression are part of
#: each rule's contract)
CLEAN_LINT_FIXTURES: Dict[str, Tuple[str, str]] = {
    "compile-outside-init": ("src/repro_torch/serve/_fixture.py", _src("""
        import torch

        def build(fn):
            return torch.compile(fn)
    """)),
    "capture-in-graphs-module": ("src/repro_torch/serve/graphs.py", _src("""
        import torch

        class Graph:
            def __init__(self, fn, x):
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self.out = fn(x)
    """)),
    "compile-in-init-allowed": ("src/repro_torch/launch/_fixture.py", _src("""
        import torch

        class Trainer:
            def __init__(self, fn):
                # torch-audit: allow(lint-compile-in-init)
                self.step = torch.compile(fn)
    """)),
    "sync-outside-loop": ("src/repro_torch/serve/_fixture.py", _src("""
        def warmup(engine, r):
            return engine.step(r).cpu()
    """)),
    "torch-loop-outside-serve": ("src/repro_torch/layers/_fixture.py",
                                 _src("""
        import torch

        def stack_all(xs):
            out = []
            for x in xs:
                out.append(torch.as_tensor(x))
            return out
    """)),
    "numpy-in-loop": ("src/repro_torch/serve/_fixture.py", _src("""
        import numpy as np

        def host_tokens(rows):
            out = np.zeros((len(rows),), np.int32)
            for i, r in enumerate(rows):
                out[i] = np.argmax(r)
            return out
    """)),
    "reference-marker-ignored": ("src/repro_torch/serve/_fixture.py", _src("""
        import torch

        # audit: allow(lint-jit-in-init)
        def build(fn):
            return torch.compile(fn)
    """)),
    "allow-in-string-not-stale": ("src/repro_torch/serve/_fixture.py", _src("""
        BANNER = "# torch-audit: allow(lint-compile-in-init)"
    """)),
}
