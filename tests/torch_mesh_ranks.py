"""Rank bodies of the port's mesh tests (``test_torch_mesh_*.py``).

Each runs in a spawned rank of :func:`repro_torch.launch.mesh.run_ranks`
over a gloo group on the CPU, and imports nothing of JAX: every rank draws
the same seeded smoke model, builds its meshes and serves the matrix of
one architecture on each, returning what the test holds against one
device.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import build_model
from repro_torch.parallel.collectives import vocab_gather
from repro_torch.serve import (OracleDrafter, ServeEngine, StepClock,
                               poisson_workload)

#: f32 weights and compute: the mesh's tokens must equal one device's
F32 = dict(param_dtype="float32", compute_dtype="float32")
MAX_LEN, BLOCK, CHUNK = 32, 8, 8
#: seconds a spawn of ranks may take before its test fails
JOIN_S = 240


def config(arch: str, **overrides):
    return dataclasses.replace(registry.smoke_config(registry.ARCHS[arch]),
                               **F32, **overrides)


def cases(model) -> list:
    """``(paged, spec, chunk)`` of the matrix: both layouts (dense-slot
    only without K/V), plain and oracle spec, and a chunked prefill."""
    layouts = (False, True) if model.cache_spec().pageable else (False,)
    out = [(paged, spec, None) for paged in layouts for spec in (False,
                                                                 True)]
    if model.supports_chunked_prefill:
        out.append((layouts[-1], False, CHUNK))
    return out


def workload(cfg, n: int = 4):
    return poisson_workload(n_requests=n, vocab=cfg.vocab, rate_rps=100.0,
                            prompt_len_range=(4, 12), gen_len_range=(2, 6),
                            seed=0)


def engine(model, params, *, paged, spec=False, chunk=None, mesh=None,
           n_slots: int = 2):
    kw = dict(paged=True, block_size=BLOCK) if paged else {}
    return ServeEngine(model, params, n_slots=n_slots, max_len=MAX_LEN,
                       device="cpu", clock=StepClock(1e-3), mesh=mesh,
                       drafter=OracleDrafter(2) if spec else None,
                       prefill_chunk_tokens=chunk, **kw)


def tokens(eng, n: int = 4) -> list:
    results, _ = eng.run(workload(eng.model.cfg, n), warmup=True)
    return [[int(t) for t in r.tokens] for r in results]


def forced_tokens(cfg) -> torch.Tensor:
    g = np.random.default_rng(1)
    return torch.as_tensor(g.integers(0, cfg.vocab, (1, 12)), dtype=torch.long)


def forward_logits(eng) -> np.ndarray:
    """Teacher-forced logits of :func:`forced_tokens` through the
    engine's model on its shards (whole vocabulary)."""
    batch = {"tokens": forced_tokens(eng.model.cfg)}
    with torch.no_grad(), eng._mesh_context():
        return vocab_gather(eng.model.forward(eng.params, batch)).numpy()


def _cache_layout(eng) -> dict:
    return {path: (tuple(t.shape), t.data_ptr())
            for path, t in _leaves(eng.cache)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def decode_keeps_cache(eng) -> bool:
    """One decode step leaves every cache leaf's shape and storage."""
    before = _cache_layout(eng)
    toks = np.zeros((eng.n_slots, 1), np.int32)
    hw = eng._hw_buckets()[0] if eng.paged else 0
    with torch.no_grad(), eng._mesh_context():
        eng._decode(hw, toks)
    return _cache_layout(eng) == before


def matrix(rank: int, arch: str, jobs: dict) -> dict:
    """For each job ``name: (config overrides, meshes)``, every case of
    :func:`cases` on each mesh, plus the teacher-forced logits, the specs
    and the rank's split, the cache across a decode step, a 3-slot engine
    and a reload (seed 1's weights), by ``(name, mesh shape)``."""
    out = {}
    for name, (overrides, meshes) in jobs.items():
        out.update({(name, shape): got for shape, got in _matrix(
            arch, overrides, meshes).items()})
    return out


def _matrix(arch: str, overrides: dict, meshes) -> dict:
    torch.manual_seed(0)
    cfg = config(arch, **overrides)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    out = {}
    for shape in meshes:
        mesh = make_mesh(shape, device="cpu")
        got = {"tokens": {}}
        for paged, spec, chunk in cases(model):
            eng = engine(model, params, paged=paged, spec=spec, chunk=chunk,
                         mesh=mesh)
            got["tokens"][(paged, spec, chunk)] = tokens(eng)
        eng = engine(model, params, paged=False, mesh=mesh)
        got["logits"] = forward_logits(eng)
        got["stable_cache"] = decode_keeps_cache(eng)
        mp = eng._mp
        got["rule_specs"] = dict(_leaves(mp.rule_specs))
        got["param_specs"] = dict(_leaves(mp.param_specs))
        got["cache_specs"] = dict(_leaves(eng.cache_specs))
        got["split"] = dataclasses.asdict(dataclasses.replace(mp.shard,
                                                              group=None))
        got["rows"] = mp.rows
        got["local_shapes"] = {p: tuple(t.shape)
                               for p, t in _leaves(eng.params)}
        three = engine(model, params, paged=False, mesh=mesh, n_slots=3)
        got["three_slots"] = (tokens(three), three.cache_specs["pos"],
                              three._mp.rows)
        reload = engine(model, params, paged=model.cache_spec().pageable,
                        mesh=mesh)
        tokens(reload)
        reload.reload_params(model.init(seed=1, device="cpu"))
        got["reloaded"] = tokens(reload)
        out[shape] = got
    return out


def fail_on_rank_one(rank: int) -> None:
    """Rank 1 raises while rank 0 waits in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("diverged")
    dist.all_reduce(torch.zeros(1))


def single_device(arch: str, overrides: dict) -> dict:
    """What :func:`matrix` computes on a mesh, on one device."""
    model = build_model(config(arch, **overrides))
    params = model.init(seed=0, device="cpu")
    out = {"tokens": {}}
    for paged, spec, chunk in cases(model):
        out["tokens"][(paged, spec, chunk)] = tokens(engine(
            model, params, paged=paged, spec=spec, chunk=chunk))
    out["logits"] = forward_logits(engine(model, params, paged=False))
    out["three_slots"] = tokens(engine(model, params, paged=False,
                                       n_slots=3))
    out["reloaded"] = tokens(engine(model, model.init(seed=1, device="cpu"),
                                    paged=model.cache_spec().pageable))
    return out


def check_matrix(got_by_rank, want: dict, shape) -> None:
    """Every rank's tokens equal one device's (each case of the matrix,
    the 3-slot engine, the reload); the cache kept its storage across a
    decode step; the teacher-forced logits agree within 1e-4 of their
    largest magnitude."""
    for got in got_by_rank:
        mine = got[shape]
        assert mine["tokens"] == want["tokens"], shape
        assert mine["three_slots"][0] == want["three_slots"], shape
        assert mine["reloaded"] == want["reloaded"], shape
        assert mine["stable_cache"], shape
        rel = np.abs(mine["logits"] - want["logits"]).max() \
            / np.abs(want["logits"]).max()
        assert rel <= 1e-4, (shape, rel)
