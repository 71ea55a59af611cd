"""Rank bodies of ``test_torch_production_mesh.py``: one spawn of four gloo
ranks on the CPU, importing nothing of JAX.

Every rank draws the same seeded smoke llama3-8b with 8 q heads and 2 KV
heads (f32), so that a model axis of 4 splits the q heads two a rank and
replicates the KV heads, each rank attending the one its q heads share
(ranks 0–1 KV head 0, ranks 2–3 KV head 1). On ``(1, 4)`` it serves
(both cache layouts) and runs the meshed prefill and decode steps and a
train step; on ``(2, 2, 1)`` a plain data-parallel train step over the
pod and data axes, and one with FSDP over them. With 6 q heads, which
the model axis of 4 does not divide, the attention replicates over
``model``: on ``(1, 4)`` it serves and takes a train step. What rank 0
returns is held by the test against one device (:func:`one_device`, run
in the test's own process).
"""

import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data import SyntheticLMData
from repro_torch.interop import tree_leaves
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import build_model
from repro_torch.parallel import collectives
from repro_torch.serve import ServeEngine, StepClock, poisson_workload

#: f32 weights and compute; a vocabulary the model axis splits; q heads
#: the model axis of 4 splits, KV heads it does not
OVERRIDES = dict(param_dtype="float32", compute_dtype="float32", vocab=256,
                 n_heads=8, n_kv_heads=2)
HYPER = dict(peak_lr=5e-3, warmup_steps=2, total_steps=10)
#: global batch rows and sequence length of the train steps; steps of the
#: plain data-parallel trajectory
ROWS, SEQ, STEPS = 4, 16, 3
MAX_LEN, BLOCK = 32, 8
#: q heads the model axis of 4 does not divide (the attention replicates)
UNEVEN_HEADS = 6
#: seconds the spawn may take before the test fails
JOIN_S = 240


def config(n_heads: int = OVERRIDES["n_heads"]):
    return dataclasses.replace(
        registry.smoke_config(registry.ARCHS["llama3-8b"]),
        **dict(OVERRIDES, n_heads=n_heads))


def params(n_heads: int = OVERRIDES["n_heads"]):
    return build_model(config(n_heads)).init(seed=0, device="cpu")


def data() -> SyntheticLMData:
    cfg = config()
    return SyntheticLMData(vocab=cfg.vocab, seq_len=SEQ, global_batch=ROWS,
                           seed=0, family="lm", d_model=cfg.d_model)


def prompts() -> torch.Tensor:
    g = np.random.default_rng(1)
    return torch.as_tensor(g.integers(0, 256, (2, 12)), dtype=torch.int32)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def serve_tokens(model, p, mesh=None) -> dict:
    """Greedy tokens of a Poisson workload in both cache layouts."""
    out = {}
    for paged in (False, True):
        kw = dict(paged=True, block_size=BLOCK) if paged else {}
        eng = ServeEngine(model, p, n_slots=2, max_len=MAX_LEN, device="cpu",
                          clock=StepClock(1e-3), mesh=mesh, **kw)
        reqs = poisson_workload(n_requests=4, vocab=256, rate_rps=100.0,
                                prompt_len_range=(4, 12),
                                gen_len_range=(2, 6), seed=0)
        results, _ = eng.run(reqs, warmup=True)
        out[paged] = [[int(t) for t in r.tokens] for r in results]
    return out


def serve_steps(model, p, mesh=None) -> dict:
    """Teacher-forced logits: the prefill step's at the last prompt
    position, then two decode steps' (whole vocabulary)."""
    prefill = steps.build_prefill_step(model, max_len=MAX_LEN, mesh=mesh)
    decode = steps.build_decode_step(model, mesh=mesh)
    pl = prefill.placement
    if pl is not None:
        p = pl.local_params(p, "cpu")

    def whole(logits):
        if pl is None:
            return _np(logits)
        return _np(collectives.gather_whole(logits, (None, None, "model"),
                                            pl.mesh))

    toks = prompts()
    out = []
    with torch.no_grad():
        logits, cache = prefill(p, {"tokens": toks})
        out.append(whole(logits))
        cache["pos"] = torch.tensor(cache["pos"], dtype=torch.int32)
        for i in range(2):
            logits, cache = decode(p, cache, toks[:, i:i + 1])
            out.append(whole(logits))
    return {"logits": out, "pos": int(cache["pos"])}


def train_step(model, p, mesh=None, *, fsdp=True, microbatches=1,
               n_steps=1) -> dict:
    """``n_steps`` train steps on the global batches of :func:`data`:
    step 0's loss and gradients and the state after the last step, every
    leaf whole."""
    hp = steps.TrainHyper(**HYPER, microbatches=microbatches)
    step = steps.build_train_step(model, hyper=hp, mesh=mesh, fsdp=fsdp,
                                  return_grads=True)
    pl = step.placement
    state = steps.init_train_state(model, hyper=hp, device="cpu", params=p,
                                   placement=pl)
    d = data()

    def whole(tree, specs):
        if pl is None:
            return {path: _np(t) for path, t in tree_leaves(tree)}
        spec = dict(tree_leaves(specs))
        return {path: _np(collectives.gather_whole(t.detach(), spec[path],
                                                   pl.mesh))
                for path, t in tree_leaves(tree)}

    losses = []
    for s in range(n_steps):
        batch = d.batch_for_step(s)
        if pl is not None:
            batch = steps.local_batch(batch, pl)
        state, m, g = step(state, batch)
        losses.append(float(m["loss"]))
        if s == 0:
            grads = whole(g, None if pl is None else pl.param_specs)
    state_specs = None if pl is None else steps.state_specs(state, pl)
    out = {"loss": losses[0], "losses": losses, "grads": grads,
           "state": whole(state, state_specs)}
    if pl is not None:
        out["shard"] = (pl.shard.heads, pl.shard.kv_heads, pl.shard.kv_slice)
        out["attention_replicated"] = pl.attention_replicated
        out["data"] = steps.data_layout(pl)[1:]
    return out


def one_device() -> dict:
    """What :func:`ranks` computes, on one device (plain data parallelism
    over four ranks: the step at ``microbatches=4``)."""
    model = build_model(config())
    uneven = build_model(config(UNEVEN_HEADS))
    return {"serve": serve_tokens(model, params()),
            "steps": serve_steps(model, params()),
            "train": train_step(model, params()),
            "micro": train_step(model, params(), microbatches=4,
                                n_steps=STEPS),
            "uneven_serve": serve_tokens(uneven, params(UNEVEN_HEADS)),
            "uneven_train": train_step(uneven, params(UNEVEN_HEADS))}


def ranks(rank: int) -> dict:
    torch.manual_seed(0)
    model = build_model(config())
    out = {}
    mesh = make_mesh((1, 4), device="cpu")
    out["serve"] = serve_tokens(model, params(), mesh)
    out["steps"] = serve_steps(model, params(), mesh)
    out["train"] = train_step(model, params(), mesh)
    pods = make_mesh((2, 2, 1), device="cpu")
    out["pod"] = train_step(model, params(), pods, fsdp=False,
                            n_steps=STEPS)
    out["pod_fsdp"] = train_step(model, params(), pods)
    uneven = build_model(config(UNEVEN_HEADS))
    out["uneven_serve"] = serve_tokens(uneven, params(UNEVEN_HEADS), mesh)
    out["uneven_train"] = train_step(uneven, params(UNEVEN_HEADS), mesh)
    if rank:        # the whole leaves are alike on every rank
        for key in ("train", "pod", "pod_fsdp", "uneven_train"):
            out[key] = {k: v for k, v in out[key].items()
                        if k not in ("grads", "state")}
    return out
