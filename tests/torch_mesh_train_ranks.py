"""Rank bodies of the port's meshed-training tests
(``test_torch_mesh_train.py``, ``test_torch_mesh_ckpt.py``).

Each runs in a spawned rank of :func:`repro_torch.launch.mesh.run_ranks`
over a gloo group on the CPU and imports nothing of JAX. Every rank draws
the same seeded smoke model (f32) and the same global batches, builds its
mesh and trains its shards; rank 0 returns what the tests hold against the
one-device trainer (:func:`one_device`, run in the test's own process):
each leaf assembled whole from the ranks' pieces.
"""

import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data import SyntheticLMData
from repro_torch.interop import tree_leaves
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import TrainLoop
from repro_torch.layers import moe as moe_mod
from repro_torch.models.api import build_model
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import activate, local_slices
from repro_torch.runtime import FailureInjector

#: f32 weights and compute: the bars are f32 sums in other orders
F32 = dict(param_dtype="float32", compute_dtype="float32")
#: a vocabulary the model axis splits (the smoke configs' 257 does not)
EVEN = dict(vocab=256)
HYPER = dict(peak_lr=5e-3, warmup_steps=2, total_steps=10)
#: steps of each case's trajectory
STEPS = 3
#: seconds a spawn of ranks may take before its test fails (one took
#: ~140 s beside the whole suite's six test workers)
JOIN_S = 480

#: name → arch, config overrides, global batch rows, sequence length
CASES = {
    "llama3": ("llama3-8b", {}, 4, 16),
    "llama3-even": ("llama3-8b", dict(EVEN, n_kv_heads=2), 4, 16),
    "qwen-bias": ("qwen1.5-32b", EVEN, 4, 16),
    "moonshot": ("moonshot-v1-16b-a3b", EVEN, 4, 16),
    "hubert": ("hubert-xlarge", EVEN, 4, 16),
    "llava": ("llava-next-34b", EVEN, 4, 24),
    "mamba2": ("mamba2-370m", {}, 4, 16),
    "zamba2": ("zamba2-1.2b", {}, 4, 16),
}


def config(arch: str, **overrides):
    return dataclasses.replace(registry.smoke_config(registry.ARCHS[arch]),
                               **F32, **overrides)


def case_config(name: str):
    arch, overrides, _, _ = CASES[name]
    return config(arch, **overrides)


def data(name: str) -> SyntheticLMData:
    cfg = case_config(name)
    _, _, batch, seq = CASES[name]
    return SyntheticLMData(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0,
        family="encoder" if cfg.family == "encoder" else "lm",
        d_model=cfg.d_model, n_patches=cfg.n_patches)


def biased(params, seed: int = 7):
    """``params`` with nonzero QKV biases drawn from ``seed`` (numpy), the
    arch's own init leaving them zero."""
    attn = params["layers"]["attn"]
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        attn[name] = torch.from_numpy(
            rng.normal(0.0, 0.5, tuple(attn[name].shape)).astype(np.float32))
    return params


def initial_params(name: str):
    """The case's whole parameters at step 0, as every rank draws them."""
    params = build_model(case_config(name)).init(seed=0, device="cpu")
    return biased(params) if name == "qwen-bias" else params


def hyper(**kw) -> steps.TrainHyper:
    return steps.TrainHyper(**HYPER, **kw)


def routing(forced=None, rows=(0, 1)):
    """Record every MoE ``route`` call's own choices and probabilities;
    with ``forced`` (another run's log of the same calls, over the whole
    batch) each call takes that log's choices at this rank's share of the
    tokens (``rows``: this data rank and the data ranks), with gates from
    its own probabilities (teacher-forced routing). Returns the log and an
    undo."""
    log, route = [], moe_mod.route
    F = torch.nn.functional

    def recorded(logits, **kw):
        r = route(logits, **kw)
        log.append((r.expert_ids.clone(), r.probs.detach().clone()))
        if forced is None:
            return r
        full = torch.as_tensor(forced[len(log) - 1][0])
        k = full.shape[-1]
        flat = full.reshape(-1, k)
        n = flat.shape[0] // rows[1]
        ids = flat[rows[0] * n:(rows[0] + 1) * n].reshape(
            r.expert_ids.shape)
        gates = torch.gather(r.probs, -1, ids)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        G, tg, _ = ids.shape
        onehot = F.one_hot(ids.reshape(G, tg * k), r.probs.shape[-1])
        slot = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
        return moe_mod.Routing(r.probs, gates, ids, slot,
                               slot < r.capacity, r.capacity)

    moe_mod.route = recorded
    return log, lambda: setattr(moe_mod, "route", route)


def route_off_ties(one, mine, rows=(0, 1)) -> list:
    """The tokens whose own choices on the mesh (``mine``) differ from one
    device's (``one``) past their near-tie: the gap of one device's sorted
    probabilities at the first differing choice above twice the token's
    largest probability difference (the train phase's route-drift
    rule)."""
    out = []
    for i, ((ids1, p1), (ids2, p2)) in enumerate(zip(one, mine)):
        ids1, p1, ids2, p2 = map(torch.as_tensor, (ids1, p1, ids2, p2))
        k = ids1.shape[-1]
        n = ids1.reshape(-1, k).shape[0] // rows[1]
        sl = slice(rows[0] * n, (rows[0] + 1) * n)
        a, pa = ids1.reshape(-1, k)[sl], p1.reshape(n * rows[1], -1)[sl]
        b, pb = ids2.reshape(-1, k), p2.reshape(n, -1)
        for t in (a != b).any(-1).nonzero().flatten().tolist():
            j = int((a[t] != b[t]).nonzero()[0])
            srt = pa[t].sort(descending=True).values
            gap = float(srt[j] - srt[j + 1])
            tie = 2 * float((pb[t] - pa[t]).abs().max())
            if gap > tie:
                out.append({"call": i, "token": t, "gap": gap, "tie": tie})
    return out


def one_device(name: str, *, microbatches: int = 1, steps_: int = STEPS,
               forced=None, compress: bool = False) -> dict:
    """The one-device trainer on the case over ``steps_`` steps: step 0's
    loss and every gradient leaf (the gradients the step applied), the
    losses and the state after the last step, and the MoE routing log of
    step 0 (``compress``: int8 gradient compression with error
    feedback)."""
    cfg = case_config(name)
    model = build_model(cfg)
    hp = hyper(microbatches=microbatches, compress_grads=compress)
    state = steps.init_train_state(model, hyper=hp, device="cpu",
                                   params=initial_params(name))
    d = data(name)
    step = steps.build_train_step(model, hyper=hp, return_grads=True)
    losses = []
    for s in range(steps_):
        log, undo = routing(forced) if s == 0 else ([], lambda: None)
        try:
            state, m, g = step(state, d.batch_for_step(s))
        finally:
            undo()
        if s == 0:
            loss, grads, log0 = float(m["loss"]), g, log
        losses.append(float(m["loss"]))
    return {"loss": loss,
            "grads": {p: _np(g) for p, g in tree_leaves(grads)},
            "losses": losses, "routing": _np_log(log0),
            "state": {p: _np(t) for p, t in tree_leaves(state)}}


def _np_log(log) -> list:
    return [(_np(ids), _np(p)) for ids, p in log]


def _np(t: torch.Tensor) -> np.ndarray:
    """A leaf for the launching process (a rank's tensors would be shared
    through handles that die with the rank)."""
    return t.detach().cpu().numpy().copy()


def _whole(tree, specs, mesh) -> dict:
    """Every leaf of this rank's ``tree`` assembled whole (numpy)."""
    spec = dict(tree_leaves(specs))
    return {p: _np(collectives.gather_whole(t.detach(), spec[p], mesh))
            for p, t in tree_leaves(tree)}


def mesh_case(rank: int, mesh, name: str, *, fsdp: bool = True,
              forced=None, compress: bool = False) -> dict:
    """One case on ``mesh``: as :func:`one_device` (the MoE teacher-forced
    by ``forced``, one device's log), with this rank's split, the
    collective calls of a step by kind, and the leaves' local shapes."""
    cfg = case_config(name)
    model = build_model(cfg)
    hp = hyper(compress_grads=compress)
    step = steps.build_train_step(model, hyper=hp, mesh=mesh, fsdp=fsdp,
                                  return_grads=True)
    pl = step.placement
    state = steps.init_train_state(model, hyper=hp, device="cpu",
                                   params=initial_params(name), placement=pl)
    d = data(name)
    rows = (pl.coords["data"], pl.sizes["data"])
    losses = []
    collectives.reset_counts()
    for s in range(STEPS):
        log, undo = routing(forced, rows) if s == 0 else ([], lambda: None)
        try:
            state, m, g = step(state,
                               steps.local_batch(d.batch_for_step(s), pl))
        finally:
            undo()
        losses.append(float(m["loss"]))
        if s == 0:
            per_step, log0 = collectives.counts(), log
            grads = _whole(g, pl.param_specs, mesh)
    local = {p: tuple(t.shape) for p, t in tree_leaves(state["params"])}
    whole = _whole(state, steps.state_specs(state, pl), mesh)
    out = {"loss": losses[0], "losses": losses,
           "collectives": per_step, "local_shapes": local,
           "split": _split(pl.shard),
           "routing": _np_log(log0), "rows": rows}
    if rank == 0:
        out.update(grads=grads, state=whole)
    return out


def compress_inputs():
    """Two gradient leaves for the compression check: ``a`` (4, 6) and
    ``b`` (5,), from a seed; ``a``'s largest magnitude in its last rows."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (4, 6)).astype(np.float32)
    a[3, 2] = 9.0
    return {"a": a, "b": rng.normal(0, 1, (5,)).astype(np.float32)}


def compress_piece(rank: int, mesh, shape) -> dict:
    """int8 compression on this rank's rows of ``a`` (split over the mesh
    axis of two ranks) beside the whole ``b``, inside the mesh's context:
    the dequantized values and the error feedback."""
    from repro_torch.optim import compressed_gradients

    pl = steps.train_placement(build_model(case_config("llama3-even")),
                               mesh)
    full = compress_inputs()
    i = pl.coords["data"] if shape[0] == 2 else pl.coords["model"]
    grads = {"a": torch.from_numpy(full["a"][2 * i:2 * i + 2]),
             "b": torch.from_numpy(full["b"])}
    err = {k: torch.zeros_like(v) for k, v in grads.items()}
    with activate(mesh, pl.rules, pl.shard):
        deq, new_err = compressed_gradients(grads, err)
    return {"deq": {k: _np(v) for k, v in deq.items()},
            "err": {k: _np(v) for k, v in new_err.items()}, "rows": i}


def reduce_scatter_pieces(rank: int, mesh) -> dict:
    """:func:`~repro_torch.parallel.collectives.reduce_scatter` over the
    mesh's axis of two ranks against the sum all-reduce's slice, for f32
    and bf16 gradients split along dims 0 and 1 (each rank's values from
    its own seed): whether each pair is equal bit for bit."""
    from repro_torch.parallel.collectives import all_reduce, reduce_scatter

    axis = "data" if mesh.shape[0] == 2 else "model"
    group, i = mesh.get_group(axis), mesh.get_local_rank(axis)
    g = torch.Generator().manual_seed(11 + i)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(6, 10, generator=g).to(dtype)
        for dim in (0, 1):
            n = x.shape[dim] // 2
            want = all_reduce(x.float().clone(), group).to(dtype).narrow(
                dim, i * n, n)
            got = reduce_scatter(x, dim, group, 2, i)
            out[(str(dtype), dim)] = bool(torch.equal(got, want))
    return out


def _split(shard) -> dict:
    """A rank's split as plain values (its groups dropped)."""
    out = dataclasses.asdict(dataclasses.replace(shard, group=None,
                                                 data=None))
    data = shard.data
    out["data_size"] = 1 if data is None else data.size
    out["fsdp"] = None if data is None else dict(data.fsdp)
    return out


def train_cases(rank: int, plan: dict) -> dict:
    """In one spawn, for each mesh ``shape: (jobs, refusals)`` of
    ``plan``: every job ``label: (case name, kwargs of mesh_case)`` on a
    mesh of that shape, and for each of ``refusals`` ``label: (case name,
    global batch rows)`` the error a ``TrainLoop`` there raises (``None``:
    none) → ``{shape: (results, errors)}``."""
    out = {}
    for shape, (jobs, refusals) in plan.items():
        torch.manual_seed(0)
        mesh = make_mesh(shape, device="cpu")
        results = {label: mesh_case(rank, mesh, name, **kw)
                   for label, (name, kw) in jobs.items()}
        results["compress"] = compress_piece(rank, mesh, shape)
        results["reduce_scatter"] = reduce_scatter_pieces(rank, mesh)
        errors = {}
        for label, (name, rows) in refusals.items():
            try:
                TrainLoop(case_config(name), steps=1, global_batch=rows,
                          seq_len=16, device="cpu", mesh_shape=shape)
                errors[label] = None
            except ValueError as e:
                errors[label] = str(e)
        out[shape] = (results, errors)
    return out


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def loop(name: str, shape, ckpt_dir=None, *, steps_: int = 6, fails=(),
         lose=None, save_every: int = 2) -> TrainLoop:
    cfg = case_config(name)
    _, _, batch, seq = CASES[name]
    return TrainLoop(cfg, steps=steps_, global_batch=batch, seq_len=seq,
                     ckpt_dir=ckpt_dir, save_every=save_every,
                     hyper=steps.TrainHyper(**dict(HYPER,
                                                   total_steps=steps_)),
                     injector=FailureInjector(fails, lose=lose),
                     device="cpu", async_save=False, mesh_shape=shape,
                     log_every=1)


def _loop_state(lp: TrainLoop, state) -> dict:
    """``state`` of ``lp`` whole (on one device: as it is)."""
    if lp.mesh is None:
        return {p: _np(t) for p, t in tree_leaves(state)}
    return _whole(state, lp.state_specs(), lp.mesh)


def _saved(directory: str, step: int) -> dict:
    """The leaves a checkpoint's files hold, by key."""
    npz = np.load(os.path.join(directory, f"step_{step}", "shard_0.npz"))
    return {k.replace("\x1f", "/"): npz[k] for k in npz.files}


def checkpoints(rank: int, root: str, name: str) -> dict:
    """On two ranks: a run on (1, 2) writing checkpoints; its newest one
    restored onto (1, 2), (2, 1) and (1, 1) (rank 0 alone), each rank's
    slices against the saved leaves; a run on (2, 1) with a failure
    against the same run without, and a run on (1, 2) that loses rank 1
    at a failure and resumes on the (1, 1) mesh the re-plan gives."""
    out = {}
    tp_dir = os.path.join(root, "tp")
    lp = loop(name, (1, 2), tp_dir)
    state, _ = lp.run()
    out["tp_final"] = _loop_state(lp, state)
    out["tp_losses"] = [m["loss"] for m in lp.metrics_history]
    newest = lp.manager.latest_step()
    out["newest"] = newest
    saved = _saved(tp_dir, newest)
    template = lp._template()
    slices = {}
    for shape, ranks in (((1, 2), None), ((2, 1), None), ((1, 1), [0])):
        mesh = make_mesh(shape, device="cpu", ranks=ranks)
        if mesh.get_coordinate() is None:
            continue
        pl = steps.train_placement(lp.model, mesh)
        specs = steps.state_specs(template, pl)
        got, _ = lp.manager.restore(template, step=newest, device="cpu",
                                    mesh=mesh, specs=specs)
        want = dict(tree_leaves(specs))
        coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        differ = []
        for path, t in tree_leaves(got):
            key = path.replace(".", "/")
            piece = saved[key][local_slices(saved[key].shape, want[path],
                                            mesh, coords)]
            if t.dtype == torch.bfloat16:
                same = np.array_equal(t.view(torch.int16).numpy(),
                                      piece.view(np.int16))
            else:
                same = np.array_equal(t.numpy(), piece)
            if not same:
                differ.append(path)
        slices[shape] = {"differ": differ, "n": len(want),
                         "shapes": {p: tuple(t.shape)
                                    for p, t in tree_leaves(got)}}
    out["slices"] = slices

    # a restart on (2, 1): bit for bit against the same run without
    plain = loop(name, (2, 1), os.path.join(root, "dp"))
    state, _ = plain.run()
    want = _loop_state(plain, state)
    again = loop(name, (2, 1), os.path.join(root, "dp_fail"), fails=(3,))
    state, result = again.run()
    got = _loop_state(again, state)
    out["restart"] = {"restarts": result.restarts,
                      "equal": sorted(p for p in want
                                      if np.array_equal(want[p], got[p])),
                      "n": len(want)}

    # the elastic re-plan: rank 1 lost at step 3, resumed on (1, 1)
    el = loop(name, (1, 2), os.path.join(root, "elastic"), fails=(3,),
              lose={3: [1]})
    state, result = el.run()
    out["elastic"] = {"restarts": result.restarts,
                      "mesh": el.mesh_shape, "departed": el.departed,
                      "losses": [m["loss"] for m in el.metrics_history]}
    if not el.departed:
        out["elastic"]["final"] = _loop_state(el, state)
    return out
