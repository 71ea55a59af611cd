"""The port's training math against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through ``repro.optim``,
``repro.models.losses``, ``Model.loss`` and the reference's train step
(``jax.jit(repro.launch.steps.build_train_step(...))``, called outside any
mesh, where ``constrain`` is a no-op) and through their ports; the
reference's parameters cross into the port with :mod:`repro_torch.interop`.
The models are the smoke configs at ``compute_dtype="float32"``.

Tolerances, and why:

* int8 compression: bit for bit (``torch.round`` and ``jnp.round`` both
  round half to even, and every other step is one correctly rounded f32
  operation);
* schedules, AdamW, cross-entropy: one f32 expression each, evaluated in
  the same order; XLA may fuse a multiply and an add (one rounding where
  PyTorch rounds twice) and its ``cos`` / ``pow`` may differ in the last
  place, so ``rtol=1e-6`` (about 8 f32 ulps);
* ``Model.loss`` and its gradients (the reference's read from its first
  train step: module fixture ``runs``): f32 sums in the two frameworks'
  matmul orders through 2 layers, forward and backward; measured at about
  1e-6 of each leaf's largest entry, held at ``GRAD_RTOL`` = 1e-5 of it,
  and the loss within 1e-5;
* a train step's new state and a 5-step trajectory: after an AdamW step a
  gradient entry near 0 (of the order of ``eps``) can turn the two
  frameworks' rounding apart into an update of either sign, so a
  parameter may move by up to ``lr`` further in one than in the other:
  every entry is held within the summed learning rates, the mean within
  1e-4 of that sum, and the losses of each step within 1e-4.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.launch import steps as jsteps
from repro.layers import embedding as jembedding
from repro.models import losses as jlosses
from repro.models.api import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.layers import attention as tattention
from repro_torch.layers import embedding as tembedding
from repro_torch.layers import moe as tmoe
from repro_torch.models import losses as tlosses
from repro_torch.models.api import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.optim import schedules as tsched

F32_RTOL = 1e-6     # one f32 expression, fused or not: ~8 ulps
GRAD_RTOL = 1e-5    # of a leaf's largest entry; measured ~1e-6
LOSS_ATOL = 1e-5    # loss ~6, f32 through 2 layers
TRAJ_LOSS_ATOL = 1e-4
HYPER = dict(peak_lr=5e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are tiny, and
    a pool of threads a process only contends with the other test
    workers' (restored after the file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return dict(interop.tree_leaves(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# schedules, AdamW, compression, cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(3, 10), (10, 100), (0, 7)])
def test_schedules_match_reference(warmup, total):
    steps = np.arange(total + 1, dtype=np.int32)
    for fn_j, fn_t, kw in (
            (jsched.linear_warmup, tsched.linear_warmup, {}),
            (jsched.cosine_schedule, tsched.cosine_schedule,
             {"total_steps": total})):
        want = np.asarray(fn_j(jnp.asarray(steps), peak_lr=3e-4,
                               warmup_steps=warmup, **kw))
        got = fn_t(torch.from_numpy(steps), peak_lr=3e-4,
                   warmup_steps=warmup, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL)
        # a Python int step gives a 0-d f32 tensor of the same value
        one = fn_t(int(steps[-1]), peak_lr=3e-4, warmup_steps=warmup, **kw)
        assert one.shape == () and float(one) == pytest.approx(
            float(want[-1]), rel=F32_RTOL)


def _adam_inputs(seed):
    rng = np.random.default_rng(seed)

    def tree(scale):
        return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
                "layers": {"k": (rng.standard_normal((2, 4, 3)) * scale
                                 ).astype(np.float32),
                           "scale": (1 + rng.standard_normal((2, 4)) * scale
                                     ).astype(np.float32)}}

    params, grads = tree(0.5), tree(1.0)
    m, v = tree(0.1), jax.tree.map(np.abs, tree(0.1))
    return params, grads, m, v


@pytest.mark.parametrize("clip", [None, 1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    """One AdamW step at count 3 on nonzero moments, clipping off, binding
    (``1.0`` under a global norm of ~6) and slack; the port writes the new
    parameters and moments into the tensors it was given."""
    params, grads, m, v = _adam_inputs(0)
    cfg_j = jadamw.AdamWConfig(clip_norm=clip)
    cfg_t = tadamw.AdamWConfig(clip_norm=clip)
    jp, jopt, jmet = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "count": jnp.asarray(3, jnp.int32)},
        jax.tree.map(jnp.asarray, params), lr=jnp.float32(2e-3), config=cfg_j)
    tp = interop.tree_map(_t, params)
    topt = {"m": interop.tree_map(_t, m), "v": interop.tree_map(_t, v),
            "count": torch.tensor(3, dtype=torch.int32)}
    wq = tp["w"]
    gp, gopt, gmet = tadamw.adamw_update(
        interop.tree_map(_t, grads), topt, tp, lr=torch.tensor(2e-3),
        config=cfg_t)
    assert gp["w"] is wq                          # in place
    assert int(gopt["count"]) == 4 and gopt["count"].shape == ()
    np.testing.assert_allclose(float(gmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=F32_RTOL)
    for name, want, got in (("params", jp, gp), ("m", jopt["m"], gopt["m"]),
                            ("v", jopt["v"], gopt["v"])):
        w = _leaves(_np(want))
        for path, t in interop.tree_leaves(got):
            np.testing.assert_allclose(t.numpy(), w[path], rtol=F32_RTOL,
                                       atol=1e-8, err_msg=f"{name} {path}")


def test_adamw_init_and_global_norm():
    params, grads, _, _ = _adam_inputs(1)
    opt = tadamw.adamw_init(interop.tree_map(_t, params))
    assert opt["count"].dtype == torch.int32 and opt["count"].shape == ()
    assert all(float(t.abs().max()) == 0 and t.dtype == torch.float32
               for _, t in interop.tree_leaves(opt["m"]))
    np.testing.assert_allclose(
        float(tadamw.global_norm(interop.tree_map(_t, grads))),
        float(jadamw.global_norm(jax.tree.map(jnp.asarray, grads))),
        rtol=F32_RTOL)


def _int8_inputs():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((7, 9)) * 3).astype(np.float32)
    # amax 127 makes the scale exactly 1: every k + 0.5 is a tie
    ties = np.array([127.0, -0.5, 0.5, 1.5, 2.5, -2.5, -3.5, 126.5, -126.5,
                     4.5], np.float32)
    return [x, ties, np.zeros((3, 3), np.float32),
            (rng.standard_normal(64) * 1e-30).astype(np.float32)]


@pytest.mark.parametrize("case", range(4))
def test_compress_int8_bit_exact(case):
    x = _int8_inputs()[case]
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    tq, ts = tcomp.compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        tcomp.decompress_int8(tq, ts).numpy(),
        np.asarray(jcomp.decompress_int8(jq, js)))
    if case == 1:   # round half to even
        assert tq.tolist() == [127, -0, 0, 2, 2, -2, -4, 126, -126, 4]


def test_compressed_gradients_bit_exact_with_feedback():
    """Three rounds of error feedback: every dequantized gradient and
    residue equal the reference's bit for bit."""
    rng = np.random.default_rng(3)
    jerr = jcomp.init_error_feedback({"a": jnp.zeros((5, 4)),
                                      "b": {"c": jnp.zeros(6)}})
    terr = tcomp.init_error_feedback({"a": torch.zeros(5, 4),
                                      "b": {"c": torch.zeros(6)}})
    for _ in range(3):
        g = {"a": rng.standard_normal((5, 4)).astype(np.float32),
             "b": {"c": (rng.standard_normal(6) * 1e-3).astype(np.float32)}}
        jdeq, jerr = jcomp.compressed_gradients(
            jax.tree.map(jnp.asarray, g), jerr)
        tdeq, terr = tcomp.compressed_gradients(interop.tree_map(_t, g),
                                                terr)
        for want, got in ((jdeq, tdeq), (jerr, terr)):
            w = _leaves(_np(want))
            for path, t in interop.tree_leaves(got):
                assert t.numpy().tobytes() == w[path].tobytes(), path


@pytest.mark.parametrize("impl", ["vocab_parallel", "gather"])
def test_softmax_cross_entropy_with_mask(impl):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, :2] = logits[0, :2].argmax(-1)        # some hits
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)

    def jloss(x):
        return jlosses.softmax_cross_entropy(x, jnp.asarray(labels),
                                             mask=jnp.asarray(mask),
                                             impl=impl)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl, tm = tlosses.softmax_cross_entropy(x, torch.from_numpy(labels),
                                           mask=torch.from_numpy(mask),
                                           impl=impl)
    (tg,) = torch.autograd.grad(tl, x)
    assert set(tm) == {"loss", "tokens", "accuracy"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=F32_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=F32_RTOL,
                               atol=1e-8)
    with pytest.raises(ValueError, match="loss impl"):
        tlosses.softmax_cross_entropy(x, torch.from_numpy(labels),
                                      impl="ring")


def test_unembed_backward_is_the_reference_rule():
    """The bf16 unembedding's backward (CUDA's ``aten::mm.dtype`` has no
    derivative): f32 products of the cotangent with the same bf16
    operands, each rounded to bf16 once — JAX's transpose of the einsum
    with ``preferred_element_type=f32``. The two sum in other orders, so
    each entry is within one bf16 ulp (2**-8 relative) of the
    reference's."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    table = (rng.standard_normal((40, 16)) * 0.25).astype(np.float32)
    g = rng.standard_normal((6, 40)).astype(np.float32)
    xb, tb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(table, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, t: jembedding.unembed(
        {"table": t}, a[None], compute_dtype=jnp.bfloat16)[0], xb, tb)
    jdx, jdt = vjp(jnp.asarray(g))
    ctx = types.SimpleNamespace(saved_tensors=(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(table).bfloat16()))
    tdx, tdt = tembedding._Unembed.backward(ctx, torch.from_numpy(g))
    assert tdx.dtype == tdt.dtype == torch.bfloat16
    for got, want in ((tdx, jdx), (tdt, jdt)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Model.loss, its gradients, train steps
# ---------------------------------------------------------------------------


def _configs(arch):
    upd = {"compute_dtype": "float32"}
    if arch == "moonshot-v1-16b-a3b":
        upd["capacity_factor"] = 1.0      # 32 slots for 64 choices: drops
    return (dataclasses.replace(jsmoke(jget(arch)), **upd),
            dataclasses.replace(tsmoke(tget(arch)), **upd))


def _batches(n, seed=0, shape=(4, 33)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 257, shape, dtype=np.int32)
        out.append({"tokens": toks[:, :-1].copy(),
                    "labels": toks[:, 1:].copy()})
    return out


@pytest.fixture(scope="module", params=["llama3-8b", "moonshot-v1-16b-a3b"])
def runs(request):
    """Both packages on one config: 5 train steps from the reference's
    init (the port's state after the first kept aside), and the port's
    loss and gradients of batch 0 at the init. The reference's are read
    from its first step, which runs ``Model.loss`` at the init: its
    metrics, and its first moment from zero moments, ``m = (1 - b1) ·
    scale · g`` with the clip ``scale`` its ``grad_norm`` fixes (one
    compile per arch, not two; the division adds ~2 f32 roundings)."""
    jcfg, tcfg = _configs(request.param)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    hyper_j = jsteps.TrainHyper(**HYPER)
    hyper_t = tsteps.TrainHyper(**HYPER)
    jstate = jax.jit(lambda key: jsteps.init_train_state(
        jm, key, hyper=hyper_j))(jax.random.PRNGKey(0))
    params_np = _np(jstate["params"])
    batches = _batches(5)
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    tb = [interop.tree_map(_t, b) for b in batches]

    dropped = []
    route = tmoe.route

    def counting_route(*a, **kw):
        r = route(*a, **kw)
        dropped.append(int((~r.keep).sum()))
        return r

    tmoe.route = counting_route
    try:
        tstate = tsteps.init_train_state(
            tm, hyper=hyper_t,
            params=interop.from_numpy(params_np, device="cpu"))
        tg, tmet = tsteps.loss_and_grads(tm, tstate["params"], tb[0])
    finally:
        tmoe.route = route

    jstep = jax.jit(jsteps.build_train_step(jm, hyper=hyper_j))
    tstep = tsteps.build_train_step(tm, hyper=hyper_t)
    traj = []
    for i in range(5):
        jstate, jmm = jstep(jstate, jb[i])
        tstate, tmm = tstep(tstate, tb[i])
        traj.append({k: (float(jmm[k]), float(tmm[k])) for k in tmm})
        if i == 0:
            first = (_np(jstate), interop.tree_map(
                lambda t: t.detach().clone(), tstate))
            gnorm = np.float32(jmm["grad_norm"])
            scale = np.minimum(np.float32(1.0), np.float32(
                hyper_j.adamw.clip_norm) / np.maximum(gnorm, np.float32(
                    1e-9)))
            jg = jax.tree.map(
                lambda m: m.astype(np.float64) / (
                    (1 - hyper_j.adamw.b1) * np.float64(scale)),
                first[0]["opt"]["m"])
            jmet = {k: float(v) for k, v in jmm.items()
                    if k not in ("grad_norm", "lr")}
    return types.SimpleNamespace(
        arch=request.param, loss=(jmet, tmet), grads=(jg, tg),
        dropped=dropped, first=first, last=(_np(jstate), tstate), traj=traj)


def test_model_loss_and_metrics_match(runs):
    jmet, tmet = runs.loss
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), jmet[k], rtol=0,
                                   atol=LOSS_ATOL, err_msg=k)
    if runs.arch.startswith("moonshot"):
        assert "aux_loss" in tmet
        assert sum(runs.dropped) > 0, "no capacity drop exercised"


def test_every_gradient_leaf_matches(runs):
    want, got = runs.grads
    w = _leaves(want)
    got = _leaves(got)
    assert set(got) == set(w)
    for path, g in got.items():
        ref = w[path]
        assert g.shape == ref.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=path)


def _assert_state_close(want_np, got, lr_sum, moments=False):
    """Counters equal; parameters within the summed learning rates (mean
    within 1e-4 of it); with ``moments`` (one step from equal parameters)
    ``m`` within the gradient tolerance and ``v`` (squares) within
    twice it."""
    w = _leaves(want_np)
    for path, t in interop.tree_leaves(got):
        ref = w[path]
        t = t.detach().numpy()
        if path in ("step", "opt.count"):
            assert t.shape == ref.shape and (t == ref).all(), path
            continue
        d = np.abs(t.astype(np.float64) - ref)
        if path.startswith("params."):
            assert d.max() <= lr_sum, (path, d.max(), lr_sum)
            assert d.mean() <= 1e-4 * lr_sum, (path, d.mean())
        elif moments:
            rtol = GRAD_RTOL * (2 if path.startswith("opt.v.") else 1)
            assert d.max() <= rtol * np.abs(ref).max() + 1e-12, (
                path, d.max())


def test_one_train_step_new_state(runs):
    want, got = runs.first
    assert set(_leaves(got)) == set(_leaves(want))
    _assert_state_close(want, got, runs.traj[0]["lr"][1], moments=True)
    for k, (j, t) in runs.traj[0].items():
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=LOSS_ATOL,
                                   err_msg=k)


def test_five_step_loss_trajectory(runs):
    for i, step in enumerate(runs.traj):
        j, t = step["loss"]
        assert abs(j - t) <= TRAJ_LOSS_ATOL, (i, j, t)
        assert step["lr"][0] == pytest.approx(step["lr"][1], rel=F32_RTOL)
    want, got = runs.last
    _assert_state_close(want, got, sum(s["lr"][1] for s in runs.traj))


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


def _port(arch="llama3-8b", **upd):
    cfg = dataclasses.replace(tsmoke(tget(arch)), compute_dtype="float32",
                              **upd)
    model = tbuild(cfg)
    state = tsteps.init_train_state(model, hyper=tsteps.TrainHyper(),
                                    seed=0, device="cpu")
    return model, state


def test_microbatches_two_equal_one():
    """Two microbatches of 4 sequences against one of 8: the same token
    mean, the gradients summed in f32 over another grouping (f32
    reassociation, ``GRAD_RTOL``); the metrics are the last
    microbatch's."""
    model, state = _port()
    batch = interop.tree_map(_t, _batches(1, seed=6, shape=(8, 17))[0])
    g1, m1 = tsteps.loss_and_grads(model, state["params"], batch)
    g2, m2 = tsteps.loss_and_grads(model, state["params"], batch,
                                   microbatches=2)
    last = {k: v[4:] for k, v in batch.items()}
    _, m_last = tsteps.loss_and_grads(model, state["params"], last)
    w = _leaves(g1)
    for path, g in interop.tree_leaves(g2):
        ref = w[path]
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, ref, rtol=0,
                                   atol=GRAD_RTOL * float(ref.abs().max()))
    assert float(m2["loss"]) == float(m_last["loss"])
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.loss_and_grads(model, state["params"], batch, microbatches=3)


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
def test_remat_modes_give_the_same_gradients(arch):
    """``remat`` changes what the backward recomputes, not what it
    computes: "full" and "dots" equal "none" bit for bit."""
    batch = interop.tree_map(_t, _batches(1, seed=7)[0])
    out = {}
    for remat in ("none", "full", "dots"):
        model, state = _port(arch, remat=remat)
        out[remat] = [g for _, g in interop.tree_leaves(
            tsteps.loss_and_grads(model, state["params"], batch)[0])]
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b)
                   for a, b in zip(out["none"], out[remat])), remat


class _FakeCuda:
    """Stands in for a CUDA tensor in the kernels' dispatch (no card
    here): a CUDA device and a ``requires_grad`` flag."""

    device = torch.device("cuda")
    is_cuda = True

    def __init__(self, requires_grad):
        self.requires_grad = requires_grad

    def contiguous(self):
        return self


@pytest.mark.parametrize("kernel", ["dot_moa", "flash_attention",
                                    "paged_attention", "moa_reduce"])
def test_kernels_refuse_inputs_that_require_grad(kernel, monkeypatch):
    """On a CUDA input that requires grad, a kernel raises rather than
    return an output without a gradient; under ``torch.no_grad()`` (or on
    inputs that need none) it launches."""
    monkeypatch.setattr(ops, f"{kernel}_cuda", lambda *a, **k: "launched")
    args = {"dot_moa": 2, "flash_attention": 3, "paged_attention": 5,
            "moa_reduce": 1}[kernel]

    def call(grad):
        # the second operand (b, k, the K pool) or the only one wants grad
        xs = [_FakeCuda(grad and i == min(1, args - 1))
              for i in range(args)]
        return getattr(ops, kernel)(*xs)

    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    with torch.no_grad():
        assert call(True) == "launched"
    assert call(False) == "launched"


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
def test_training_forward_never_reaches_the_attention_kernels(arch,
                                                              monkeypatch):
    """With the attention backend forced to ``kernel`` (as on the card), a
    loss under autograd never calls the flash or paged kernels (the plain
    twin, the reference's training route), and its gradients equal the
    plain backend's; nor does the loss without gradients, since the causal
    forward picks its attention by its call site, while serving's prefill
    on the same backend does reach the flash kernel."""
    model, state = _port(arch)
    batch = interop.tree_map(_t, _batches(1, seed=8)[0])
    want = [g for _, g in interop.tree_leaves(
        tsteps.loss_and_grads(model, state["params"], batch)[0])]
    calls = []

    def kernel(name):
        def launch(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} reached")
        return launch

    monkeypatch.setattr(tattention, "resolve_attn_backend",
                        lambda backend, device: "kernel")
    monkeypatch.setattr(ops, "flash_attention", kernel("flash_attention"))
    monkeypatch.setattr(ops, "paged_attention", kernel("paged_attention"))
    got = [g for _, g in interop.tree_leaves(
        tsteps.loss_and_grads(model, state["params"], batch)[0])]
    assert calls == []
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    with torch.no_grad():
        model.loss(state["params"], batch)
    assert calls == []
    tokens = batch["tokens"]
    with torch.no_grad(), pytest.raises(AssertionError, match="reached"):
        model.prefill(state["params"], {"tokens": tokens},
                      max_len=tokens.shape[1])
    assert calls == ["flash_attention"]
