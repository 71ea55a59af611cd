"""Training the SSM (mamba2-370m) and hybrid (zamba2-1.2b) families, the
trainer on every family, and the ``moa_scope`` loss line, on the CPU.

The reference's train step is ``jax.jit(repro.launch.steps.
build_train_step(...))`` called outside any mesh (the reference's
``TrainLoop`` always builds one); its state comes from its own
``init_train_state`` (``PRNGKey(0)``) and crosses into the port with
:mod:`repro_torch.interop`. The smoke configs run at
``compute_dtype="float32"``: mamba2, zamba2 (one application of the shared
block a layer) and zamba2 with a tail (``n_layers=5, attn_every=2``: two
applications, then a Mamba-2 layer). Batches are numpy draws from a seed.

Tolerances, and why (``test_torch_train.py``'s): the loss and metrics
within 1e-5 and every gradient leaf within 1e-5 of its largest entry (f32
through the layers, forward and backward; the SSD's chunked scan adds the
exps of f32 decay sums, computed in the same order in both); a step's new
parameters within the step's learning rate (an AdamW update near a zero
gradient may take either sign), their mean within 1e-4 of it, the moments
within the gradient tolerance. The port against itself (``remat``) is
exact. The ``moa_scope`` line runs the runner's own smoke llama3-8b at its
bf16 compute: each projection rounds to bf16 (relative 2**-8) in both
frameworks in other orders, so the losses (about 5.6) agree within 1e-2.
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
from repro.models.api import build_model as jbuild
from repro.moa import moa_scope as jscope
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import TrainLoop
from repro_torch.models.api import build_model as tbuild
from repro_torch.paper import moa_strategies

GRAD_RTOL = 1e-5
LOSS_ATOL = 1e-5
SCOPE_ATOL = 1e-2
HYPER = dict(peak_lr=5e-3, warmup_steps=2, total_steps=10)
ARCHS = {"mamba2": ("mamba2-370m", {}),
         "zamba2": ("zamba2-1.2b", {}),
         "zamba2-tail": ("zamba2-1.2b", {"n_layers": 5, "attn_every": 2})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (tiny tensors; a pool a
    process only contends with the other test workers')."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(key, **extra):
    arch, upd = ARCHS[key]
    upd = dict(upd, compute_dtype="float32", **extra)
    return (dataclasses.replace(jsmoke(jget(arch)), **upd),
            dataclasses.replace(tsmoke(tget(arch)), **upd))


def _batch(seed=0, shape=(4, 33)):
    toks = np.random.default_rng(seed).integers(0, 257, shape,
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _t(tree):
    return interop.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(tree):
    return dict(interop.tree_leaves(tree))


@pytest.fixture(scope="module", params=list(ARCHS))
def runs(request):
    """One train step in each package from the reference's init; the
    port's loss and gradients at the init. The reference's gradients are
    read from its first step's first moment (``m = (1 - b1) · scale ·
    g``, ``scale`` the clip its ``grad_norm`` fixes), as
    ``test_torch_train.py`` reads them: one compile an arch."""
    jcfg, tcfg = _configs(request.param)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    hyper_j = jsteps.TrainHyper(**HYPER)
    hyper_t = tsteps.TrainHyper(**HYPER)
    jstate = jax.jit(lambda key: jsteps.init_train_state(
        jm, key, hyper=hyper_j))(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, jstate["params"])
    batch = _batch()
    tstate = tsteps.init_train_state(
        tm, hyper=hyper_t, params=interop.from_numpy(params_np, device="cpu"))
    tg, tmet = tsteps.loss_and_grads(tm, tstate["params"], _t(batch))
    jstate, jmm = jax.jit(jsteps.build_train_step(jm, hyper=hyper_j))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tstate, tmm = tsteps.build_train_step(tm, hyper=hyper_t)(tstate,
                                                             _t(batch))
    gnorm = np.float32(jmm["grad_norm"])
    scale = np.minimum(np.float32(1.0), np.float32(
        hyper_j.adamw.clip_norm) / np.maximum(gnorm, np.float32(1e-9)))
    jg = jax.tree.map(lambda m: np.asarray(m).astype(np.float64) / (
        (1 - hyper_j.adamw.b1) * np.float64(scale)), jstate["opt"]["m"])
    return types.SimpleNamespace(
        key=request.param, grads=(jg, tg), loss=(jmm, tmet),
        step=(jax.tree.map(np.asarray, jstate), tstate, float(tmm["lr"]),
              {k: (float(jmm[k]), float(tmm[k])) for k in tmm}))


def test_model_loss_and_metrics(runs):
    jmm, tmet = runs.loss
    for k, v in tmet.items():
        np.testing.assert_allclose(float(v), float(jmm[k]), rtol=0,
                                   atol=LOSS_ATOL, err_msg=k)


def test_every_gradient_leaf_finite_and_close(runs):
    want, got = runs.grads
    w, g = _leaves(want), _leaves(got)
    assert set(g) == set(w)
    for path, t in g.items():
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all()), \
            path
        assert np.isfinite(w[path]).all(), path
        np.testing.assert_allclose(t.numpy(), w[path], rtol=0,
                                   atol=GRAD_RTOL * np.abs(w[path]).max(),
                                   err_msg=path)
    # the Mamba-2 layers' every parameter is trained
    assert all(g[p].any() for p in g if p.startswith("layers.mixer."))


def test_one_train_step_new_state(runs):
    want, got, lr, metrics = runs.step
    for k, (j, t) in metrics.items():
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=LOSS_ATOL,
                                   err_msg=k)
    w = _leaves(want)
    assert set(_leaves(got)) == set(w)
    for path, t in interop.tree_leaves(got):
        ref = w[path]
        t = t.detach().numpy()
        if path in ("step", "opt.count"):
            assert (t == ref).all(), path
            continue
        d = np.abs(t.astype(np.float64) - ref)
        if path.startswith("params."):
            assert d.max() <= lr and d.mean() <= 1e-4 * lr, (path, d.max())
        else:
            rtol = GRAD_RTOL * (2 if path.startswith("opt.v.") else 1)
            assert d.max() <= rtol * np.abs(ref).max() + 1e-12, path


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(ARCHS) + ["hubert-xlarge",
                                               "llava-next-34b"])
def test_remat_modes_give_the_same_gradients(key):
    """``remat`` changes what the backward recomputes, not what it
    computes: "full" and "dots" equal "none" bit for bit (the Mamba-2
    layers and the encoder's and VLM's layers alike)."""
    if key in ARCHS:
        batch = _t(_batch(seed=5))
    else:
        data = TrainLoop(tsmoke(tget(key)), steps=1, global_batch=2,
                         seq_len=24, device="cpu").data
        batch = data.batch_for_step(0)
    out = {}
    for remat in ("none", "full", "dots"):
        if key in ARCHS:
            cfg = _configs(key, remat=remat)[1]
        else:
            cfg = dataclasses.replace(tsmoke(tget(key)),
                                      compute_dtype="float32", remat=remat)
        model = tbuild(cfg)
        state = tsteps.init_train_state(model, hyper=tsteps.TrainHyper(),
                                        seed=0, device="cpu")
        out[remat] = [g for _, g in interop.tree_leaves(
            tsteps.loss_and_grads(model, state["params"], batch)[0])]
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b)
                   for a, b in zip(out["none"], out[remat])), remat


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-34b",
                                  "mamba2-370m", "zamba2-1.2b"])
def test_train_loop_takes_every_family(arch):
    """The trainer feeds each family its batch (the encoder's frames, mask
    and targets; the VLM's patches before its text), every loss finite;
    the token families learn the pipeline's bigram process in 30 smoke
    steps (the encoder's targets are random draws: nothing to learn)."""
    loop = TrainLoop(tsmoke(tget(arch)), steps=30, global_batch=4,
                     seq_len=24, device="cpu", log_every=29,
                     hyper=tsteps.TrainHyper(peak_lr=5e-3, warmup_steps=3,
                                             total_steps=30))
    batch = loop.batch(0)
    if arch == "hubert-xlarge":
        assert set(batch) == {"frames", "mask", "targets"}
    elif arch == "llava-next-34b":
        assert batch["patches"].shape == (4, 8, 64)
        assert batch["tokens"].shape == (4, 16)
    loop.run()
    losses = [m["loss"] for m in loop.metrics_history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    if arch != "hubert-xlarge":
        assert losses[-1] < losses[0]


def test_train_cli_on_an_encoder(capsys):
    train_cli.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16",
                    "--layers", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train] step=0 ")
    assert out[-1].startswith("[train] loss ")


# ---------------------------------------------------------------------------
# the moa_scope loss line (benchmarks/moa_strategies.py)
# ---------------------------------------------------------------------------


def test_moa_scope_losses_match_reference():
    """The smoke llama3-8b's loss under ``moa_scope("tree")`` and
    ``moa_scope("serial?chunk=16")``, the reference's parameters and one
    batch in both packages."""
    jm = jbuild(jsmoke(jget("llama3-8b")))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tsmoke(tget("llama3-8b")))
    tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    batch = _batch(seed=2, shape=(4, 65))
    want = []
    for spec in moa_strategies.SCOPES:
        with jscope(spec):           # the scope applies at trace time
            want.append(float(jax.jit(jm.loss)(
                jp, jax.tree.map(jnp.asarray, batch))[0]))
    got = moa_strategies.scope_losses(tm, tp, _t(batch))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCOPE_ATOL)
    assert abs(got[0] - got[1]) < SCOPE_ATOL
