"""The port's data pipeline, supervisor, ``TrainLoop`` and train CLI on the
CPU: the pipeline's bigram map and host sharding bit for bit against the
reference's, its batches' keys, shapes and dtypes equal to the reference's
and determined by ``(seed, step)`` (a ``torch.Generator`` cannot match
``jax.random`` draw for draw); learning; the restart budget; a restarted
run bit-equal to a failure-free one; train-state checkpoints crossing
between the two packages both ways, bit for bit; the CLI; the refusals.
Everything here is exact: no tolerance, except the learn check's drop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.data import SyntheticLMData as JData
from repro.data import host_shard as jshard
from repro.launch import steps as jsteps
from repro.models.api import build_model as jbuild
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.data import SyntheticLMData, host_shard
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import TrainLoop
from repro_torch.models.api import build_model
from repro_torch.runtime import FailureInjector, SimulatedFailure, Supervisor

LEARN_DROP = 0.2     # the quickstart's "LEARNED" bar


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are tiny, and
    a pool of threads a process only contends with the other test
    workers' (restored after the file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(tmp=None, *, arch="llama3-8b", steps_=20, fails=(), seq=32,
          save_every=5, **kw):
    hyper = steps.TrainHyper(peak_lr=kw.pop("lr", 5e-3),
                             warmup_steps=kw.pop("warmup", 2),
                             total_steps=steps_)
    return TrainLoop(smoke_config(get_config(arch)), steps=steps_,
                     global_batch=8, seq_len=seq,
                     ckpt_dir=str(tmp) if tmp else None,
                     save_every=save_every, hyper=hyper,
                     injector=FailureInjector(fails), device="cpu",
                     async_save=False, **kw)


def _bits(tree):
    return {k: t.detach().contiguous().view(torch.uint8).numpy().tobytes()
            if t.dim() else t.detach().reshape(1).view(torch.uint8).numpy(
            ).tobytes() for k, t in interop.tree_paths(tree).items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab", [(0, 257), (1, 128256),
                                        (999, 163840), (12345, 202048)])
def test_bigram_next_bit_exact(seed, vocab):
    prev = np.random.default_rng(seed).integers(0, vocab, 4096,
                                                dtype=np.int32)
    prev[:2] = (0, vocab - 1)
    want = JData(vocab, 8, 2, seed=seed)._bigram_next(jnp.asarray(prev))
    got = SyntheticLMData(vocab, 8, 2, seed=seed)._bigram_next(
        torch.from_numpy(prev))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 2), (3, 4)])
def test_host_shard_bit_exact(host, n_hosts):
    rng = np.random.default_rng(host)
    batch = {"tokens": rng.integers(0, 99, (8, 5), dtype=np.int32),
             "patches": rng.standard_normal((8, 2, 3)).astype(np.float32)}
    want = jshard(jax.tree.map(jnp.asarray, batch), host, n_hosts)
    got = host_shard({k: torch.from_numpy(v) for k, v in batch.items()},
                     host, n_hosts)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="split"):
        host_shard({"tokens": torch.zeros(6, 2)}, 0, 4)


@pytest.mark.parametrize("family,n_patches", [("lm", 0), ("lm", 4),
                                              ("encoder", 0)])
def test_batches_have_the_reference_layout(family, n_patches):
    kw = dict(vocab=257, seq_len=24, global_batch=4, seed=3, family=family,
              d_model=16, n_patches=n_patches)
    want = JData(**kw).batch_for_step(5)
    got = SyntheticLMData(**kw).batch_for_step(5)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[1] == str(want[k].dtype), k
    if family == "lm":
        assert got["tokens"].min() >= 0 and got["tokens"].max() < 257
        assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_batches_are_a_function_of_seed_and_step():
    data = SyntheticLMData(vocab=257, seq_len=64, global_batch=8, seed=7)
    a, b = data.batch_for_step(3), data.batch_for_step(3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    it = data.iterate(3)
    assert torch.equal(next(it)["tokens"], a["tokens"])
    assert torch.equal(next(it)["tokens"], data.batch_for_step(4)["tokens"])
    assert not torch.equal(data.batch_for_step(4)["tokens"], a["tokens"])
    other = dataclasses.replace(data, seed=8).batch_for_step(3)
    assert not torch.equal(other["tokens"], a["tokens"])
    # the bigram process: with noise 0.1, ~90 % of labels follow the map
    follows = (data._bigram_next(a["tokens"]) == a["labels"]).float().mean()
    assert 0.8 < float(follows) <= 1.0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_quickstart_learns():
    """The quickstart's hyper: 60 steps, lr 5e-3, warmup 5, 8 × 64."""
    loop = _loop(steps_=60, seq=64, warmup=5, log_every=10)
    loop.run_segment(0, None)
    losses = [m["loss"] for m in loop.metrics_history]
    assert losses[0] - losses[-1] > LEARN_DROP, losses


def test_restart_is_bit_exact(tmp_path):
    """Two injected failures (steps 7 and 13, checkpoints every 5 steps):
    every step's loss and the final state equal the failure-free run's bit
    for bit."""
    base = _loop(tmp_path / "a", log_every=1)
    want, _ = base.run()
    faulty = _loop(tmp_path / "b", fails=(7, 13), log_every=1)
    got, result = faulty.run(max_restarts=2)
    assert result.completed and result.restarts == 2
    assert result.failures == ["node_loss at step 7", "node_loss at step 13"]
    clean = {m["step"]: m["loss"] for m in base.metrics_history}
    resumed = {m["step"]: m["loss"] for m in faulty.metrics_history}
    assert resumed == clean and len(clean) == 20
    assert _bits(got) == _bits(want)
    assert got["step"].shape == () and int(got["step"]) == 20


def test_restart_budget_exhausted(tmp_path):
    class AlwaysFail(FailureInjector):
        def maybe_fail(self, step):
            if step == 1:
                self.fired.append(step)
                raise SimulatedFailure("persistent fault")

    loop = _loop(tmp_path, save_every=50, steps_=6)
    loop.injector = AlwaysFail()
    state, result = loop.run(max_restarts=2)
    assert state is None and not result.completed and result.restarts == 3
    assert result.failures == ["persistent fault"] * 3


def test_supervisor_resumes_after_the_latest_checkpoint(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    seen = []

    def train(start, restored):
        seen.append((start, None if restored is None
                     else int(restored["x"])))
        if len(seen) == 1:
            manager.save(4, {"x": torch.tensor(4)})
            raise SimulatedFailure("node_loss at step 6")
        return "done"

    result = Supervisor(manager, max_restarts=1).run(
        train, restore_fn=lambda s: manager.restore(
            {"x": torch.tensor(0)}, step=s)[0])
    assert result.completed and result.final_state == "done"
    assert seen == [(0, None), (5, 4)]


def _jax_state(cfg_name="llama3-8b"):
    jm = jbuild(jsmoke(jget(cfg_name)))
    hyper = jsteps.TrainHyper(peak_lr=5e-3, warmup_steps=2, total_steps=20)
    return jm, hyper, jax.jit(lambda key: jsteps.init_train_state(
        jm, key, hyper=hyper))(jax.random.PRNGKey(0))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    loop = _loop(tmp_path, steps_=6, save_every=3)
    state, _ = loop.run()
    jm, hyper, jstate = _jax_state()
    template = jax.eval_shape(lambda: jstate)
    restored, _ = JManager(str(tmp_path)).restore(template, step=5)
    want = _bits(state)
    got = {k: np.ascontiguousarray(np.asarray(v)).view(np.uint8).tobytes()
           for k, v in interop.tree_paths(_np_tree(restored)).items()}
    assert got == want
    assert int(restored["step"]) == 6 and restored["step"].shape == ()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference's fresh train state, saved by its manager, restores
    into ``TrainLoop.restore_state`` bit for bit (0-d counters stay 0-d,
    the parameters require grad) and trains on."""
    jm, hyper, jstate = _jax_state()
    JManager(str(tmp_path)).save(0, jstate)
    loop = _loop(tmp_path, steps_=3)
    state = loop.restore_state(0)
    want = {k: np.ascontiguousarray(v).view(np.uint8).tobytes()
            for k, v in interop.tree_paths(_np_tree(jstate)).items()}
    assert _bits(state) == want
    assert all(t.requires_grad for _, t in interop.tree_leaves(
        state["params"]))
    state = loop.run_segment(1, state)
    assert int(state["step"]) == 2


def test_train_cli_on_cpu(tmp_path, capsys):
    train_cli.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                    "--steps", "8", "--batch", "4", "--seq", "16",
                    "--ckpt-dir", str(tmp_path), "--save-every", "3",
                    "--fail-at", "4", "--layers", "1"])
    out = capsys.readouterr().out.splitlines()
    assert "[train] done: restarts=1 completed=True" in out[-2]
    assert out[-1].startswith("[train] loss ")
    assert any(line.startswith("[train] step=0 ") for line in out)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_and_hybrid_training_refused(arch):
    """The SSM and hybrid families train, as the reference's do (their
    gradients are held against it in ``test_torch_train_families.py``);
    what the reference refuses stays refused: a padded prefill, whose pad
    tokens a recurrent state would absorb, and a family no module
    serves."""
    loop = _loop(arch=arch, steps_=1)
    assert loop.model.cfg.family == jbuild(jsmoke(jget(arch))).cfg.family
    model = build_model(smoke_config(get_config(arch)))
    steps.build_train_step(model, hyper=steps.TrainHyper())
    params = model.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="cannot prefill padded"):
        model.prefill(params, {"tokens": torch.zeros((1, 8),
                                                     dtype=torch.int32)},
                      max_len=16, prompt_len=5)
    bogus = dataclasses.replace(smoke_config(get_config(arch)),
                                family="bogus")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(bogus)


def test_mesh_refused():
    """A mesh trains inside the ranks :func:`repro_torch.launch.mesh.
    run_ranks` starts (``tests/test_torch_mesh_train.py``); outside one it
    is refused by name, and a one-device mesh there is one device."""
    with pytest.raises(RuntimeError, match="run_ranks starts one"):
        _loop(mesh_shape=(2, 4))
    assert _loop(mesh_shape=(1, 1)).mesh is None
