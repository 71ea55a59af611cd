"""Checkpoints of the port's meshed trainer (gloo ranks on the CPU): one
spawn of two ranks (``torch_mesh_train_ranks.checkpoints``) trains
llama3-8b's smoke config (f32; two KV heads and a vocabulary of 256, so
that both split over ``model``) on (1, 2), writing checkpoints, then
restores the newest onto (1, 2), (2, 1) and (1, 1) (rank 0 alone), runs
(2, 1) with and without a failure, and runs (1, 2) with a failure that
takes rank 1 away for good, resuming on the mesh the re-plan gives.

* each rank's restored slices equal the saved leaves' bit for bit;
* the mesh run's files are a one-device run's: the same names, keys,
  dtypes and shapes, the arrays within the TP bar of the one-device run's,
  and the JAX package's ``CheckpointManager`` restores them bit for bit;
* a restart on the same mesh is bit-identical to the run without it;
* the re-planned resume ends within the FSDP / TP bar (1e-4 relative,
  Frobenius, each leaf) of the one-device run without a failure.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_mesh_train_ranks as ranks
from repro.checkpoint import CheckpointManager as JManager
from repro.configs.registry import get_config as jget
from repro.configs.registry import smoke_config as jsmoke
from repro.launch import steps as jsteps
from repro.models.api import build_model as jbuild
from repro_torch import interop
from repro_torch.launch.mesh import run_ranks

NAME = "llama3-even"
LEAF_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are tiny, and
    a pool of threads a process only contends with the other test
    workers' and the ranks' (restored after the file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_ckpt"))
    got = run_ranks(2, ranks.checkpoints, root, NAME,
                    join_timeout_s=ranks.JOIN_S)
    one = ranks.loop(NAME, None, os.path.join(root, "one"))
    state, _ = one.run()
    return {"root": root, "ranks": got, "one": ranks._loop_state(one, state),
            "one_losses": [m["loss"] for m in one.metrics_history]}


def _rel(got, want) -> float:
    d = np.linalg.norm((np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).ravel())
    n = np.linalg.norm(np.asarray(want, np.float64).ravel())
    return 0.0 if d == 0 else float(d / max(n, 1e-30))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (1, 1)])
def test_restore_onto_mesh_bit_for_bit(runs, shape):
    """The newest checkpoint of the (1, 2) run restored onto ``shape``:
    every rank's slices of every leaf equal the saved leaf's."""
    holders = [r for r in runs["ranks"] if shape in r["slices"]]
    assert len(holders) == (1 if shape == (1, 1) else 2)
    for r in holders:
        got = r["slices"][shape]
        assert got["differ"] == [] and got["n"] == 38
    local = holders[-1]["slices"][shape]["shapes"]
    want = {(1, 2): (2, 64, 32), (2, 1): (2, 32, 64), (1, 1): (2, 64, 64)}
    assert local["params.layers.attn.wq"] == want[shape]
    assert local["opt.m.embed.table"] == {
        (1, 2): (128, 64), (2, 1): (256, 32), (1, 1): (256, 64)}[shape]


def _files(directory: str) -> dict:
    return {name: sorted(os.listdir(os.path.join(directory, name)))
            for name in sorted(os.listdir(directory))}


def test_files_are_one_device_files(runs):
    """The (1, 2) run's checkpoints are the files a one-device run writes
    (names, keys, dtypes, shapes; arrays within the TP bar), and their
    metadata the global batch's loss."""
    tp, one = (os.path.join(runs["root"], d) for d in ("tp", "one"))
    assert _files(tp) == _files(one) != {}
    newest = runs["ranks"][0]["newest"]
    got, want = ranks._saved(tp, newest), ranks._saved(one, newest)
    assert {k: (v.dtype, v.shape) for k, v in got.items()} == \
        {k: (v.dtype, v.shape) for k, v in want.items()}
    for k, v in want.items():
        assert _rel(got[k], v) <= LEAF_RTOL, k
    manifests = []
    for d in (tp, one):
        with open(os.path.join(d, f"step_{newest}", "manifest_0.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert manifests[0]["dtypes"] == manifests[1]["dtypes"]
    assert manifests[0]["n_shards"] == manifests[1]["n_shards"] == 1
    assert runs["ranks"][0]["tp_losses"] == pytest.approx(
        runs["one_losses"], rel=1e-5)


def test_jax_package_restores_mesh_checkpoint(runs):
    """The JAX package's ``CheckpointManager`` restores the (1, 2) run's
    newest checkpoint into its own train state's tree, bit for bit."""
    tp = os.path.join(runs["root"], "tp")
    newest = runs["ranks"][0]["newest"]
    overrides = dict(ranks.CASES[NAME][1], **ranks.F32)
    jm = jbuild(dataclasses.replace(jsmoke(jget("llama3-8b")), **overrides))
    template = jax.eval_shape(lambda: jsteps.init_train_state(
        jm, jax.random.PRNGKey(0), hyper=jsteps.TrainHyper(**ranks.HYPER)))
    restored, _ = JManager(tp).restore(template, step=newest)
    got = interop.tree_paths(jax.tree.map(np.asarray, restored))
    saved = ranks._saved(tp, newest)
    assert set(got) == set(saved)
    for k, v in saved.items():
        assert np.array_equal(got[k], v), k


def test_restart_on_same_mesh_bit_for_bit(runs):
    """(2, 1) with a failure at step 3: one restart, and the final state
    of every rank equal to the failure-free run's, bit for bit."""
    for r in runs["ranks"]:
        restart = r["restart"]
        assert restart["restarts"] == 1
        assert len(restart["equal"]) == restart["n"] == 38


def test_replanned_resume(runs):
    """(1, 2) losing rank 1 at step 3: the re-plan gives (1, 1) over rank
    0, which restores the newest checkpoint's slices (whole leaves now)
    and finishes within the FSDP / TP bar of the one-device run; rank 1
    takes no further part."""
    lead, lost = (r["elastic"] for r in runs["ranks"])
    assert lead["restarts"] == lost["restarts"] == 1
    assert lead["mesh"] == lost["mesh"] == (1, 1)
    assert not lead["departed"] and lost["departed"]
    assert "final" not in lost
    for path, want in runs["one"].items():
        assert _rel(lead["final"][path], want) <= LEAF_RTOL, path
    # steps 0-2, then 2 again (after the step-1 checkpoint) to the end
    assert len(lead["losses"]) == 7 and len(lost["losses"]) == 3
