"""Q heads split over a model axis that does not divide the KV heads, and
the pod axis in training: one spawn of four gloo ranks on the CPU
(``torch_production_mesh_ranks.py``), held to the one-device port.

The production meshes' model axis of 16 splits llama3-8b's 32 q heads two
a rank but not its 8 KV heads: each rank computes every KV head and its q
heads attend the one of their group (``RankShard.kv_slice``; the paged
kernel reads that head of the cache in place). Here a smoke llama3-8b
with 8 q heads and 2 KV heads on ``(1, 4)`` stands for it:

* greedy serving in f32, both cache layouts: tokens identical to one
  device; the meshed prefill and decode steps' teacher-forced logits
  within 1e-4 of their largest magnitude;
* a train step: the loss within 1e-5 relative and every gradient leaf
  within 1e-4 (Frobenius), f32 sums in other orders;
* on ``(2, 2, 1)`` plain data parallelism over ``(pod, data)`` as one
  flattened group: three steps bit for bit equal to one device at
  ``microbatches=4`` (the same rows, the gradients summed in rank order),
  gradients and state; FSDP over the same group: the loss within 1e-5
  and every gradient leaf within 1e-4 of one device;
* with 6 q heads, which the model axis of 4 does not divide, the
  attention replicates over ``model`` (the MLP and the vocabulary still
  split) on ``(1, 4)``: greedy tokens identical to one device, and a
  train step within the same bars.

The spawn's collectives time out after 60 s and the spawn after
``JOIN_S``, so a diverging rank fails the test instead of hanging it.
"""

import numpy as np
import pytest

import torch_production_mesh_ranks as ranks
from repro_torch.launch.mesh import run_ranks

LOGIT_RTOL, LOSS_RTOL, LEAF_RTOL = 1e-4, 1e-5, 1e-4


@pytest.fixture(scope="module")
def got():
    return run_ranks(4, ranks.ranks, join_timeout_s=ranks.JOIN_S)


@pytest.fixture(scope="module")
def want():
    return ranks.one_device()


def _rel(a, b) -> float:
    d = np.linalg.norm((np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).ravel())
    n = np.linalg.norm(np.asarray(b, np.float64).ravel())
    return 0.0 if d == 0 else float(d / max(n, 1e-30))


def test_each_rank_attends_its_groups_kv_head(got):
    assert [r["train"]["shard"] for r in got] == [
        (True, False, (0, 1)), (True, False, (0, 1)),
        (True, False, (1, 2)), (True, False, (1, 2))]
    assert [r["pod"]["data"] for r in got] == [(4, 0), (4, 1), (4, 2),
                                               (4, 3)]


def test_serving_equals_one_device(got, want):
    for r in got:
        assert r["serve"] == want["serve"]
        assert r["steps"]["pos"] == want["steps"]["pos"] == 14
    for a, b in zip(got[0]["steps"]["logits"], want["steps"]["logits"]):
        assert np.abs(a - b).max() <= LOGIT_RTOL * np.abs(b).max()


@pytest.mark.parametrize("run", ["train", "pod_fsdp", "uneven_train"])
def test_train_step_equals_one_device(got, want, run):
    mine = got[0][run]
    one = want["uneven_train" if run == "uneven_train" else "train"]
    assert abs(mine["loss"] - one["loss"]) <= LOSS_RTOL * one["loss"]
    assert all(abs(r[run]["loss"] - mine["loss"]) == 0 for r in got)
    assert sorted(mine["grads"]) == sorted(one["grads"])
    for path, g in one["grads"].items():
        assert _rel(mine["grads"][path], g) <= LEAF_RTOL, path


def test_pod_data_parallel_is_microbatching_bit_for_bit(got, want):
    mine, micro = got[0]["pod"], want["micro"]
    for path, g in micro["grads"].items():
        assert np.array_equal(mine["grads"][path], g), path
    for path, t in micro["state"].items():
        assert np.array_equal(mine["state"][path], t), path


def test_uneven_q_heads_replicate_the_attention(got, want):
    for r in got:
        assert r["uneven_train"]["attention_replicated"]
        assert r["uneven_train"]["shard"] == (False, False, None)
        assert not r["train"]["attention_replicated"]
        assert r["uneven_serve"] == want["uneven_serve"]
