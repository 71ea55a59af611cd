"""The port's meshed trainer (gloo ranks on the CPU) against its one-device
trainer, f32 smoke configs.

One spawn of two ranks runs the cases of both mesh shapes
(``torch_mesh_train_ranks.train_cases``): each case's step-0 loss and
every gradient leaf (the gradients the train step applied, assembled
whole from the ranks' pieces), and its losses and whole state over 3
steps of the train step. The train CLI's ``--mesh 1x2`` run goes on in a
process of its own beside that spawn.

* ``(1, 2)``: tensor parallelism (heads, ``ff``, the vocabulary; the
  smoke configs' lone KV head replicated beside split q heads) for the
  dense, encoder and VLM families, expert parallelism for the MoE, the QKV
  bias split with its heads (qwen1.5-32b);
* ``(2, 1)``: FSDP over ``data`` for every family, and plain data
  parallelism (``fsdp=False``) for the dense family, which must equal the
  one-device step at ``microbatches=2`` bit for bit (the same rows, the
  same products; the mesh's gradients are the microbatches' halved, by a
  power of two, and summed in f32 as the microbatch path sums them).

Bars: the FSDP / TP / EP loss within 1e-5 relative of the one-device
step's on the global batch, every gradient leaf and every leaf of the
state after 3 steps within 1e-4 relative (Frobenius): f32 sums of the same
products in other orders (measured at ~1e-6 and ~5e-5). The MoE routes
teacher-forced by the one-device run's choices, each differing own choice
at a near-tie (the train phase's route-drift rule). Every rank group has
a 60 s collective timeout and each spawn a join timeout, so a diverging
rank fails its test instead of hanging the run. Also here: the QKV bias against the JAX
package on one device, the refusals, and the CLI's ``--mesh``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
import torch_mesh_train_ranks as ranks
from repro.configs.registry import get_config as jget
from repro.configs.registry import smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro_torch import interop
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.api import build_model
from repro_torch.parallel.sharding import DEFAULT_RULES, train_rules_for

LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
#: the one-device loss of the global batch against the data-parallel
#: mesh's (the sum of each rank's share in another order)
DP_LOSS_RTOL = 1e-6
#: the train CLI's losses (bf16 compute) on ``--mesh 1x2`` against one
#: device: each product's f32 sum is rounded to bf16 after another order
#: of summation (a TP partial, then the sum over ranks), ~2**-8 apart a
#: product, which moves a loss near 6 by ~1e-3 over a few steps
CLI_LOSS_RTOL = 5e-3
#: the train CLI's run, with and without ``--mesh 1x2``
CLI_ARGV = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--steps",
            "4", "--batch", "4", "--seq", "16", "--lr", "5e-3"]

TP_CASES = ["llama3", "llama3-even", "qwen-bias", "moonshot", "hubert",
            "llava"]
FSDP_CASES = ["llama3-even", "moonshot", "hubert", "llava", "mamba2",
              "zamba2"]


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
def one_device():
    """The one-device trainer on every case (the MoE's routing log is the
    teacher the mesh runs are forced by)."""
    return {name: ranks.one_device(name)
            for name in sorted(set(TP_CASES) | set(FSDP_CASES))}


def _jobs(names, want, **kw):
    return {n: (n, dict(kw, forced=want[n]["routing"] or None))
            for n in names}


@pytest.fixture(scope="module")
def cli_mesh():
    """The train CLI on ``--mesh 1x2`` (``CLI_ARGV``), started in a process
    of its own as soon as a test needs it, so that its two ranks run
    beside the cases' spawn: the process (killed at the end if it still
    runs)."""
    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                 if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGV,
         "--mesh", "1x2"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def meshes(cli_mesh, one_device):
    """One spawn of two ranks for both meshes: ``(1, 2)`` with the TP / EP
    cases, ``(2, 1)`` with the FSDP cases and plain data parallelism, and
    the refusals on each → ``[{shape: (results, errors)}]`` by rank."""
    dp = _jobs(FSDP_CASES, one_device)
    dp["dp"] = ("llama3", {"fsdp": False})
    dp["dp-int8"] = ("llama3", {"fsdp": False, "compress": True})
    plan = {(1, 2): (_jobs(TP_CASES, one_device),
                     {"ssm": ("mamba2", 4), "hybrid": ("zamba2", 4)}),
            (2, 1): (dp, {"indivisible": ("llama3", 3),
                          "ssm": ("mamba2", 4)})}
    return run_ranks(2, ranks.train_cases, plan, join_timeout_s=ranks.JOIN_S)


@pytest.fixture(scope="module")
def tp(meshes):
    return [r[(1, 2)] for r in meshes]


@pytest.fixture(scope="module")
def dp(meshes):
    return [r[(2, 1)] for r in meshes]


def _rel(got, want) -> float:
    d = np.linalg.norm((np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).ravel())
    n = np.linalg.norm(np.asarray(want, np.float64).ravel())
    return 0.0 if d == 0 else float(d / max(n, 1e-30))


def _check(got: dict, want: dict, label) -> None:
    """The FSDP / TP / EP bars (module docstring)."""
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (label, got["losses"],
                                                  want["losses"])
    assert set(got["grads"]) == set(want["grads"])
    for path, g in want["grads"].items():
        assert got["grads"][path].shape == g.shape, (label, path)
        assert _rel(got["grads"][path], g) <= LEAF_RTOL, (label, path)
    assert set(got["state"]) == set(want["state"])
    for path, t in want["state"].items():
        assert _rel(got["state"][path], t) <= LEAF_RTOL, (label, path)


def _routes(got: dict, want: dict) -> None:
    if want["routing"]:
        assert len(got["routing"]) == len(want["routing"])
        assert ranks.route_off_ties(want["routing"], got["routing"],
                                    got["rows"]) == []


@pytest.mark.parametrize("name", TP_CASES)
def test_tensor_parallel_step(tp, one_device, name):
    """(1, 2): every rank's model axis piece, held to one device."""
    _check(tp[0][0][name], one_device[name], ("tp", name))
    for r in (0, 1):
        _routes(tp[r][0][name], one_device[name])
    split = tp[1][0][name]["split"]
    assert split["heads"] and split["ff"] is (name != "moonshot")
    assert split["vocab"] == (None if name == "llama3" else (128, 256))
    if name == "moonshot":
        assert split["experts"] == (4, 8)
        shapes = tp[1][0][name]["local_shapes"]
        assert shapes["layers.moe.w_gate"] == (2, 4, 64, 128)
        assert shapes["layers.moe.router"] == (2, 64, 8)   # replicated
    shapes = tp[1][0][name]["local_shapes"]
    if name == "llama3":                 # one KV head: it replicates
        assert not split["kv_heads"]
        assert shapes["layers.attn.wk"] == (2, 64, 16)
        assert shapes["layers.attn.wq"] == (2, 64, 32)
    if name == "qwen-bias":              # MHA: the biases split with heads
        assert split["kv_heads"]
        assert shapes["layers.attn.bq"] == shapes["layers.attn.bk"] \
            == (2, 32)
    # the collectives of one step: row sums forward, column sums backward
    coll = tp[0][0][name]["collectives"]
    assert coll["row_sum"] > 0 and coll["column_grad"] > 0
    assert coll["fsdp_gather"] == 0 and coll["grad_sum"] == 0


@pytest.mark.parametrize("name", FSDP_CASES)
def test_fsdp_step(dp, one_device, name):
    """(2, 1): FSDP over data, each rank its rows of the batch."""
    _check(dp[0][0][name], one_device[name], ("fsdp", name))
    for r in (0, 1):
        _routes(dp[r][0][name], one_device[name])
        assert dp[r][0][name]["rows"] == (r, 2)
    coll = dp[0][0][name]["collectives"]
    assert coll["fsdp_gather"] > 0 and coll["fsdp_scatter"] > 0
    assert coll["column_grad"] == 0
    split = dp[0][0][name]["split"]
    assert split["data_size"] == 2 and split["fsdp"]
    assert all(v is False or v is None for k, v in split.items()
               if k in ("heads", "kv_heads", "ff", "experts", "vocab"))


@pytest.mark.parametrize("compress", [False, True])
def test_data_parallel_equals_microbatches(dp, compress):
    """``fsdp=False`` on (2, 1): the one-device step at ``microbatches=2``
    bit for bit, gradients and the state after 3 steps (``compress``:
    int8 gradient compression with error feedback, the global gradients
    compressed after their sum over data, as the reference orders it);
    the loss is the global batch's (the microbatch path reports its last
    microbatch's)."""
    micro = ranks.one_device("llama3", microbatches=2, compress=compress)
    whole = ranks.one_device("llama3", compress=compress)
    got = dp[0][0]["dp-int8" if compress else "dp"]
    if compress:
        assert any(p.startswith("err.") for p in got["state"])
    for path, g in micro["grads"].items():
        assert np.array_equal(got["grads"][path], g), path
    for path, t in micro["state"].items():
        assert np.array_equal(got["state"][path], t), path
    assert abs(got["loss"] - whole["loss"]) <= DP_LOSS_RTOL * whole["loss"]
    for a, b in zip(got["losses"], whole["losses"]):
        assert abs(a - b) <= DP_LOSS_RTOL * b
    assert got["collectives"]["grad_sum"] == 1
    assert got["collectives"]["fsdp_gather"] == 0


@pytest.mark.parametrize("mesh", ["tp", "dp"])
def test_compression_scale_over_shards(tp, dp, mesh):
    """int8 compression of a leaf split over the mesh's two ranks: each
    rank's dequantized rows and error feedback equal one device's on the
    whole leaf bit for bit (its scale is the whole leaf's ``amax``, which
    only rank 1's rows hold); a replicated leaf's equal too."""
    from repro_torch.optim import compressed_gradients

    full = ranks.compress_inputs()
    deq, err = compressed_gradients(
        {k: torch.from_numpy(v) for k, v in full.items()},
        {k: torch.zeros(v.shape) for k, v in full.items()})
    for got in (r[0]["compress"] for r in {"tp": tp, "dp": dp}[mesh]):
        rows = slice(2 * got["rows"], 2 * got["rows"] + 2)
        assert np.array_equal(got["deq"]["a"], deq["a"][rows].numpy())
        assert np.array_equal(got["err"]["a"], err["a"][rows].numpy())
        assert np.array_equal(got["deq"]["b"], deq["b"].numpy())
        assert np.array_equal(got["err"]["b"], err["b"].numpy())


@pytest.mark.parametrize("mesh", ["tp", "dp"])
def test_reduce_scatter_is_the_sums_slice(tp, dp, mesh):
    """FSDP's reduce-scatter at two ranks (each rank sends the other its
    piece and adds it to its own) equals the f32 sum all-reduce's slice,
    cast back, bit for bit: f32 and bf16, split along dims 0 and 1, on
    either mesh axis."""
    for r in {"tp": tp, "dp": dp}[mesh]:
        got = r[0]["reduce_scatter"]
        assert len(got) == 4 and all(got.values()), got


@pytest.mark.parametrize("what", ["indivisible", "ssm-dp", "ssm-tp",
                                  "hybrid-tp"])
def test_refusals(tp, dp, what):
    """By name: a global batch whose rows do not split over ``data``, and
    a split model axis for the recurrent families (which train on
    ``(data, 1)``)."""
    got = {"indivisible": dp[0][1]["indivisible"], "ssm-dp": dp[0][1]["ssm"],
           "ssm-tp": tp[0][1]["ssm"], "hybrid-tp": tp[0][1]["hybrid"]}[what]
    if what == "ssm-dp":
        assert got is None
    elif what == "indivisible":
        assert "3 rows does not split over a data axis of 2" in got
    else:
        assert "trains the recurrent families data-parallel only" in got
        assert "ROADMAP Queue 1 item 21" in got


def test_refusal_without_ranks():
    """The rules refuse a split model axis for the SSD layer before any
    rank starts (a stand-in mesh of the reference's shape), and an axis
    other than pod, data and model; a pod axis is an outer data axis
    (``batch`` and ``fsdp`` over ``(pod, data)``), taken since the pod
    axis trains."""
    class Stand:
        def __init__(self, names, shape):
            self.axis_names = names
            self.devices = np.zeros(shape)

    cfg = ranks.case_config("zamba2")
    with pytest.raises(ValueError, match="SSD layer"):
        train_rules_for(cfg, Stand(("data", "model"), (1, 2)))
    assert train_rules_for(cfg, Stand(("data", "model"), (2, 1))) \
        is DEFAULT_RULES
    assert train_rules_for(ranks.case_config("llama3"),
                           Stand(("pod", "data", "model"), (2, 1, 1))) \
        is DEFAULT_RULES
    with pytest.raises(ValueError, match="pod"):
        train_rules_for(ranks.case_config("llama3"),
                        Stand(("pod", "expert", "model"), (2, 1, 1)))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recompute_sees_mesh_context(remat):
    """A layer under ``cfg.remat``, recomputed in the backward on another
    thread (autograd runs a CUDA backward on its device thread, which
    does not see the forward thread's mesh context), runs inside the
    context its forward ran in: else its gathers and sums would be
    skipped."""
    import threading

    from repro_torch.models.transformer import remat as remat_fn
    from repro_torch.parallel.collectives import RankShard
    from repro_torch.parallel.sharding import activate, active_shard

    cfg = dataclasses.replace(ranks.case_config("llama3"), remat=remat)
    shard, seen = RankShard(), []

    def layer(x):
        seen.append(active_shard())
        return torch.sin(x) * 2

    x = torch.ones(3, requires_grad=True)
    with activate(None, None, shard):
        y = remat_fn(cfg, layer, x).sum()
    out = {}
    th = threading.Thread(target=lambda: out.update(
        g=torch.autograd.grad(y, x)[0]))
    th.start()
    th.join(30)
    assert not th.is_alive()
    assert torch.equal(out["g"], 2 * torch.cos(x.detach()))
    assert seen == [shard, shard]


def _losses(text: str) -> list:
    """The ``[train] step=`` lines' step and loss."""
    return [(int(line.split()[1][5:]), float(line.split()[2][5:]))
            for line in text.splitlines() if line.startswith("[train] step=")]


def test_cli_mesh_loss_lines(cli_mesh, capfd):
    """``--mesh 1x2`` prints the run's ``[train]`` loss lines (the lead
    rank's, of the global batch) beside the one-device run's: the same
    steps (the first and the last), each loss within ``CLI_LOSS_RTOL``
    (the smoke config computes in bf16, where the TP sums round in other
    orders); a ``[train] mesh:`` line names the split."""
    train_cli.main(CLI_ARGV)
    one = capfd.readouterr().out
    mesh, err = cli_mesh.communicate(timeout=ranks.JOIN_S)
    assert cli_mesh.returncode == 0, err[-4000:]
    want, got = _losses(one), _losses(mesh)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 3]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= CLI_LOSS_RTOL * b, (got, want)
    assert "[train] mesh: (data=1, model=2) over 2 ranks (gloo; FSDP over " \
           "data, split over model: heads, ff)" in mesh
    assert mesh.count("[train] step=0 ") == 1      # the lead rank alone


def test_qkv_bias_against_reference():
    """qwen1.5-32b's smoke config (f32, vocab 256) with nonzero ``bq`` /
    ``bk`` / ``bv`` drawn from a seed: the port's one-device loss and
    every gradient leaf against the JAX package's ``Model.loss`` at the
    same parameters and batch (the TP2 step against one device is
    ``test_tensor_parallel_step[qwen-bias]``). The loss within 1e-5, each
    leaf within 1e-5 of its largest entry (test_torch_train's bars)."""
    tcfg = ranks.case_config("qwen-bias")
    assert tcfg.qkv_bias
    jcfg = dataclasses.replace(jsmoke(jget("qwen1.5-32b")), **ranks.F32,
                               **ranks.EVEN)
    params = ranks.initial_params("qwen-bias")
    assert float(params["layers"]["attn"]["bk"].abs().max()) > 0.1
    batch = ranks.data("qwen-bias").batch_for_step(0)
    model = build_model(tcfg)
    state = steps.init_train_state(model, hyper=ranks.hyper(),
                                   device="cpu", params=params)
    tg, tm = steps.loss_and_grads(model, state["params"], batch)

    jm = jbuild(jcfg)
    jp = jax.tree.map(jnp.asarray, interop.to_numpy(params))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jp)
    assert abs(float(tm["loss"]) - float(jl)) <= 1e-5
    jg = dict(interop.tree_leaves(jax.tree.map(np.asarray, jg)))
    for path, g in interop.tree_leaves(tg):
        ref = jg[path]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=path)
